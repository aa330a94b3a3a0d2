"""The Depth Anything V2 cell's weights, made on the device from
``--seed``: every leaf of the port's parameter layout (a dict tree:
convolutions OIHW, transposed convolutions (in, out, kH, kW), linear
layers (out, in)) at the configuration's ``network`` widths.

Laws: each convolution's and linear layer's weight and bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), where a transposed convolution of
stride equal to its kernel has its input channels as fan-in (each output
pixel sums one input pixel's channels); each LayerNorm's scale 1 +
U(-0.1, 0.1) and bias U(-0.1, 0.1); each LayerScale gamma 0.5 + U(-0.4,
0.4); the class token and the position embedding 0.02 N(0, 1). No leaf is
zero or one throughout, so that every path the comparison with the plain
reference follows works on drawn values: the position embedding's
resize, the class token through attention, the biases, the gammas. The
uniform leaves come from one draw and the two normal ones from a second,
on one generator. The layout is the interface of the system under test;
the values are the benchmark's.

By its law alone the head's last bias (up to 0.18 at a fan-in of 32)
outweighs the spread of that convolution's output across pixels (a few
hundredths), so that on about half the seeds the head's ReLU would clamp
every pixel and the depth would be the tail's constant. The cell's driver
therefore moves that bias by :func:`centre_head` after the draw, so that
the ReLU passes about half of each seed's pixels.
"""
from __future__ import annotations

import math

import torch

from benchmark.scene import STREAM_WEIGHTS, seeded

TOKEN_STD = 0.02
NORM_SPREAD = 0.1
GAMMA_CENTRE, GAMMA_SPREAD = 0.5, 0.4


def _conv(cin, cout, k, bias=True, fan=None):
    fan = fan or k * k * cin
    p = {"w": ("fan", (cout, cin, k, k), fan)}
    if bias:
        p["b"] = ("fan", (cout,), fan)
    return p


def _transposed(c, k):
    return {"w": ("fan", (c, c, k, k), c), "b": ("fan", (c,), c)}


def _linear(cin, cout):
    return {"w": ("fan", (cout, cin), cin), "b": ("fan", (cout,), cin)}


def _norm(c):
    return {"scale": ("scale", (c,), None), "bias": ("bias", (c,), None)}


def _fusion(f):
    def rcu():
        return {"conv1": _conv(f, f, 3), "conv2": _conv(f, f, 3)}

    return {"rcu1": rcu(), "rcu2": rcu(), "out_conv": _conv(f, f, 1)}


def layout(net):
    """The parameter tree of the ``network`` block ``net``, each leaf a
    (law, shape, fan_in) triple."""
    d, f, oc = net["dim"], net["features"], net["out_channels"]
    p = net["patch"]
    tokens = 1 + net["pos_embed_grid"] ** 2
    return {
        "patch_embed": _conv(3, d, p),
        "cls_token": ("token", (1, 1, d), None),
        "pos_embed": ("token", (1, tokens, d), None),
        "blocks": [{"ln1": _norm(d), "qkv": _linear(d, 3 * d),
                    "proj": _linear(d, d), "ls1": ("gamma", (d,), None),
                    "ln2": _norm(d), "mlp1": _linear(d, net["mlp_dim"]),
                    "mlp2": _linear(net["mlp_dim"], d),
                    "ls2": ("gamma", (d,), None)}
                   for _ in range(net["blocks"])],
        "norm": _norm(d),
        "projects": [_conv(d, c, 1) for c in oc],
        "resize0": _transposed(oc[0], 4),
        "resize1": _transposed(oc[1], 2),
        "resize3": _conv(oc[3], oc[3], 3),
        "scratch": {f"layer{i + 1}_rn": _conv(c, f, 3, bias=False)
                    for i, c in enumerate(oc)},
        **{f"refinenet{r}": _fusion(f) for r in (1, 2, 3, 4)},
        "head": {"conv1": _conv(f, f // 2, 3), "conv2": _conv(f // 2, 32, 3),
                 "conv3": _conv(32, 1, 1)},
    }


def _leaves(tree, out):
    """[(container, key, leaf)] in a fixed order: dict keys as written,
    list items in turn."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        if isinstance(val, tuple):
            out.append((tree, key, val))
        else:
            _leaves(val, out)
    return out


def parameters(net):
    """The number of parameters of the ``network`` block ``net``."""
    return sum(math.prod(x[2][1]) for x in _leaves(layout(net), []))


def da2_weights(net, seed, device):
    """The seeded parameter tree of the ``network`` block ``net`` on
    ``device``."""
    tree = layout(net)
    leaves = _leaves(tree, [])
    uniform = [x for x in leaves if x[2][0] != "token"]
    normal = [x for x in leaves if x[2][0] == "token"]
    g = seeded(seed, STREAM_WEIGHTS, device)
    flat = torch.rand(sum(math.prod(x[2][1]) for x in uniform), generator=g,
                      device=device) * 2.0 - 1.0
    at = 0
    for parent, key, (law, shape, fan) in uniform:
        n = math.prod(shape)
        u = flat[at:at + n].reshape(shape)
        at += n
        if law == "fan":
            parent[key] = u * (1.0 / math.sqrt(fan))
        elif law == "scale":
            parent[key] = 1.0 + NORM_SPREAD * u
        elif law == "gamma":
            parent[key] = GAMMA_CENTRE + GAMMA_SPREAD * u
        else:
            parent[key] = NORM_SPREAD * u
    del flat
    for parent, key, (_, shape, _) in normal:
        parent[key] = TOKEN_STD * torch.randn(shape, generator=g,
                                              device=device)
    return tree


def centre_head(params, pre):
    """Moves the head's last bias by the median of ``pre``, the head's
    output before its ReLU on some frames with these ``params``: the ReLU
    then passes half of those frames' pixels."""
    conv3 = params["head"]["conv3"]
    conv3["b"] = conv3["b"] - pre.median()
