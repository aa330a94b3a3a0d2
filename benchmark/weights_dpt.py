"""The depth-prior cell's DPT-Hybrid weights, made on the device from
``--seed``: every leaf of the port's parameter layout (a dict tree:
convolutions OIHW, linear layers (out, in)) at the configuration's
``network`` widths.

Laws: each convolution's and linear layer's weight and bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); each norm's scale 1 + U(-0.1, 0.1)
and bias U(-0.1, 0.1); the class token and the position embedding
0.02 N(0, 1). No leaf is zero or one throughout, so that every path the
comparison with the plain reference follows works on drawn values: the
class token in block 0 and the readouts, the position embedding's resize
to the token grid, each norm's scale and bias. The uniform leaves come
from one draw and the two normal ones from a second, on one generator.
The layout is the interface of the system under test; the values are the
benchmark's.
"""
from __future__ import annotations

import math

import torch

from benchmark.scene import STREAM_WEIGHTS, seeded

TOKEN_STD = 0.02
NORM_SPREAD = 0.1


def _conv(cin, cout, k, bias=True):
    p = {"w": ("fan", (cout, cin, k, k), k * k * cin)}
    if bias:
        p["b"] = ("fan", (cout,), k * k * cin)
    return p


def _linear(cin, cout):
    return {"w": ("fan", (cout, cin), cin), "b": ("fan", (cout,), cin)}


def _norm(c):
    return {"scale": ("scale", (c,), None), "bias": ("bias", (c,), None)}


def _bottleneck(cin, cout, downsample):
    mid = cout // 4
    p = {"conv1": _conv(cin, mid, 1, bias=False), "norm1": _norm(mid),
         "conv2": _conv(mid, mid, 3, bias=False), "norm2": _norm(mid),
         "conv3": _conv(mid, cout, 1, bias=False), "norm3": _norm(cout)}
    if downsample:
        p["down_conv"] = _conv(cin, cout, 1, bias=False)
        p["down_norm"] = _norm(cout)
    return p


def _fusion(f):
    def rcu():
        return {"conv1": _conv(f, f, 3), "conv2": _conv(f, f, 3)}

    return {"rcu1": rcu(), "rcu2": rcu(), "out_conv": _conv(f, f, 1)}


def layout(net):
    """The parameter tree of the ``network`` block ``net``, each leaf a
    (law, shape, fan_in) triple."""
    stages, cin = [], 64
    for n_blocks, cout in zip(net["resnet_layers"], net["resnet_widths"]):
        stages.append([_bottleneck(cin if b == 0 else cout, cout, b == 0)
                       for b in range(n_blocks)])
        cin = cout
    d, f, re = net["vit_dim"], net["features"], net["reassemble"]
    tokens = 1 + net["pos_embed_grid"] ** 2
    return {
        "resnet": {"stem_conv": _conv(3, 64, 7, bias=False),
                   "stem_norm": _norm(64), "stages": stages},
        "patch_proj": _conv(cin, d, 1),
        "cls_token": ("token", (1, 1, d), None),
        "pos_embed": ("token", (1, tokens, d), None),
        "blocks": [{"ln1": _norm(d), "qkv": _linear(d, 3 * d),
                    "proj": _linear(d, d), "ln2": _norm(d),
                    "mlp1": _linear(d, net["vit_mlp_dim"]),
                    "mlp2": _linear(net["vit_mlp_dim"], d)}
                   for _ in range(net["vit_blocks"])],
        "final_ln": _norm(d),
        "readout3": _linear(2 * d, d),
        "readout4": _linear(2 * d, d),
        "post3_conv": _conv(d, re[2], 1),
        "post4_conv1": _conv(d, re[3], 1),
        "post4_conv2": _conv(re[3], re[3], 3),
        "scratch": {f"layer{i + 1}_rn": _conv(re[i], f, 3, bias=False)
                    for i in range(4)},
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


def dpt_weights(net, seed, device):
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
        else:
            parent[key] = NORM_SPREAD * u
    del flat
    for parent, key, (_, shape, _) in normal:
        parent[key] = TOKEN_STD * torch.randn(shape, generator=g,
                                              device=device)
    return tree
