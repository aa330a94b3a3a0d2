"""Plain PyTorch reference of the Depth Anything V2-Large depth-prior pass,
in float32 with TF32 off, written from the published description and
against nothing of the program: Yang et al., "Depth Anything V2" (NeurIPS
2024, arXiv:2406.09414), github.com/DepthAnything/Depth-Anything-V2,
``DepthAnythingV2(encoder='vitl', features=256, out_channels=[256, 512,
1024, 1024])`` and its ``infer_image`` transform, before the final resize
back to the frame.

What it covers, in order:

* the input transform: keep-aspect 'lower_bound' resize toward 518x518
  (the larger of the two scales), each side rounded half to even to a
  multiple of 14 and rounded up where that falls under 518, bicubic (A =
  -0.75, borders clamped, align_corners False) in float64, then ImageNet's
  mean (0.485, 0.456, 0.406) and std (0.229, 0.224, 0.225);
* DINOv2 ViT-L/14: a 14x14 stride-14 patch convolution, the class token,
  the position embedding with its 37x37 grid resized bicubically by the
  scale factors ((gh + 0.1) / 37, (gw + 0.1) / 37) (antialias off), no
  register tokens; 24 pre-LN blocks (width 1024, 16 heads of 64, MLP 4096,
  exact GELU, LayerNorm eps 1e-6), q scaled by 64^-0.5 before ``q k^T``,
  LayerScale on both branches;
* the outputs of blocks 4, 11, 17 and 23 through the final LayerNorm,
  the class token dropped;
* the DPT head: 1x1 projections to 256, 512, 1024, 1024, a 4x4 stride-4
  and a 2x2 stride-2 transposed convolution, nothing, a 3x3 stride-2
  convolution; 3x3 convolutions to 256; four fusion blocks (residual
  convolution units, a bilinear resize with aligned corners to the next
  layer's grid, or by 2 for the last, a 1x1 output convolution); the
  output convolutions with a resize to (14 gh, 14 gw) between them; the
  ReLU and NoPe-NeRF's depth tail 1 / max(scale * x + shift, 1e-8).

Departure from a literal reading of the published forward: the depth is
not resized back to the frame (NoPe-NeRF keeps its priors at the
network's size).

Parameters are read in the port's layout (a dict tree: convolutions OIHW,
transposed convolutions (in, out, kH, kW), linear layers (out, in)); the
values are the benchmark's. ``fault`` plants one of two faults for the
limits' control (``control_da2.py``): ``"pos_by_size"`` resizes the
position embedding to the grid's size instead of by the scale factors,
``"late_tap"`` takes the first tap one block late (block 5).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 14
HEAD_DIM = 64
# the blocks tapped, by encoder depth: ``intermediate_layer_idx`` of ViT-S
# and B (12 blocks), L (24) and g (40)
TAPS = {12: (2, 5, 8, 11), 24: (4, 11, 17, 23), 40: (9, 19, 29, 39)}
INPUT_SIZE = 518
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FAULTS = ("pos_by_size", "late_tap")


@contextlib.contextmanager
def precision(tf32=False):
    """Matrix products and convolutions in full float32 inside the block,
    or with ``tf32`` in TF32 (the control); both flags restored."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = prev


def network_size(h, w, target=INPUT_SIZE, multiple=PATCH):
    """The network input's size for h x w frames."""
    s = max(target / h, target / w)
    size = []
    for n in (h, w):
        y = int(np.round(s * n / multiple) * multiple)
        if y < target:
            y = int(np.ceil(s * n / multiple) * multiple)
        size.append(y)
    return size


def transform(frames, target=INPUT_SIZE):
    """(B, H, W, 3) in [0, 1] -> (B, 3, h', w') float32, the network's
    input."""
    size = network_size(frames.shape[1], frames.shape[2], target)
    x = frames.double().movedim(3, 1)
    x = F.interpolate(x, size=size, mode="bicubic", align_corners=False)
    mean = x.new_tensor(MEAN).reshape(1, 3, 1, 1)
    std = x.new_tensor(STD).reshape(1, 3, 1, 1)
    return ((x - mean) / std).float()


def conv(x, p, stride=1, pad=None):
    """A plain convolution with its bias where it has one; ``pad``
    defaults to half the window."""
    k = p["w"].shape[-1]
    return F.conv2d(x, p["w"], p.get("b"), stride=stride,
                    padding=k // 2 if pad is None else pad)


def layer_norm(x, p, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def linear(x, p):
    return x @ p["w"].t() + p["b"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def block(x, p, heads):
    b, t, d = x.shape
    hd = d // heads
    qkv = linear(layer_norm(x, p["ln1"]), p["qkv"]).reshape(b, t, 3, heads,
                                                             hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    att = torch.softmax(torch.einsum("bhqc,bhkc->bhqk", q * hd ** -0.5, k),
                        dim=-1)
    y = torch.einsum("bhqk,bhkc->bhqc", att, v).transpose(1, 2)
    x = x + p["ls1"] * linear(y.reshape(b, t, d), p["proj"])
    mlp = linear(gelu(linear(layer_norm(x, p["ln2"]), p["mlp1"])), p["mlp2"])
    return x + p["ls2"] * mlp


def pos_embedding(pos, grid, square, fault=None):
    """The class token's embedding and the square grid's, resized
    bicubically to ``grid`` by DINOv2's offset scale factors (unchanged for
    a square input of the grid's own size)."""
    side = math.isqrt(pos.shape[1] - 1)
    if grid == (side, side) and square:
        return pos
    g = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
    if fault == "pos_by_size":
        g = F.interpolate(g, size=grid, mode="bicubic", align_corners=False)
    else:
        g = F.interpolate(g, scale_factor=tuple((n + 0.1) / side
                                                for n in grid),
                          mode="bicubic", align_corners=False)
    return torch.cat([pos[:, :1], g.flatten(2).transpose(1, 2)], dim=1)


def fusion(p, x, skip=None, size=None):
    if skip is not None:
        x = x + rcu(skip, p["rcu1"])
    x = rcu(x, p["rcu2"])
    size = size or (2 * x.shape[2], 2 * x.shape[3])
    x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
    return conv(x, p["out_conv"])


def rcu(x, p):
    y = conv(torch.relu(x), p["conv1"])
    return x + conv(torch.relu(y), p["conv2"])


def head_output(params, x, fault=None):
    """(B, 3, h', w') network input -> (B, h', w'): the head's output
    before its ReLU. Heads of 64 channels; the taps of the encoder's
    depth."""
    b, _, h, w = x.shape
    grid = (h // PATCH, w // PATCH)
    pe = params["patch_embed"]
    tok = F.conv2d(x, pe["w"], pe["b"], stride=PATCH).flatten(2)
    tok = tok.transpose(1, 2)
    d = tok.shape[-1]
    tok = torch.cat([params["cls_token"].expand(b, 1, d), tok], dim=1)
    tok = tok + pos_embedding(params["pos_embed"], grid, h == w, fault)
    heads = d // HEAD_DIM
    taken = list(TAPS[len(params["blocks"])])
    if fault == "late_tap":
        taken[0] += 1
    outs = {}
    for i, blk in enumerate(params["blocks"]):
        tok = block(tok, blk, heads)
        if i in taken:
            t = layer_norm(tok, params["norm"])[:, 1:]
            outs[i] = t.transpose(1, 2).reshape(b, d, *grid)
    feats = [outs[i] for i in taken]
    layers = []
    for i, f in enumerate(feats):
        y = conv(f, params["projects"][i], pad=0)
        if i < 2:
            r = params[f"resize{i}"]
            k = r["w"].shape[-1]
            y = F.conv_transpose2d(y, r["w"], r["b"], stride=k)
        elif i == 3:
            y = conv(y, params["resize3"], stride=2, pad=1)
        layers.append(y)
    sc = params["scratch"]
    rn = [conv(y, sc[f"layer{i + 1}_rn"]) for i, y in enumerate(layers)]
    path = fusion(params["refinenet4"], rn[3], size=rn[2].shape[2:])
    path = fusion(params["refinenet3"], path, rn[2], size=rn[1].shape[2:])
    path = fusion(params["refinenet2"], path, rn[1], size=rn[0].shape[2:])
    path = fusion(params["refinenet1"], path, rn[0])
    hp = params["head"]
    y = F.interpolate(conv(path, hp["conv1"]), size=(h, w), mode="bilinear",
                      align_corners=True)
    y = torch.relu(conv(y, hp["conv2"]))
    return conv(y, hp["conv3"], pad=0)[:, 0]


def depth_from(pre, depth_cfg):
    """The head's ReLU (``non_negative``) and the depth tail (``invert``)
    on its output."""
    inv = torch.relu(pre) if depth_cfg["non_negative"] else pre
    if not depth_cfg["invert"]:
        return inv
    return 1.0 / torch.clamp(depth_cfg["scale"] * inv + depth_cfg["shift"],
                             min=1e-8)


def forward(params, frames, depth_cfg, tf32=False, fault=None):
    """(B, H, W, 3) frames in [0, 1] -> (depth, pre): the pass's output as
    ``depth_cfg`` asks for it and the head's output before its ReLU, each
    (B, h', w') float32, one frame at a time, at ``depth_cfg``'s
    ``input_size`` (default 518)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    size = depth_cfg.get("input_size", INPUT_SIZE)
    pres = []
    with torch.no_grad(), precision(tf32):
        for i in range(frames.shape[0]):
            pres.append(head_output(params, transform(frames[i:i + 1], size),
                                    fault))
    pre = torch.cat(pres)
    return depth_from(pre, depth_cfg), pre
