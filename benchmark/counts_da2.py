"""The yardstick of the Depth Anything V2 cell: Depth Anything V2-Large's
work a frame by section, counted from the network input's shape alone.

FLOPs are those of ``torch.utils.flop_counter``: 2 per multiply-add of
every convolution, transposed convolution, linear layer and attention
product (biases, norms, softmax, GELU, LayerScale and resizes are not
counted): 2,583.1 GFLOP at 518x924 (2,443 tokens), of which the encoder
2,065.2 (its attention cores 586.7) and the decoder 517.9. The sections
are the program's:

* ``dpt.dinov2``: the patch embedding, the position embedding, each
  block's norms, ``qkv``, ``proj``, MLP and LayerScale, the normed taps;
  its own bytes are the image in, the four taps out, each block's q, k, v
  out to the attention cores and their output back in, and its weights
  once a batch;
* ``dpt.dinov2.attn``: each block's attention cores (q's scaling, ``q
  k^T``, softmax, times v); its floor is q, k and v in and the output out;
* ``dpt.decoder``: reassembly, fusion, head and tail; the four taps in, the
  depth and the head's pre-ReLU output out, its weights once a batch.

All in float32. The configuration computes with TF32 off, outside the
tensor cores, so the least times use the f32 peak, 2 x
``counts.PEAK_FP32_INSTR`` (67 TFLOP/s), and HBM's 3.35 TB/s.
"""
from __future__ import annotations

import math

from benchmark import counts

PEAK_FP32_FLOPS = 2 * counts.PEAK_FP32_INSTR
F32 = 4
PATCH = 14
DIM, BLOCKS, MLP = 1024, 24, 4096
POS_GRID = 37
OUT_CHANNELS = (256, 512, 1024, 1024)
FEATURES = 256
INPUT_SIZE = 518
SECTIONS = ("dpt.dinov2", "dpt.dinov2.attn", "dpt.decoder")


def _conv(cin, cout, k, h, w):
    """(FLOPs, weights) of a k x k convolution with output h x w."""
    return 2 * cin * cout * k * k * h * w, cin * cout * k * k


def _transposed(c, k, h, w):
    """(FLOPs, weights) of a k x k stride-k transposed convolution of an
    h x w input."""
    return 2 * c * c * k * k * h * w, c * c * k * k


def _grid(h, w):
    return h // PATCH, w // PATCH


def _encoder(h, w):
    """[(FLOPs, weights)] of ``dpt.dinov2`` and of ``dpt.dinov2.attn``."""
    gh, gw = _grid(h, w)
    t, d = gh * gw + 1, DIM
    enc = [_conv(3, d, PATCH, gh, gw)]
    attn = []
    for _ in range(BLOCKS):
        enc += [(2 * t * d * 3 * d, 3 * d * d), (2 * t * d * d, d * d),
                (2 * t * d * MLP, d * MLP), (2 * t * MLP * d, d * MLP)]
        attn.append((2 * 2 * t * t * d, 0))  # q k^T and att v, all heads
    return enc, attn


def _decoder(h, w):
    gh, gw = _grid(h, w)
    oc, f = OUT_CHANNELS, FEATURES
    dh, dw = -(-gh // 2), -(-gw // 2)
    sizes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), (dh, dw)]
    layers = [_conv(DIM, c, 1, gh, gw) for c in oc]
    layers += [_transposed(oc[0], 4, gh, gw), _transposed(oc[1], 2, gh, gw),
               _conv(oc[3], oc[3], 3, dh, dw)]
    layers += [_conv(c, f, 3, *hw) for c, hw in zip(oc, sizes)]
    # refinenet4 .. refinenet1: residual units at their layer's grid, the
    # output convolution at the next grid (twice layer 1's for the last)
    outs = sizes[2::-1] + [(8 * gh, 8 * gw)]
    for level, out in zip((3, 2, 1, 0), outs):
        units = 1 if level == 3 else 2  # refinenet4 has no skip
        layers += [_conv(f, f, 3, *sizes[level])] * (2 * units)
        layers.append(_conv(f, f, 1, *out))
    layers += [_conv(f, f // 2, 3, 8 * gh, 8 * gw),
               _conv(f // 2, 32, 3, PATCH * gh, PATCH * gw),
               _conv(32, 1, 1, PATCH * gh, PATCH * gw)]
    return layers


def _layers(h, w):
    enc, attn = _encoder(h, w)
    return {"dpt.dinov2": enc, "dpt.dinov2.attn": attn,
            "dpt.decoder": _decoder(h, w)}


def section_flops(h, w):
    """{section: FLOPs a frame} at network input h x w."""
    return {k: sum(f for f, _ in v) for k, v in _layers(h, w).items()}


def flops(h, w):
    """FLOPs of one frame's forward at network input h x w."""
    return sum(section_flops(h, w).values())


def tokens(h, w):
    """The encoder's tokens a frame, the class token included."""
    gh, gw = _grid(h, w)
    return gh * gw + 1


def section_bytes(h, w, batch=1):
    """{section: bytes a frame} in batches of ``batch``: its weights once a
    batch, its inputs and its outputs once, float32."""
    gh, gw = _grid(h, w)
    t, d = tokens(h, w), DIM
    weights = {k: sum(n for _, n in v) for k, v in _layers(h, w).items()}
    taps = 4 * d * gh * gw
    # norms, gammas, biases, the class token and the position embedding
    small = (BLOCKS * (9 * d + MLP) + 2 * d + d
             + (1 + POS_GRID * POS_GRID) * d + d)
    exchange = BLOCKS * 4 * t * d  # q, k, v and the cores' output
    io = {"dpt.dinov2": 3 * h * w + taps + exchange,
          "dpt.dinov2.attn": exchange,
          "dpt.decoder": taps + 2 * h * w}
    weights["dpt.dinov2"] += small
    return {k: F32 * (weights[k] / batch + io[k]) for k in SECTIONS}


def least_seconds(h, w, batch=1):
    """{section: the least seconds a frame} in batches of ``batch``: the
    larger of its FLOPs at the f32 peak and its bytes at HBM's rate."""
    fl, by = section_flops(h, w), section_bytes(h, w, batch)
    return {k: max(fl[k] / PEAK_FP32_FLOPS, by[k] / counts.PEAK_HBM_BYTES)
            for k in SECTIONS}


def network_hw(h, w, target=INPUT_SIZE, multiple=PATCH):
    """The network input's size for frames of h x w (the 'lower_bound'
    rule: the larger scale, sides rounded half to even to a multiple, up
    where that falls under the target)."""
    s = max(target / h, target / w)
    out = []
    for n in (h, w):
        side = int(round(s * n / multiple)) * multiple
        if side < target:
            side = math.ceil(s * n / multiple) * multiple
        out.append(side)
    return tuple(out)
