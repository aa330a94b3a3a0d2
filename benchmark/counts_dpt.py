"""The yardstick of the depth-prior cell: DPT-Hybrid's work a frame by
section, counted from the network input's shape alone.

FLOPs are those of ``torch.utils.flop_counter``: 2 per multiply-add of
every convolution, linear layer and attention product (biases, norms,
softmax, GELU and resizes are not counted): 462,575,407,104 at 384x672.
A section's bytes are its own inputs and outputs read or written once and
the weights of its convolutions and linear layers read once a batch, in
float32. The sections are the program's: ``dpt.resnet`` (stem and
stages), ``dpt.vit`` (patch embedding, blocks, readouts, reassemble
convolutions) and ``dpt.decoder`` (the four scratch convolutions, fusion,
head, depth tail).

The configuration computes in float32 with TF32 off, outside the tensor
cores, so the least times use the f32 peak, 2 x ``counts.PEAK_FP32_INSTR``
(67 TFLOP/s), and HBM's 3.35 TB/s.
"""
from __future__ import annotations

from benchmark import counts

PEAK_FP32_FLOPS = 2 * counts.PEAK_FP32_INSTR
F32 = 4
STAGES = ((3, 256), (4, 512), (9, 1024))  # bottlenecks, width
VIT_DIM, VIT_BLOCKS, VIT_MLP = 768, 12, 3072
FEATURES = 256
REASSEMBLE = (256, 512, 768, 768)
SECTIONS = ("dpt.resnet", "dpt.vit", "dpt.decoder")


def _conv(cin, cout, k, h, w):
    """(FLOPs, weights) of a k x k convolution with output h x w."""
    return 2 * cin * cout * k * k * h * w, cin * cout * k * k


def _up(n):
    return -(-n // 2)


def _resnet(h, w):
    """[(FLOPs, weights)] of the stem and stages at input h x w."""
    h, w = h // 2, w // 2
    layers = [_conv(3, 64, 7, h, w)]
    h, w = h // 2, w // 2  # the max pool
    cin = 64
    for i, (blocks, cout) in enumerate(STAGES):
        mid = cout // 4
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            ho, wo = (_up(h), _up(w)) if stride == 2 else (h, w)
            if j == 0:
                layers.append(_conv(cin, cout, 1, ho, wo))
            layers += [_conv(cin if j == 0 else cout, mid, 1, h, w),
                       _conv(mid, mid, 3, ho, wo), _conv(mid, cout, 1, ho, wo)]
            h, w = ho, wo
        cin = cout
    return layers


def _vit(gh, gw):
    p = gh * gw
    t = p + 1
    d = VIT_DIM
    layers = [_conv(1024, d, 1, gh, gw)]
    for _ in range(VIT_BLOCKS):
        layers += [(2 * t * d * 3 * d, 3 * d * d),
                   (2 * 2 * t * t * d, 0),  # q k^T and att v, all heads
                   (2 * t * d * d, d * d),
                   (2 * t * d * VIT_MLP, d * VIT_MLP),
                   (2 * t * VIT_MLP * d, d * VIT_MLP)]
    layers += [(2 * p * 2 * d * d, 2 * d * d)] * 2  # the two readouts
    layers += [_conv(d, d, 1, gh, gw), _conv(d, d, 1, gh, gw),
               _conv(d, d, 3, _up(gh), _up(gw))]
    return layers


def _decoder(h, w):
    f = FEATURES
    sizes = [(h // 4, w // 4), (h // 8, w // 8), (h // 16, w // 16),
             (_up(h // 16), _up(w // 16))]
    layers = [_conv(c, f, 3, *hw) for c, hw in zip(REASSEMBLE, sizes)]
    for level in (3, 2, 1, 0):  # refinenet4 .. refinenet1
        hh, ww = sizes[level]
        units = 1 if level == 3 else 2  # refinenet4 has no skip
        layers += [_conv(f, f, 3, hh, ww)] * (2 * units)
        layers.append(_conv(f, f, 1, 2 * hh, 2 * ww))
    layers += [_conv(f, f // 2, 3, h // 2, w // 2), _conv(f // 2, 32, 3, h, w),
               _conv(32, 1, 1, h, w)]
    return layers


def _layers(h, w):
    return {"dpt.resnet": _resnet(h, w), "dpt.vit": _vit(h // 16, w // 16),
            "dpt.decoder": _decoder(h, w)}


def section_flops(h, w):
    """{section: FLOPs a frame} at network input h x w."""
    return {k: sum(f for f, _ in v) for k, v in _layers(h, w).items()}


def flops(h, w):
    """FLOPs of one frame's forward at network input h x w."""
    return sum(section_flops(h, w).values())


def section_bytes(h, w, batch=1):
    """{section: bytes a frame} in batches of ``batch``: its weights once a
    batch, its inputs and its outputs once, float32."""
    d = VIT_DIM
    weights = {k: sum(n for _, n in v) for k, v in _layers(h, w).items()}
    taps = [256 * (h // 4) * (w // 4), 512 * (h // 8) * (w // 8)]
    feat = 1024 * (h // 16) * (w // 16)
    layer3 = d * (h // 16) * (w // 16)
    layer4 = d * _up(h // 16) * _up(w // 16)
    io = {"dpt.resnet": 3 * h * w + sum(taps) + feat,
          "dpt.vit": feat + layer3 + layer4,
          "dpt.decoder": sum(taps) + layer3 + layer4 + h * w}
    return {k: F32 * (weights[k] / batch + io[k]) for k in SECTIONS}


def least_seconds(h, w, batch=1):
    """{section: the least seconds a frame} in batches of ``batch``: the
    larger of its FLOPs at the f32 peak and its bytes at HBM's rate."""
    fl, by = section_flops(h, w), section_bytes(h, w, batch)
    return {k: max(fl[k] / PEAK_FP32_FLOPS, by[k] / counts.PEAK_HBM_BYTES)
            for k in SECTIONS}


def network_hw(h, w, target=384, multiple=32):
    """The network input's size for frames of h x w (the transform's
    rule)."""
    sh, sw = target / h, target / w
    s = sh if abs(1.0 - sh) <= abs(1.0 - sw) else sw
    return tuple(int(round(s * n / multiple)) * multiple for n in (h, w))
