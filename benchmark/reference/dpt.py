"""Plain PyTorch reference of the DPT-Hybrid depth-prior pass, in float32
with TF32 off, written from the published description and against nothing
of the program: Ranftl, Bochkovskiy and Koltun, "Vision Transformers for
Dense Prediction" (ICCV 2021), the ``dpt_hybrid`` model of
github.com/isl-org/DPT (``dpt_hybrid-midas-501f0c75.pt``) as NoPe-NeRF's
``preprocess/dpt_depth.py`` runs it.

What it covers, in order:

* the input transform: keep-aspect 'minimal' resize toward 384x384 with
  sides rounded to multiples of 32 (half to even), bicubic (A = -0.75,
  borders clamped, align_corners False) in float64, then (x - 0.5) / 0.5;
* the ResNetV2-50 stem and three stages (3, 4, 9 bottlenecks of widths
  256, 512, 1024; the stride on the 3x3 convolution), with
  weight-standardised convolutions and GroupNorm(32, eps 1e-5);
* the patch embedding (a 1x1 convolution of the H/16 features), the class
  token, the 24x24 position embedding resized bilinearly to the grid, and
  12 pre-LN ViT-B/16 blocks (width 768, 12 heads, MLP 3072, exact GELU,
  LayerNorm eps 1e-6);
* the readouts of blocks 8 and 11 ('project': each patch token beside the
  class token, a linear layer and GELU), the reassemble convolutions, the
  ResNet's stage 1 and 2 outputs as the other two taps;
* the RefineNet fusion decoder at width 256 (residual convolution units,
  x2 bilinear upsampling with aligned corners, 1x1 output convolutions),
  the head and the depth tail 1 / max(scale * inv + shift, 1e-8).

Departures from a literal reading, each as the published model computes:

* the ResNet's convolutions are timm's ``StdConv2dSame``: each output
  channel's weight standardised with its biased variance (eps 1e-6), and
  TF "SAME" padding, the odd pixel after; the stem's max pool pads with
  -inf the same way;
* the last block's final LayerNorm is not applied: the taps are the
  blocks' outputs;
* the second reassemble of block 11 is a plain 3x3 convolution of stride
  2 with a symmetric padding of 1.

Parameters are read in the port's layout (a dict tree: convolutions OIHW,
linear layers (out, in)); the values are the benchmark's. ``fault`` plants
one of two faults for the limits' control (``control_dpt.py``):
``"skip_block8"`` leaves ViT block 8 out, ``"zero_cls_readout"`` zeroes
the class-token half of both readouts' inputs.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

HEADS = 12
TAPS = (8, 11)
FAULTS = ("skip_block8", "zero_cls_readout")


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


def transform(frames, target=384, multiple=32):
    """(B, H, W, 3) in [0, 1] -> (B, 3, h', w') float32, the network's
    input."""
    h, w = frames.shape[1], frames.shape[2]
    sh, sw = target / h, target / w
    s = sh if abs(1.0 - sh) <= abs(1.0 - sw) else sw
    size = [int(round(s * n / multiple)) * multiple for n in (h, w)]
    x = frames.double().movedim(3, 1)
    x = F.interpolate(x, size=size, mode="bicubic", align_corners=False)
    return ((x - 0.5) * 2.0).float()


def _same(x, k, stride, value=0.0):
    """Pad both spatial axes as TF "SAME" does for a window ``k``."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def std_conv(x, w, stride=1):
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    w = (w - mean) / torch.sqrt(var + 1e-6)
    return F.conv2d(_same(x, w.shape[-1], stride), w, stride=stride)


def conv(x, p, stride=1, pad=None):
    """A plain convolution with its bias where it has one; ``pad``
    defaults to half the window (stride 1 keeps the size)."""
    k = p["w"].shape[-1]
    return F.conv2d(x, p["w"], p.get("b"), stride=stride,
                    padding=k // 2 if pad is None else pad)


def group_norm(x, p, groups=32, eps=1e-5):
    b, c = x.shape[:2]
    g = x.reshape(b, groups, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=2, keepdim=True)
    g = (g - mean) / torch.sqrt(var + eps)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return (g.reshape(x.shape) * p["scale"].reshape(shape)
            + p["bias"].reshape(shape))


def layer_norm(x, p, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def linear(x, p):
    return x @ p["w"].t() + p["b"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def bottleneck(x, p, stride):
    if "down_conv" in p:
        short = group_norm(std_conv(x, p["down_conv"]["w"], stride),
                           p["down_norm"])
    else:
        short = x
    y = torch.relu(group_norm(std_conv(x, p["conv1"]["w"]), p["norm1"]))
    y = torch.relu(group_norm(std_conv(y, p["conv2"]["w"], stride),
                              p["norm2"]))
    y = group_norm(std_conv(y, p["conv3"]["w"]), p["norm3"])
    return torch.relu(y + short)


def resnet(x, p):
    """-> the outputs of stages 1, 2 and 3 (H/4, H/8, H/16)."""
    y = torch.relu(group_norm(std_conv(x, p["stem_conv"]["w"], 2),
                              p["stem_norm"]))
    y = F.max_pool2d(_same(y, 3, 2, -math.inf), 3, 2)
    outs = []
    for i, stage in enumerate(p["stages"]):
        for j, block in enumerate(stage):
            y = bottleneck(y, block, 2 if i > 0 and j == 0 else 1)
        outs.append(y)
    return outs


def vit_block(x, p):
    b, t, d = x.shape
    hd = d // HEADS
    qkv = linear(layer_norm(x, p["ln1"]), p["qkv"]).reshape(b, t, 3, HEADS,
                                                             hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    att = torch.softmax(torch.einsum("bhqc,bhkc->bhqk", q, k) / math.sqrt(hd),
                        dim=-1)
    y = torch.einsum("bhqk,bhkc->bhqc", att, v).transpose(1, 2)
    x = x + linear(y.reshape(b, t, d), p["proj"])
    return x + linear(gelu(linear(layer_norm(x, p["ln2"]), p["mlp1"])),
                      p["mlp2"])


def readout(tokens, p, grid, fault):
    """Each patch token beside the class token -> linear + GELU -> an
    NCHW grid."""
    patches = tokens[:, 1:]
    cls = tokens[:, :1].expand_as(patches)
    if fault == "zero_cls_readout":
        cls = torch.zeros_like(cls)
    y = gelu(linear(torch.cat([patches, cls], dim=-1), p))
    return y.transpose(1, 2).reshape(y.shape[0], y.shape[2], *grid)


def pos_embedding(pos, grid):
    """The class token's embedding and the square grid's, resized
    bilinearly (align_corners False) to ``grid``."""
    side = math.isqrt(pos.shape[1] - 1)
    g = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
    g = F.interpolate(g, size=grid, mode="bilinear", align_corners=False)
    return torch.cat([pos[:, :1], g.flatten(2).transpose(1, 2)], dim=1)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def rcu(x, p):
    y = conv(torch.relu(x), p["conv1"])
    return x + conv(torch.relu(y), p["conv2"])


def fusion(p, x, skip=None):
    if skip is not None:
        x = x + rcu(skip, p["rcu1"])
    return conv(up2(rcu(x, p["rcu2"])), p["out_conv"])


def head_output(params, x, fault=None):
    """(B, 3, h', w') network input -> (B, h', w'): the head's output
    before its ReLU."""
    layer1, layer2, feat = resnet(x, params["resnet"])
    grid = (x.shape[2] // 16, x.shape[3] // 16)
    tok = conv(feat, params["patch_proj"], pad=0).flatten(2).transpose(1, 2)
    tok = torch.cat([params["cls_token"].expand(tok.shape[0], -1, -1), tok],
                    dim=1) + pos_embedding(params["pos_embed"], grid)
    taps = {}
    for i, block in enumerate(params["blocks"]):
        if not (fault == "skip_block8" and i == 8):
            tok = vit_block(tok, block)
        if i in TAPS:
            taps[i] = tok
    layer3 = conv(readout(taps[8], params["readout3"], grid, fault),
                  params["post3_conv"], pad=0)
    layer4 = conv(readout(taps[11], params["readout4"], grid, fault),
                  params["post4_conv1"], pad=0)
    layer4 = conv(layer4, params["post4_conv2"], stride=2, pad=1)
    sc = params["scratch"]
    rn = [conv(t, sc[f"layer{i + 1}_rn"])
          for i, t in enumerate((layer1, layer2, layer3, layer4))]
    path = fusion(params["refinenet4"], rn[3])
    path = fusion(params["refinenet3"], path, rn[2])
    path = fusion(params["refinenet2"], path, rn[1])
    path = fusion(params["refinenet1"], path, rn[0])
    hp = params["head"]
    y = torch.relu(conv(up2(conv(path, hp["conv1"])), hp["conv2"]))
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
    (B, h', w') float32, one frame at a time."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    pres = []
    with torch.no_grad(), precision(tf32):
        for i in range(frames.shape[0]):
            pres.append(head_output(params, transform(frames[i:i + 1]),
                                    fault))
    pre = torch.cat(pres)
    return depth_from(pre, depth_cfg), pre
