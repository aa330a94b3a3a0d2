"""DPT-hybrid monocular depth network (port of ``nope_nerf_tpu/models/dpt.py``).

The frozen depth estimator of the reference: a ResNetV2-50 + ViT-B/16
hybrid backbone tapped after ResNet stages 0 and 1 and ViT blocks 8 and 11,
projected readout tokens, reassemble convolutions, a RefineNet-style fusion
decoder and the monodepth head, with the inverse-depth -> depth tail
``1 / max(scale * inv + shift, 1e-8)``.

Parameters are the JAX package's tree with PyTorch's layouts: conv weights
OIHW, linear weights (out, in) (:func:`..convert.dpt_params_from_jax` maps
the JAX tree, which is also the npz format on disk). Activations are NCHW
batches. Every convolution and matrix product runs in full f32: the priors
are computed once and supervise all of training, and the JAX package runs
them at ``Precision.HIGHEST``; on the card :func:`..device.no_tf32` keeps
TF32 off around the forward. No kernel is ported here: the JAX module's
convolutions and products are plain XLA, so these are ``F.conv2d`` and
``torch.matmul``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import dpt_params_from_jax, tree_to
from ..device import no_tf32
from ..ops.interp import resize_bilinear
from ..training.checkpoints import load_pytree

RESNET_LAYERS = (3, 4, 9)
RESNET_CHANNELS = (256, 512, 1024)
VIT_DIM = 768
VIT_HEADS = 12
VIT_BLOCKS = 12
VIT_GRID = 24  # 384 / 16
FEATURES = 256  # scratch width
REASSEMBLE = (256, 512, 768, 768)

# ---------------------------------------------------------------------------
# primitive layers, NCHW
# ---------------------------------------------------------------------------


def _same_pads(size, k, stride):
    """TF "SAME" padding of one axis: (before, after), the extra pixel after
    (asymmetric at stride 2 on even sizes)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b=None, stride=1, padding="SAME", std=False):
    """NCHW conv with an OIHW weight. ``padding`` "SAME" (TF semantics) or
    an int of symmetric padding; ``std`` standardises the weight per output
    channel first (timm StdConv2dSame: biased variance, eps 1e-6)."""
    if std:
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        w = (w - mean) / torch.sqrt(var + 1e-6)
    if padding == "SAME":
        kh, kw = w.shape[2:]
        (pt, pb), (pl, pr) = (_same_pads(x.shape[2], kh, stride),
                              _same_pads(x.shape[3], kw, stride))
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            padding = 0
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def _group_norm(x, scale, bias, groups=32, eps=1e-5):
    return F.group_norm(x, min(groups, x.shape[1]), scale, bias, eps)


def _layer_norm(x, scale, bias, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _max_pool_same(x, window=3, stride=2):
    """Max pool with TF "SAME" padding by -inf (asymmetric: the extra pixel
    goes after)."""
    (pt, pb), (pl, pr) = (_same_pads(x.shape[2], window, stride),
                          _same_pads(x.shape[3], window, stride))
    x = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
    return F.max_pool2d(x, window, stride)


def _resize_bilinear_ac(x, out_hw):
    """Bilinear resize with align_corners=True."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def _resize_pos_embed(pos_embed, gs_h, gs_w):
    """Bilinear-resize (align_corners=False, the JAX package's
    ``ops/interp.resize_bilinear``) the grid part of (1, 1 + g*g, D)."""
    tok, grid = pos_embed[:, :1], pos_embed[0, 1:]
    gs_old = int(math.isqrt(grid.shape[0]))
    grid = resize_bilinear(grid.reshape(gs_old, gs_old, -1), (gs_h, gs_w))
    return torch.cat([tok, grid.reshape(1, gs_h * gs_w, -1)], dim=1)


# ---------------------------------------------------------------------------
# ResNetV2 stem + stages (non-preact, StdConv + GroupNorm32, SAME padding)
# ---------------------------------------------------------------------------


def _apply_bottleneck(p, x, stride):
    """conv-GN-relu x2, conv-GN, residual add, relu."""
    if "down_conv" in p:
        sc = _conv(x, p["down_conv"]["w"], stride=stride, std=True)
        sc = _group_norm(sc, p["down_norm"]["scale"], p["down_norm"]["bias"])
    else:
        sc = x
    h = _conv(x, p["conv1"]["w"], std=True)
    h = F.relu(_group_norm(h, p["norm1"]["scale"], p["norm1"]["bias"]))
    h = _conv(h, p["conv2"]["w"], stride=stride, std=True)
    h = F.relu(_group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"]))
    h = _conv(h, p["conv3"]["w"], std=True)
    h = _group_norm(h, p["norm3"]["scale"], p["norm3"]["bias"])
    return F.relu(h + sc)


def _apply_resnet(p, x):
    """-> (stage0 out (H/4), stage1 out (H/8), final (H/16))."""
    h = _conv(x, p["stem_conv"]["w"], stride=2, std=True)
    h = F.relu(_group_norm(h, p["stem_norm"]["scale"], p["stem_norm"]["bias"]))
    h = _max_pool_same(h, 3, 2)
    taps = []
    for si, blocks in enumerate(p["stages"]):
        for bi, bp in enumerate(blocks):
            h = _apply_bottleneck(bp, h, 2 if (si > 0 and bi == 0) else 1)
        taps.append(h)
    return taps[0], taps[1], taps[2]


# ---------------------------------------------------------------------------
# ViT-B encoder, (B, T, D)
# ---------------------------------------------------------------------------


def _apply_vit_block(p, x):
    """Pre-LN transformer block; attention as matmul, softmax, matmul in
    f32."""
    B, T, D = x.shape
    h = _layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    qkv = F.linear(h, p["qkv"]["w"], p["qkv"]["b"])
    qkv = qkv.reshape(B, T, 3, VIT_HEADS, D // VIT_HEADS).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, T, hd)
    attn = torch.softmax(q @ k.transpose(-1, -2) * (D // VIT_HEADS) ** -0.5,
                         dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(B, T, D)
    x = x + F.linear(out, p["proj"]["w"], p["proj"]["b"])
    h = _layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    h = F.gelu(F.linear(h, p["mlp1"]["w"], p["mlp1"]["b"]))
    return x + F.linear(h, p["mlp2"]["w"], p["mlp2"]["b"])


def _readout(tokens_full, rp, gh, gw):
    """ProjectReadout: the class token concatenated to every patch token,
    linear + GELU, back to an NCHW grid."""
    patches = tokens_full[:, 1:]
    feats = torch.cat([patches, tokens_full[:, :1].expand_as(patches)], -1)
    out = F.gelu(F.linear(feats, rp["w"], rp["b"]))
    return out.transpose(1, 2).reshape(out.shape[0], VIT_DIM, gh, gw)


# ---------------------------------------------------------------------------
# fusion decoder and the full model
# ---------------------------------------------------------------------------


def _apply_rcu(p, x):
    """ResidualConvUnit_custom (bn=False)."""
    h = _conv(F.relu(x), p["conv1"]["w"], p["conv1"]["b"])
    h = _conv(F.relu(h), p["conv2"]["w"], p["conv2"]["b"])
    return h + x


def _apply_fusion(p, x, res=None):
    """FeatureFusionBlock_custom."""
    if res is not None:
        x = x + _apply_rcu(p["rcu1"], res)
    x = _apply_rcu(p["rcu2"], x)
    x = _resize_bilinear_ac(x, (x.shape[2] * 2, x.shape[3] * 2))
    return _conv(x, p["out_conv"]["w"], p["out_conv"]["b"])


def _apply_dpt_nchw(params, x, scale=0.000305, shift=0.1378, invert=True,
                    non_negative=True):
    """The network on NCHW images under the caller's autograd and TF32
    settings; :func:`apply_dpt_batched` is the entry point."""
    B, _, H, W = x.shape
    gh, gw = H // 16, W // 16

    tap1, tap2, feat = _apply_resnet(params["resnet"], x)
    tokens = _conv(feat, params["patch_proj"]["w"], params["patch_proj"]["b"])
    tokens = tokens.flatten(2).transpose(1, 2)  # (B, gh*gw, D), row-major
    cls = params["cls_token"].expand(B, 1, VIT_DIM)
    x = torch.cat([cls, tokens], dim=1)
    x = x + _resize_pos_embed(params["pos_embed"], gh, gw)

    hooks = {}
    for i, bp in enumerate(params["blocks"]):
        x = _apply_vit_block(bp, x)
        if i in (8, 11):
            hooks[i] = x

    l3 = _readout(hooks[8], params["readout3"], gh, gw)
    l4 = _readout(hooks[11], params["readout4"], gh, gw)
    l3 = _conv(l3, params["post3_conv"]["w"], params["post3_conv"]["b"])
    l4 = _conv(l4, params["post4_conv1"]["w"], params["post4_conv1"]["b"])
    # a plain nn.Conv2d(3x3, stride=2, padding=1): SYMMETRIC padding, unlike
    # the SAME convs of the ResNet
    l4 = _conv(l4, params["post4_conv2"]["w"], params["post4_conv2"]["b"],
               stride=2, padding=1)

    sc = params["scratch"]
    r1 = _conv(tap1, sc["layer1_rn"]["w"])
    r2 = _conv(tap2, sc["layer2_rn"]["w"])
    r3 = _conv(l3, sc["layer3_rn"]["w"])
    r4 = _conv(l4, sc["layer4_rn"]["w"])

    p4 = _apply_fusion(params["refinenet4"], r4)
    p3 = _apply_fusion(params["refinenet3"], p4, r3)
    p2 = _apply_fusion(params["refinenet2"], p3, r2)
    p1 = _apply_fusion(params["refinenet1"], p2, r1)

    hp = params["head"]
    h = _conv(p1, hp["conv1"]["w"], hp["conv1"]["b"])
    h = _resize_bilinear_ac(h, (h.shape[2] * 2, h.shape[3] * 2))
    h = F.relu(_conv(h, hp["conv2"]["w"], hp["conv2"]["b"]))
    h = _conv(h, hp["conv3"]["w"], hp["conv3"]["b"])[:, 0]
    inv_depth = F.relu(h) if non_negative else h
    if invert:
        return 1.0 / torch.clamp_min(scale * inv_depth + shift, 1e-8)
    return inv_depth


def apply_dpt_batched(params, imgs, **kw):
    """(B, H, W, 3) DPT-normalised images ((x - 0.5) / 0.5), H and W
    multiples of 32, on the parameters' device -> depth (B, H, W) (the
    inverse depth with ``invert`` False; ``scale``, ``shift``, ``invert``,
    ``non_negative`` as in :func:`_apply_dpt_nchw`). Runs with TF32 off and
    without autograd."""
    with torch.no_grad(), no_tf32():
        return _apply_dpt_nchw(params, imgs.permute(0, 3, 1, 2), **kw)


def apply_dpt(params, img, **kw):
    """One image (H, W, 3) -> depth (H, W); see :func:`apply_dpt_batched`."""
    return apply_dpt_batched(params, img[None], **kw)[0]


def dpt_input_transform(img, target=384, multiple_of=32):
    """The reference's ``ResizeImage_mvs``: keep-aspect 'minimal' resize
    toward a 384x384 target rounded to multiples of 32 (bicubic), then
    (x - 0.5) / 0.5.

    'minimal' keeps the per-axis scale CLOSEST TO 1: the smaller one when
    upscaling, the larger one when the image is bigger than 384 (540x960 ->
    384x672). The JAX package resizes with ``cv2.resize(INTER_CUBIC)``;
    this is ``F.interpolate(mode="bicubic", align_corners=False)`` (the same
    A = -0.75 kernel and clamped borders) in float64, which lands within
    ~3e-7 of cv2's f32 result where f32 bicubic differs by ~1e-4.

    img: (H, W, 3) float numpy in [0, 1]. Returns (h', w', 3) f32 numpy.
    """
    H, W = img.shape[:2]
    scale_h, scale_w = target / H, target / W
    scale = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
    # np.round (half to even) as the reference's constrain_to_multiple_of
    new_h = int(np.round(scale * H / multiple_of) * multiple_of)
    new_w = int(np.round(scale * W / multiple_of) * multiple_of)
    x = torch.as_tensor(np.asarray(img), dtype=torch.float64)
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(new_h, new_w),
                        mode="bicubic", align_corners=False)[0]
    return ((out.permute(1, 2, 0).numpy() - 0.5) / 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _init_conv(gen, kh, kw, cin, cout, bias=True):
    bound = 1.0 / math.sqrt(kh * kw * cin)
    p = {"w": (torch.rand((cout, cin, kh, kw), generator=gen) * 2 - 1) * bound}
    if bias:
        p["b"] = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
    return p


def _init_linear(gen, cin, cout):
    bound = 1.0 / math.sqrt(cin)
    return {"w": (torch.rand((cout, cin), generator=gen) * 2 - 1) * bound,
            "b": (torch.rand((cout,), generator=gen) * 2 - 1) * bound}


def _init_norm(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _init_bottleneck(gen, cin, cmid, cout, downsample):
    p = {"conv1": _init_conv(gen, 1, 1, cin, cmid, bias=False),
         "norm1": _init_norm(cmid),
         "conv2": _init_conv(gen, 3, 3, cmid, cmid, bias=False),
         "norm2": _init_norm(cmid),
         "conv3": _init_conv(gen, 1, 1, cmid, cout, bias=False),
         "norm3": _init_norm(cout)}
    if downsample:
        p["down_conv"] = _init_conv(gen, 1, 1, cin, cout, bias=False)
        p["down_norm"] = _init_norm(cout)
    return p


def _init_fusion(gen):
    def rcu():
        return {"conv1": _init_conv(gen, 3, 3, FEATURES, FEATURES),
                "conv2": _init_conv(gen, 3, 3, FEATURES, FEATURES)}

    return {"rcu1": rcu(), "rcu2": rcu(),
            "out_conv": _init_conv(gen, 1, 1, FEATURES, FEATURES)}


def init_dpt_params(generator, device=None) -> dict:
    """Random parameters in the port's layout, the JAX package's init laws
    (uniform +-1/sqrt(fan_in), unit norms, zero tokens); for shape tests
    and smoke runs, not for depth priors."""
    g = generator
    stages, cin = [], 64
    for n_blocks, cout in zip(RESNET_LAYERS, RESNET_CHANNELS):
        stages.append([_init_bottleneck(g, cin if bi == 0 else cout,
                                        cout // 4, cout, bi == 0)
                       for bi in range(n_blocks)])
        cin = cout
    params = {
        "resnet": {"stem_conv": _init_conv(g, 7, 7, 3, 64, bias=False),
                   "stem_norm": _init_norm(64), "stages": stages},
        "patch_proj": _init_conv(g, 1, 1, 1024, VIT_DIM),
        "cls_token": torch.zeros((1, 1, VIT_DIM)),
        "pos_embed": torch.zeros((1, 1 + VIT_GRID * VIT_GRID, VIT_DIM)),
        "blocks": [{"ln1": _init_norm(VIT_DIM),
                    "qkv": _init_linear(g, VIT_DIM, 3 * VIT_DIM),
                    "proj": _init_linear(g, VIT_DIM, VIT_DIM),
                    "ln2": _init_norm(VIT_DIM),
                    "mlp1": _init_linear(g, VIT_DIM, 4 * VIT_DIM),
                    "mlp2": _init_linear(g, 4 * VIT_DIM, VIT_DIM)}
                   for _ in range(VIT_BLOCKS)],
        "final_ln": _init_norm(VIT_DIM),  # carried, not applied
        "readout3": _init_linear(g, 2 * VIT_DIM, VIT_DIM),
        "readout4": _init_linear(g, 2 * VIT_DIM, VIT_DIM),
        "post3_conv": _init_conv(g, 1, 1, VIT_DIM, REASSEMBLE[2]),
        "post4_conv1": _init_conv(g, 1, 1, VIT_DIM, REASSEMBLE[3]),
        "post4_conv2": _init_conv(g, 3, 3, REASSEMBLE[3], REASSEMBLE[3]),
        "scratch": {f"layer{i + 1}_rn": _init_conv(g, 3, 3, REASSEMBLE[i],
                                                   FEATURES, bias=False)
                    for i in range(4)},
        **{f"refinenet{r}": _init_fusion(g) for r in (1, 2, 3, 4)},
        "head": {"conv1": _init_conv(g, 3, 3, FEATURES, FEATURES // 2),
                 "conv2": _init_conv(g, 3, 3, FEATURES // 2, 32),
                 "conv3": _init_conv(g, 1, 1, 32, 1)},
    }
    return params if device is None else tree_to(params, device)


def load_dpt(path, device=None):
    """A converted checkpoint (the npz of ``convert_dpt``, the JAX
    package's layout) -> the port's parameters on ``device``."""
    tree, _, _ = load_pytree(path)
    return dpt_params_from_jax(tree["params"], device)
