"""Depth Anything V2 monocular depth network, as a frozen depth prior.

Yang et al., "Depth Anything V2" (NeurIPS 2024, arXiv:2406.09414),
github.com/DepthAnything/Depth-Anything-V2, ``model_configs['vitl']``
(``depth_anything_v2_vitl.pth``, 335.3 M parameters): a DINOv2 ViT-L/14
encoder and a DPT head.

* Input (:func:`depth_anything_input_transform_batched`): a keep-aspect
  'lower_bound' bicubic resize toward 518x518 with sides in multiples of
  14 (540x960 -> 518x924), then ImageNet's mean and std.
* Tokens: a 14x14 stride-14 patch convolution on the pixels, the class
  token before them, and the position embedding, whose 37x37 grid is
  resized bicubically by the scale factors ((gh + 0.1) / 37, (gw + 0.1) /
  37) (:func:`resize_pos_embed`); no register tokens.
* 24 pre-LN blocks, width 1024, 16 heads of 64, MLP 4096, exact GELU,
  LayerNorm eps 1e-6, q scaled by 64^-0.5 before ``q k^T``, and LayerScale:
  ``x + ls1 * attn(norm1(x))``, ``x + ls2 * mlp(norm2(x))``.
* Taps after blocks 4, 11, 17 and 23 (0-based), each through the final
  ``norm``, the class token dropped, as (B, 1024, gh, gw) grids.
* Reassembly: a 1x1 projection to 256, 512, 1024, 1024 channels, then a
  4x4 stride-4 transposed convolution, a 2x2 stride-2 one, nothing, and a
  3x3 stride-2 convolution; a 3x3 convolution of each to 256.
* Fusion (``models/dpt.py``'s blocks): refinenet4 resized to layer 3's
  grid, refinenet3 to layer 2's, refinenet2 to layer 1's, refinenet1 by 2,
  each bilinear with aligned corners.
* Head: 3x3 to 128, a bilinear resize (aligned corners) to (14 gh, 14 gw),
  3x3 to 32 and ReLU, 1x1 to 1; then the ReLU and NoPe-NeRF's tail ``1 /
  max(scale * x + shift, 1e-8)``.

Departures from the published model: every convolution and matrix product
runs in f32 with TF32 off (:func:`..device.no_tf32`), where published
PyTorch runs its convolutions in TF32 by default; NoPe-NeRF's depth tail
is applied to Depth Anything's relative disparity, with the ``depth``
config's scale and shift; the depths stay at the network's size (518x924
for 540x960 frames), as ``dpt_depth`` keeps DPT's 384x672, and are not
resized back to the frame.

Parameters: a dict tree in PyTorch's layouts (convolutions OIHW,
transposed convolutions (in, out, kH, kW), linear layers (out, in));
:func:`param_shapes` gives it, ``convert_depth_anything`` writes it from
the published checkpoint. No kernel is ported: convolutions and products
are ``F.conv2d`` and ``torch.matmul``, as in ``models/dpt.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import tracing
from ..training.checkpoints import load_pytree
from .dpt import (
    _apply_fusion,
    _apply_head,
    _apply_vit_block,
    _conv,
    _depth_tail,
    _layer_norm,
    dpt_input_transform_batched,
    run_frames,
)

PATCH = 14
DIM = 1024
BLOCKS = 24
MLP = 4096
POS_GRID = 37  # 518 / 14
# Depth Anything V2 taps each DINOv2 size's encoder after the blocks its
# ``intermediate_layer_idx`` names, by the encoder's depth (its heads are
# 64 wide in every size: ViT-S 6 heads, B 12, L 16, g 24)
TAPS = {12: (2, 5, 8, 11), 24: (4, 11, 17, 23), 40: (9, 19, 29, 39)}
OUT_CHANNELS = (256, 512, 1024, 1024)
FEATURES = 256
INPUT_SIZE = 518
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# DINOv2's offset of the position embedding's resize
POS_OFFSET = 0.1


def param_shapes(dim=DIM, blocks=BLOCKS, mlp=MLP, pos_grid=POS_GRID,
                 out_channels=OUT_CHANNELS, features=FEATURES, patch=PATCH):
    """The parameter tree, each leaf its shape."""
    def conv(cin, cout, k, bias=True):
        p = {"w": (cout, cin, k, k)}
        if bias:
            p["b"] = (cout,)
        return p

    def linear(cin, cout):
        return {"w": (cout, cin), "b": (cout,)}

    def norm(c):
        return {"scale": (c,), "bias": (c,)}

    def fusion():
        rcu = {"conv1": conv(features, features, 3),
               "conv2": conv(features, features, 3)}
        return {"rcu1": rcu, "rcu2": dict(rcu),
                "out_conv": conv(features, features, 1)}

    oc = out_channels
    return {
        "patch_embed": conv(3, dim, patch),
        "cls_token": (1, 1, dim),
        "pos_embed": (1, 1 + pos_grid * pos_grid, dim),
        "blocks": [{"ln1": norm(dim), "qkv": linear(dim, 3 * dim),
                    "proj": linear(dim, dim), "ls1": (dim,),
                    "ln2": norm(dim), "mlp1": linear(dim, mlp),
                    "mlp2": linear(mlp, dim), "ls2": (dim,)}
                   for _ in range(blocks)],
        "norm": norm(dim),
        "projects": [conv(dim, c, 1) for c in oc],
        # transposed convolutions keep PyTorch's (in, out, kH, kW)
        "resize0": {"w": (oc[0], oc[0], 4, 4), "b": (oc[0],)},
        "resize1": {"w": (oc[1], oc[1], 2, 2), "b": (oc[1],)},
        "resize3": conv(oc[3], oc[3], 3),
        "scratch": {f"layer{i + 1}_rn": conv(c, features, 3, bias=False)
                    for i, c in enumerate(oc)},
        **{f"refinenet{r}": fusion() for r in (1, 2, 3, 4)},
        "head": {"conv1": conv(features, features // 2, 3),
                 "conv2": conv(features // 2, 32, 3),
                 "conv3": conv(32, 1, 1)},
    }


def resize_pos_embed(pos_embed, h, w, patch=PATCH):
    """The position embedding (1, 1 + g*g, D) for an h x w input, as
    DINOv2's ``interpolate_pos_encoding``: unchanged for a square input of
    g x g patches, else its grid resized bicubically (A = -0.75,
    antialias off) by the scale factors ((gh + 0.1) / g, (gw + 0.1) / g),
    in f32. The factors set the source coordinates too: a resize to the
    size (gh, gw) samples other points."""
    gh, gw = h // patch, w // patch
    tok, grid = pos_embed[:, :1], pos_embed[:, 1:]
    g = math.isqrt(grid.shape[1])
    if gh * gw == g * g and h == w:
        return pos_embed
    grid = grid.reshape(1, g, g, -1).permute(0, 3, 1, 2).float()
    grid = F.interpolate(grid, scale_factor=((gh + POS_OFFSET) / g,
                                             (gw + POS_OFFSET) / g),
                         mode="bicubic", antialias=False)
    if grid.shape[2:] != (gh, gw):
        raise ValueError(f"position grid {tuple(grid.shape[2:])} for "
                         f"{gh}x{gw} patches")
    return torch.cat([tok, grid.flatten(2).transpose(1, 2)], dim=1)


def _apply_encoder(params, x):
    """DINOv2 on NCHW pixels -> the normed taps as (B, D, gh, gw) grids:
    width // 64 heads, the taps of the encoder's depth (:data:`TAPS`)."""
    B, _, H, W = x.shape
    if len(params["blocks"]) not in TAPS:
        raise ValueError(f"no published taps for {len(params['blocks'])} "
                         "blocks")
    taps = TAPS[len(params["blocks"])]
    gh, gw = H // PATCH, W // PATCH
    tracing.section("dpt.dinov2")
    pe = params["patch_embed"]
    tok = F.conv2d(x, pe["w"], pe["b"], stride=PATCH)
    tok = tok.flatten(2).transpose(1, 2)  # (B, gh*gw, D), row-major
    D = tok.shape[-1]
    tok = torch.cat([params["cls_token"].expand(B, 1, D), tok], dim=1)
    tok = tok + resize_pos_embed(params["pos_embed"], H, W)
    nrm = params["norm"]
    feats = []
    for i, bp in enumerate(params["blocks"]):
        tok = _apply_vit_block(bp, tok, attn_section="dpt.dinov2.attn")
        if i in taps:
            t = _layer_norm(tok, nrm["scale"], nrm["bias"])[:, 1:]
            feats.append(t.transpose(1, 2).reshape(B, D, gh, gw))
    return feats


def _apply_decoder(params, feats, gh, gw):
    """Reassembly, fusion and head -> (B, 14 gh, 14 gw), the head's
    output before its ReLU."""
    tracing.section("dpt.decoder")
    layers = []
    for i, f in enumerate(feats):
        pr = params["projects"][i]
        y = F.conv2d(f, pr["w"], pr["b"])
        if i in (0, 1):
            r = params[f"resize{i}"]
            y = F.conv_transpose2d(y, r["w"], r["b"], stride=r["w"].shape[2])
        elif i == 3:
            r = params["resize3"]
            y = F.conv2d(y, r["w"], r["b"], stride=2, padding=1)
        layers.append(y)
    sc = params["scratch"]
    rn = [_conv(y, sc[f"layer{i + 1}_rn"]["w"]) for i, y in enumerate(layers)]
    path = _apply_fusion(params["refinenet4"], rn[3], size=rn[2].shape[2:])
    path = _apply_fusion(params["refinenet3"], path, rn[2],
                         size=rn[1].shape[2:])
    path = _apply_fusion(params["refinenet2"], path, rn[1],
                         size=rn[0].shape[2:])
    path = _apply_fusion(params["refinenet1"], path, rn[0])
    return _apply_head(params["head"], path, (gh * PATCH, gw * PATCH))


def _apply_depth_anything_nchw(params, x, scale=0.000305, shift=0.1378,
                               invert=True, non_negative=True,
                               pre_relu=False):
    """The network on NCHW ImageNet-normalised pixels, H and W multiples
    of 14, under the caller's autograd and TF32 settings:
    :func:`apply_depth_anything_batched` is the entry point. Sections
    ``dpt.dinov2`` (with ``dpt.dinov2.attn`` around each block's attention
    cores) and ``dpt.decoder`` (reassembly, fusion, head, tail)."""
    gh, gw = x.shape[2] // PATCH, x.shape[3] // PATCH
    feats = _apply_encoder(params, x)
    h = _apply_decoder(params, feats, gh, gw)
    return _depth_tail(h, scale, shift, invert, non_negative, pre_relu)


def apply_depth_anything_batched(params, imgs, mesh=None, pre_relu=False,
                                 **kw):
    """(B, H, W, 3) images of :func:`depth_anything_input_transform_batched`
    on the parameters' device -> depth (B, H, W) with TF32 off and without
    autograd (``scale``, ``shift``, ``invert`` and ``non_negative`` as
    :func:`_apply_depth_anything_nchw` takes them); with
    ``pre_relu`` the head's output before its ReLU beside it. Sharded over
    ``mesh`` as ``models/dpt.py::run_frames`` says."""
    return run_frames(_apply_depth_anything_nchw, params, imgs, mesh,
                      pre_relu, **kw)


def depth_anything_input_transform_batched(frames, input_size=INPUT_SIZE):
    """(B, H, W, 3) frames in [0, 1] -> (B, h', w', 3) f32 network input:
    the published ``Resize(input_size, input_size, keep_aspect_ratio=True,
    ensure_multiple_of=14, resize_method='lower_bound', INTER_CUBIC)`` and
    ``NormalizeImage`` with ImageNet's mean and std, in float64."""
    return dpt_input_transform_batched(frames, input_size, PATCH,
                                       "lower_bound", MEAN, STD)


def load_depth_anything(path, device=None):
    """The npz of ``convert_depth_anything`` -> the parameter tree, f32 on
    ``device``."""
    tree, _, _ = load_pytree(path)

    def to(node):
        if isinstance(node, dict):
            return {k: to(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to(v) for v in node]
        return torch.as_tensor(node, dtype=torch.float32, device=device)

    return to(tree["params"])
