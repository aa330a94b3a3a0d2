"""NeRF field: 8-layer MLP with skip connection, density + view-dependent RGB.

Port of ``nope_nerf_tpu/models/nerf.py``. Parameters are a plain dict
``{layer: {"w": (fan_in, fan_out), "b": (fan_out,)}}`` -- the JAX package's
(in, out) layout, not ``nn.Linear``'s (out, in), so both packages index
weights the same way.

:func:`apply_nerf` is the unfused field (the oracle of the fused kernel's
MLP half). With ``mlp_bf16`` every matmul takes bf16 operands with f32
accumulation in forward AND backward, and activations are stored in bf16,
as the JAX ``mlp_bf16`` path does.
"""
from __future__ import annotations

import math

import torch

from ..ops.encoding import encode_position

_BF = torch.bfloat16
_F32 = torch.float32


def _linear_init(gen, fan_in, fan_out, device):
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)

    def u(shape):
        r = torch.rand(shape, generator=gen, dtype=_F32)
        return ((2.0 * r - 1.0) * bound).to(device)

    return {"w": u((fan_in, fan_out)), "b": u((fan_out,))}


def init_nerf_params(gen, cfg: dict, device=None) -> dict:
    """Build the parameter dict from a ``torch.Generator`` (CPU) -- the same
    layer shapes and special bias inits as the JAX package (density bias
    0.1; rgb bias 0.8 with a white background, else 0.02)."""
    D = cfg["model"]["hidden_dim"]
    pos_dim = (2 * cfg["model"]["pos_enc_levels"] + 1) * 3
    dir_dim = (2 * cfg["model"]["dir_enc_levels"] + 1) * 3
    device = device or "cpu"
    params = {}
    dims0 = [pos_dim, D, D, D, D]
    for i in range(4):
        params[f"trunk0_{i}"] = _linear_init(gen, dims0[i], dims0[i + 1], device)
    dims1 = [D + pos_dim, D, D, D, D]
    for i in range(4):
        params[f"trunk1_{i}"] = _linear_init(gen, dims1[i], dims1[i + 1], device)
    params["fc_density"] = _linear_init(gen, D, 1, device)
    params["fc_density"]["b"] = torch.full((1,), 0.1, dtype=_F32, device=device)
    params["fc_feature"] = _linear_init(gen, D, D, device)
    params["rgb_layer"] = _linear_init(gen, D + dir_dim, D // 2, device)
    params["fc_rgb"] = _linear_init(gen, D // 2, 3, device)
    rgb_bias = 0.8 if cfg["rendering"]["white_background"] else 0.02
    params["fc_rgb"]["b"] = torch.full((3,), rgb_bias, dtype=_F32, device=device)
    return params


class _MatmulBF16(torch.autograd.Function):
    """x @ w with both operands rounded to bf16 and f32 accumulation, in
    forward and backward (dx = bf16(g) @ wb^T, dw = xb^T @ bf16(g)); the
    port of the JAX ``_matmul_bf16`` custom vjp. Operands are bf16-valued
    tensors of x's dtype (f32, or f64 for an oracle), so the product runs
    as a plain matmul on any device."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.to(_BF).to(x.dtype)
        wb = w.to(_BF).to(x.dtype)
        ctx.save_for_backward(xb, wb)
        return xb @ wb

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.to(_BF).to(g.dtype)
        return gb @ wb.t(), xb.t() @ gb


def matmul_bf16(x, w):
    """bf16-operand, f32-accumulated ``x @ w`` with the same rounding in the
    backward (see :class:`_MatmulBF16`)."""
    return _MatmulBF16.apply(x, w)


def _dense(p, x, bf16=False):
    """Linear layer. With ``bf16`` the output is cast to bf16, like the JAX
    ``_dense``: activations stay bf16 and so do their cotangents."""
    if bf16:
        return (matmul_bf16(x.to(_F32), p["w"]) + p["b"]).to(_BF)
    return x @ p["w"] + p["b"]


def _trunk(params, pts, L_pos, bf16):
    pos_enc = encode_position(pts, L_pos)
    if bf16:
        pos_enc = pos_enc.to(_BF)
    x = pos_enc
    for i in range(4):
        x = torch.relu(_dense(params[f"trunk0_{i}"], x, bf16))
    x = torch.cat([x, pos_enc], dim=-1)
    for i in range(4):
        x = torch.relu(_dense(params[f"trunk1_{i}"], x, bf16))
    return x


def apply_nerf(params, pts, dirs, cfg_model):
    """Evaluate the field: pts, dirs (M, 3) -> (rgb (M, 3), density (M, 1)).

    Density activation is softplus or relu; without ``dist_alpha`` the field
    emits occupancy alpha = 1 - exp(-density).
    """
    if cfg_model.get("use_pallas_mlp", False):
        raise NotImplementedError(
            "the point-level fused MLP kernel (fuse_compositing: False with "
            "use_pallas_mlp) is not ported yet; set tpu.fuse_compositing: "
            "True or tpu.use_pallas_mlp: False")
    bf16 = bool(cfg_model.get("mlp_bf16", False))
    x = _trunk(params, pts, cfg_model["pos_enc_levels"], bf16)
    density = _dense(params["fc_density"], x, bf16).to(_F32)
    if cfg_model["occ_activation"] == "softplus":
        density = torch.nn.functional.softplus(density)
    else:
        density = torch.relu(density)
    if not cfg_model["dist_alpha"]:
        density = 1.0 - torch.exp(-density)
    dir_enc = encode_position(dirs, cfg_model["dir_enc_levels"])
    if bf16:
        dir_enc = dir_enc.to(_BF)
    feat = _dense(params["fc_feature"], x, bf16)
    h = torch.relu(_dense(params["rgb_layer"], torch.cat([feat, dir_enc], -1),
                          bf16))
    rgb = torch.sigmoid(_dense(params["fc_rgb"], h, bf16).to(_F32))
    return rgb, density
