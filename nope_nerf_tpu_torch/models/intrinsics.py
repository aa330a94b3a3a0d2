"""Learnable focal length (port of ``nope_nerf_tpu/models/intrinsics.py``).

Order 2 stores a = sqrt(f) so f = a^2 stays positive; order 1 stores f.
``fx_only`` ties fy to fx. Values are in normalised pixel units (2f/w).
"""
from __future__ import annotations

import math

import torch


def init_focal_params(fx_only: bool, order: int = 2, init_focal=None,
                      device=None) -> dict:
    """{'fx': scalar[, 'fy': scalar]}; ``init_focal`` None (1.0), a scalar
    or [fx, fy]."""
    def coe(f):
        f = float(f)
        if order == 2:
            f = math.sqrt(f)
        elif order != 1:
            raise ValueError("Focal init order must be 1 or 2")
        return torch.tensor(f, dtype=torch.float32, device=device)

    if init_focal is None:
        params = {"fx": torch.tensor(1.0, device=device)}
        if not fx_only:
            params["fy"] = torch.tensor(1.0, device=device)
        return params
    if fx_only:
        f = init_focal[0] if isinstance(init_focal, (list, tuple)) else init_focal
        return {"fx": coe(f)}
    if isinstance(init_focal, (list, tuple)):
        return {"fx": coe(init_focal[0]), "fy": coe(init_focal[1])}
    return {"fx": coe(init_focal), "fy": coe(init_focal)}


def focal_fxfy(params, fx_only: bool, order: int = 2, req_grad: bool = True):
    """-> (2,) [fx, fy]."""
    fx = params["fx"]
    fy = params.get("fy", fx) if not fx_only else fx
    if not req_grad:
        fx, fy = fx.detach(), fy.detach()
    if order == 2:
        return torch.stack([fx ** 2, fy ** 2])
    return torch.stack([fx, fy])
