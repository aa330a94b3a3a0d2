"""SO(3) / SE(3) primitives for learnable camera poses (port of
``nope_nerf_tpu/geometry/so3.py``): batched ``vec2skew``, Rodrigues
``exp_so3`` with the small-angle Taylor branch, ``make_c2w``."""
from __future__ import annotations

import torch


def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) skew matrices, skew(v) @ x = v x x."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def exp_so3(r: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3).

    Below angle 1e-4 rad the coefficients sin(n)/n and (1-cos n)/n^2 come
    from their Taylor series, and the closed form sees a safe substitute
    value, so the zero-rotation init has finite gradients (the JAX
    package's double-where).
    """
    skew_r = vec2skew(r)
    sq = torch.sum(r * r, dim=-1)[..., None, None]
    small = sq < 1e-8
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    n = torch.sqrt(sq_safe)
    sin_term = torch.where(small, 1.0 - sq / 6.0, torch.sin(n) / n)
    cos_term = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(n)) / sq_safe)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + sin_term * skew_r + cos_term * (skew_r @ skew_r)


def convert3x4_4x4(m: torch.Tensor) -> torch.Tensor:
    """Append the homogeneous [0, 0, 0, 1] row to (..., 3, 4) matrices."""
    bottom = torch.eye(4, dtype=m.dtype, device=m.device)[3:]
    return torch.cat([m, bottom.expand(m.shape[:-2] + (1, 4))], dim=-2)


def make_c2w(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) + translation (..., 3) -> (..., 4, 4) c2w."""
    return convert3x4_4x4(torch.cat([exp_so3(r), t[..., :, None]], dim=-1))
