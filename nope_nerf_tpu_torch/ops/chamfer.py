"""Symmetric Chamfer distance, exact mode (port of the exact and ``auto``
parts of ``nope_nerf_tpu/ops/chamfer.py``; the ``grid`` mode is not ported).

The nearest-neighbour index is found without gradient, then the loss is
the differentiable distance to the gathered neighbour, as in the reference.
The banded mode that training uses is in :mod:`.kernels.chamfer_band`.
"""
from __future__ import annotations

import torch


def resolve_chamfer_mode(mode: str, hints_available: bool = False) -> str:
    """Resolve 'auto': 'band' when projection hints exist (the training pc
    loss always has them), else 'exact'. The JAX package may pick its
    approximate 'grid' mode for large clouds without hints; that mode is
    not ported, so the port resolves to the exact one there."""
    if mode != "auto":
        return mode
    return "band" if hints_available else "exact"


def _nearest_one_direction(X, Y, block):
    """argmin_j ||x - y_j|| per row of X as ||y||^2 - 2 x.y (the ||x||^2
    term is constant per row), blocked over rows of X."""
    yy = torch.sum(Y * Y, dim=-1)
    out = [torch.argmin(yy[None] - 2.0 * (X[i:i + block] @ Y.t()), dim=1)
           for i in range(0, X.shape[0], block)]
    return torch.cat(out).to(torch.int32)


def nearest_idx(X, Y, block: int = 2048):
    """(idx_x (S,) into Y, idx_y (D,) into X), no gradient."""
    X, Y = X.detach(), Y.detach()
    return (_nearest_one_direction(X, Y, block),
            _nearest_one_direction(Y, X, block))


def _safe_dist(v):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 1e-24))


def chamfer_loss(X, Y, block: int = 2048):
    """mean_x ||x - y_nn(x)|| + mean_y ||y - x_nn(y)||."""
    idx_x, idx_y = nearest_idx(X, Y, block)
    return (torch.mean(_safe_dist(X - Y[idx_x.long()]))
            + torch.mean(_safe_dist(Y - X[idx_y.long()])))
