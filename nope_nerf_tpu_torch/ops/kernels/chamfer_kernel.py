"""Kernel D: the exact Chamfer argmin (``chamfer_mode: exact``, ``tpu.parity``).

Port of ``nope_nerf_tpu/ops/pallas/chamfer_kernel.py`` (Pallas kernel
``_make_kernel`` l.87, launched by ``_nearest_sweep`` l.150). The CUDA source
is ``nope_nerf_tpu_torch/csrc/chamfer_exact.cu``; its header says what bounds
the kernel on the H100 and how the design answers it.

* :func:`nearest_idx_exact` is the public wrapper: CUDA tensors launch the
  kernel (one sweep per direction, counted in :data:`LAUNCHES`); CPU tensors
  run :func:`nearest_idx_exact_reference`; any other device raises.
* Both compute the direct ``((x0 - y0)^2 + (x1 - y1)^2) + (x2 - y2)^2``
  without FMAs, break ties toward the first occurrence and answer 0 where no
  pair is below 1e10, so they return identical indices.
* Validity: invalid X points move to the +1e5 sentinel and invalid Y points
  to -1e5, so they never win against a valid pair. This assumes coordinates
  far below 1e5 (the scale_mat-normalised clouds of the loss).
"""
from __future__ import annotations

import torch

from ..._build import c_function, check
from ...parallel.mesh import rank_rows
from ..chamfer import (
    SENTINEL,
    gather_loss,
    nearest_one_direction,
    sentinel_prep,
)
from . import LaunchCounter

LAUNCHES = LaunchCounter("chamfer_exact")
SPLIT_TILE = 1024   # reduced-cloud rows per shared-memory tile of the kernel
_THREADS = 256      # queries per block
_TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of 132 SMs


def nearest_idx_exact_reference(X, Y, x_valid=None, y_valid=None,
                                two_dir=True):
    """Plain PyTorch version of :func:`nearest_idx_exact` (same arguments
    and results)."""
    Xp = sentinel_prep(X.detach(), x_valid, SENTINEL)
    Yp = sentinel_prep(Y.detach(), y_valid, -SENTINEL)
    idx_x = nearest_one_direction(Xp, Yp)
    if not two_dir:
        return idx_x
    return idx_x, nearest_one_direction(Yp, Xp)


def split_len(n_queries, n_reduced):
    """Reduced-cloud rows per split: enough splits (grid.y) that the
    (query blocks, splits) grid has about 8 blocks per SM, each split a
    whole number of shared-memory tiles."""
    qblocks = -(-n_queries // _THREADS)
    tiles = -(-n_reduced // SPLIT_TILE)
    splits = min(max(1, -(-_TARGET_BLOCKS // qblocks)), tiles)
    return -(-tiles // splits) * SPLIT_TILE


def _sweep(Q, R):
    """One direction on the card: argmin over the rows of R for every row
    of Q, as per-split (min, argmin) pairs merged in split order."""
    nq, nr = Q.shape[0], R.shape[0]
    sl = split_len(nq, nr)
    splits = -(-nr // sl)
    part_d = torch.empty((splits, nq), dtype=torch.float32, device=Q.device)
    part_i = torch.empty((splits, nq), dtype=torch.int32, device=Q.device)
    out = torch.empty(nq, dtype=torch.int32, device=Q.device)
    err = c_function("nnt_exact_argmin", "pipiipppp")(
        Q.data_ptr(), nq, R.data_ptr(), nr, sl, part_d.data_ptr(),
        part_i.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(Q.device).cuda_stream)
    check(err, "exact_argmin")
    LAUNCHES.add()
    return out


def nearest_idx_exact(X, Y, x_valid=None, y_valid=None, two_dir=True):
    """Exact nearest valid neighbour: (idx_x (S,) into Y, idx_y (D,) into
    X) int32, or idx_x alone with ``two_dir=False``. Forward only; indices
    at invalid rows are arbitrary (callers mask them)."""
    dev = X.device
    if dev.type == "cpu":
        return nearest_idx_exact_reference(X, Y, x_valid, y_valid, two_dir)
    if dev.type != "cuda":
        raise ValueError(f"nearest_idx_exact: unsupported device {dev}")
    for name, t in (("Y", Y), ("x_valid", x_valid), ("y_valid", y_valid)):
        if t is not None and t.device != dev:
            raise ValueError(f"nearest_idx_exact: {name} is not on {dev}")
    if X.dtype != torch.float32 or Y.dtype != torch.float32:
        raise ValueError("nearest_idx_exact: X and Y must be float32")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != 3 or Y.shape[1] != 3:
        raise ValueError("nearest_idx_exact: X and Y must be (n, 3)")
    Xp = sentinel_prep(X.detach(), x_valid, SENTINEL).contiguous()
    Yp = sentinel_prep(Y.detach(), y_valid, -SENTINEL).contiguous()
    idx_x = _sweep(Xp, Yp)
    if not two_dir:
        return idx_x
    return idx_x, _sweep(Yp, Xp)


def chamfer_loss_exact(X, Y, x_valid=None, y_valid=None):
    """Symmetric Chamfer with the exact argmin of :func:`nearest_idx_exact`
    (validity-masked means when masks are given)."""
    idx_x, idx_y = nearest_idx_exact(X, Y, x_valid, y_valid)
    return gather_loss(X, Y, idx_x, idx_y, x_valid, y_valid)


def nearest_idx_exact_sharded(X, Y, mesh, x_valid=None, y_valid=None,
                              use_kernel=True):
    """Kernel D under a ray mesh (the JAX ``chamfer_loss_pallas_sharded``'s
    sweeps): :func:`nearest_idx_exact` (its plain version with
    ``use_kernel=False``) on this rank's contiguous rows of X against the
    whole Y, and on its rows of Y against the whole X. X and Y are whole on
    every rank, so no cloud is gathered and the indices at valid rows are
    those of the unsharded sweep. Returns (rows of X, their idx into Y,
    rows of Y, their idx into X)."""
    nearest = nearest_idx_exact if use_kernel else nearest_idx_exact_reference

    def one(Q, R, q_valid, r_valid):
        rows = rank_rows(Q.shape[0], mesh)
        if rows.stop == rows.start:
            return rows, torch.empty(0, dtype=torch.int32, device=Q.device)
        return rows, nearest(Q[rows], R, None if q_valid is None
                             else q_valid[rows], r_valid, two_dir=False)

    return (*one(X, Y, x_valid, y_valid), *one(Y, X, y_valid, x_valid))


def chamfer_loss_exact_sharded(X, Y, mesh, x_valid=None, y_valid=None,
                               use_kernel=True):
    """:func:`chamfer_loss_exact` under a ray mesh: the sweeps of
    :func:`nearest_idx_exact_sharded`, then the global (masked) means of
    :func:`..chamfer.gather_loss`. Every rank gets the global loss; its
    gradient is the rank's share (``parallel/mesh.py``)."""
    rx, idx_x, ry, idx_y = nearest_idx_exact_sharded(X, Y, mesh, x_valid,
                                                     y_valid, use_kernel)
    return gather_loss(X, Y, idx_x, idx_y, x_valid, y_valid, mesh=mesh,
                       rows=(rx, ry))
