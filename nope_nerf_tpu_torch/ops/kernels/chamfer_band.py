"""Kernel B: projection-guided banded Chamfer argmin (``chamfer_mode: band``).

Port of ``nope_nerf_tpu/ops/pallas/chamfer_band.py``. The clouds of the pc
loss are backprojected depth-map grids, so the nearest neighbour of a query
lies near the pixel row where it projects in the other view. Each group of
QB consecutive queries sweeps only a band of k_tiles * TILE rows of Y that
starts at the group's start tile (the nan-robust median of its projected
rows, :func:`band_start_tiles`).

* :func:`nearest_idx_banded` is the public wrapper: CUDA tensors launch the
  hand-written kernel (``csrc/chamfer_band.cu``'s split-band kernel,
  replacing the Pallas ``_band_kernel``) on X and Y as they are, and count
  it in :data:`LAUNCHES`; CPU tensors run
  :func:`nearest_idx_banded_reference`; any other device raises.
* Both compute the direct (x - y)^2 sum without FMAs and break ties toward
  the first occurrence, so they return identical indices on finite inputs
  (``torch.argmin`` of the plain version takes a NaN distance as the
  minimum; the kernel never picks one). The card tests hold the kernel bit
  for bit to a sequential sweep of the band in numpy, NaN and infinite rows
  included.
"""
from __future__ import annotations

import torch

from ..._build import c_function, check
from ...parallel.mesh import rank_rows
from ..chamfer import gather_loss
from . import LaunchCounter

TILE = 1024      # Y rows per band tile
QB = 1024        # queries per group (one start tile each)
_SENTINEL = 1e5  # padded X rows -> +S, padded Y rows -> -S (never win)

LAUNCHES = LaunchCounter("chamfer_band")


def band_start_tiles(row_hint, n_y, ws_y, k_tiles, qb=QB):
    """Per-query-group Y start TILE from per-query row hints.

    row_hint (S,) float (non-finite entries allowed: the per-group median of
    the finite ones is used) -> (ceil(S/qb),) int32 start tiles, clamped so
    start + k_tiles stays inside ceil(n_y/TILE) tiles.
    """
    S = row_hint.shape[0]
    Sp = -(-S // qb) * qb
    if Sp != S:
        pad = torch.full((Sp - S,), float("nan"), dtype=row_hint.dtype,
                         device=row_hint.device)
        row_hint = torch.cat([row_hint, pad])
    groups = row_hint.reshape(-1, qb)
    finite = torch.isfinite(groups)
    big = torch.where(finite, groups, torch.full_like(groups, 3.4e38))
    srt = torch.sort(big, dim=1).values
    n_fin = finite.sum(dim=1)
    med_i = torch.clamp((n_fin - 1) // 2, 0, qb - 1)
    med = torch.gather(srt, 1, med_i[:, None])[:, 0]
    med = torch.where(n_fin > 0, med, torch.zeros_like(med))
    centre_pt = med * ws_y
    n_tiles = -(-n_y // TILE)
    start = torch.round(centre_pt / TILE).to(torch.int32) - k_tiles // 2
    return torch.clamp(start, 0, max(n_tiles - k_tiles, 0)).to(torch.int32)


def rows_to_start_tiles(X_warped, Y_count, grid_hw, camera_mat,
                        project_to_cam, k_tiles):
    """Estimated Y-grid row per query -> per-group band start tiles.
    ``X_warped`` is in Y's camera frame; rows follow ``arange_pixels``
    (row = (y + 1) / 2 * (hs - 1))."""
    hs, ws = grid_hw
    xy, _ = project_to_cam(X_warped.detach(), camera_mat.detach())
    row = (xy[:, 1] + 1.0) * 0.5 * (hs - 1)
    return band_start_tiles(row, Y_count, ws, k_tiles)


def _prep(pts, n, sentinel):
    pad = n - pts.shape[0]
    if pad:
        fill = torch.full((pad, pts.shape[1]), sentinel, dtype=pts.dtype,
                          device=pts.device)
        pts = torch.cat([pts, fill])
    return pts


def _band_shapes(X, Y, k_tiles):
    S, D = X.shape[0], Y.shape[0]
    n_tiles = -(-D // TILE)
    k_tiles = min(k_tiles, n_tiles)
    Sp = -(-S // QB) * QB
    return S, n_tiles, k_tiles, Sp, n_tiles * TILE


def _sq_dist(xb, yb):
    """Direct squared distances (Q, W) as ((d0^2 + d1^2) + d2^2)."""
    d = xb[:, None, :] - yb[None, :, :]
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def nearest_idx_banded_reference(X, Y, starts, k_tiles):
    """Plain PyTorch version of :func:`nearest_idx_banded`: for each query
    group, argmin over Y[start*TILE : (start+k)*TILE] (first occurrence)."""
    X = X.detach()
    Y = Y.detach()
    S, n_tiles, k_tiles, Sp, Dp = _band_shapes(X, Y, k_tiles)
    Xp = _prep(X, Sp, _SENTINEL).reshape(-1, QB, 3)
    Yp = _prep(Y, Dp, -_SENTINEL)
    W = k_tiles * TILE
    out = []
    for g in range(Xp.shape[0]):
        s = min(max(int(starts[g]), 0), max(n_tiles - k_tiles, 0))
        yb = Yp[s * TILE: s * TILE + W]
        out.append(torch.argmin(_sq_dist(Xp[g], yb), dim=1) + s * TILE)
    return torch.cat(out).to(torch.int32)[:S]


def _check_cuda_inputs(X, Y, starts, k_tiles):
    """Raise on what the kernel cannot take; returns _band_shapes."""
    dev = X.device
    if Y.device != dev or starts.device != dev:
        raise ValueError("nearest_idx_banded: X, Y and starts must share "
                         "one device")
    if X.dtype != torch.float32 or Y.dtype != torch.float32:
        raise ValueError("nearest_idx_banded: X and Y must be float32")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != 3 or Y.shape[1] != 3:
        raise ValueError("nearest_idx_banded: X and Y must be (n, 3)")
    shapes = _band_shapes(X, Y, k_tiles)
    if starts.shape[0] != shapes[3] // QB:
        raise ValueError(f"starts must have {shapes[3] // QB} entries")
    return shapes


def nearest_idx_banded(X, Y, starts, k_tiles=8):
    """Banded one-direction NN: for each X query group, argmin over the
    k_tiles*TILE Y rows starting at its start tile. Forward-only.

    X (S, 3) queries (groups = consecutive QB rows); Y (D, 3) a row-major
    grid cloud; starts (ceil(S/QB),) int32 from :func:`band_start_tiles`.
    Returns (S,) int32 indices into Y.
    """
    dev = X.device
    if dev.type == "cpu":
        return nearest_idx_banded_reference(X, Y, starts, k_tiles)
    if dev.type != "cuda":
        raise ValueError(f"nearest_idx_banded: unsupported device {dev}")
    S, n_tiles, k_tiles, _, _ = _check_cuda_inputs(X, Y, starts, k_tiles)
    out = torch.empty(S, dtype=torch.int32, device=dev)
    if S == 0:
        return out
    Xc, Yc = X.detach().contiguous(), Y.detach().contiguous()
    st = starts.to(torch.int32).contiguous()
    err = c_function("nnt_band_argmin_split", "ppppiiiiiip")(
        Xc.data_ptr(), Yc.data_ptr(), st.data_ptr(), out.data_ptr(),
        S, Y.shape[0], n_tiles, k_tiles, TILE, QB,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "band_argmin_split")
    LAUNCHES.add()
    return out


def chamfer_loss_banded(X, Y, starts_x, starts_y, k_tiles=8,
                        use_kernel=True):
    """Symmetric Chamfer with the banded argmin (the kernel wrapper, or the
    plain version when not ``use_kernel``): gradient-free indices, then the
    differentiable distance to the gathered neighbour."""
    nearest = (nearest_idx_banded if use_kernel
               else nearest_idx_banded_reference)
    return gather_loss(X, Y, nearest(X, Y, starts_x, k_tiles),
                       nearest(Y, X, starts_y, k_tiles))


def nearest_idx_banded_sharded(X, Y, starts, mesh, k_tiles=8,
                               use_kernel=True):
    """Kernel B under a ray mesh (the JAX ``chamfer_loss_banded_sharded``'s
    sweeps): this rank's block of whole query groups of X, each with its
    own start, against the whole Y. X and Y are whole on every rank, so Y
    keeps its tile count and the indices are those of the unsharded sweep.
    Returns (the rank's rows of X, their int32 indices into Y)."""
    S = X.shape[0]
    groups = rank_rows(-(-S // QB), mesh)
    rows = slice(groups.start * QB, min(groups.stop * QB, S))
    if rows.stop <= rows.start:
        return rows, torch.empty(0, dtype=torch.int32, device=X.device)
    nearest = (nearest_idx_banded if use_kernel
               else nearest_idx_banded_reference)
    return rows, nearest(X[rows], Y, starts[groups], k_tiles)


def chamfer_loss_banded_sharded(X, Y, starts_x, starts_y, mesh, k_tiles=8,
                                use_kernel=True):
    """:func:`chamfer_loss_banded` under a ray mesh: each direction's
    rank-local sweep of :func:`nearest_idx_banded_sharded`, then the
    global means of :func:`..chamfer.gather_loss`. Every rank gets the
    global loss; its gradient is the rank's share (``parallel/mesh.py``)."""
    rx, idx_x = nearest_idx_banded_sharded(X, Y, starts_x, mesh, k_tiles,
                                           use_kernel)
    ry, idx_y = nearest_idx_banded_sharded(Y, X, starts_y, mesh, k_tiles,
                                           use_kernel)
    return gather_loss(X, Y, idx_x, idx_y, mesh=mesh, rows=(rx, ry))
