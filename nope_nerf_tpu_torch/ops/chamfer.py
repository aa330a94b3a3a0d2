"""Symmetric Chamfer distance: the exact plain version, the approximate
Morton-window ``grid`` mode and the ``auto`` rule (port of
``nope_nerf_tpu/ops/chamfer.py``).

The nearest-neighbour index is found without gradient, then the loss is
the differentiable distance to the gathered neighbour, as in the reference.
The exact mode's kernel (Kernel D) is :mod:`.kernels.chamfer_kernel`, the
banded mode's (Kernel B) :mod:`.kernels.chamfer_band`.
"""
from __future__ import annotations

import warnings

import torch

from ..parallel.mesh import mesh_mean, mesh_sums

# Cost laws of ``tpu.chamfer_mode: auto``: exact (Kernel D) grows with S*D,
# grid with S+D. Each constant is the mean of its law over two equal-cloud
# sizes measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W:
# Kernel D 1.020 ms at 32,400^2 pairs and 16.015 ms at 129,600^2; grid
# 4.122 ms at 2 x 32,400 points and 4.314 ms at 2 x 129,600 (grid's time is
# nearly flat there: the host issues its ~200 small ops). Equal clouds cross
# over at about 83,000 points.
_EXACT_MS_PER_PAIR = 9.6e-10
_GRID_MS_PER_POINT = 4.0e-5

BIG = 1e10        # Kernel D's carry init: a pair at or above it never wins
SENTINEL = 1e5    # invalid X points move to +SENTINEL, invalid Y to -SENTINEL
BLOCK_ROWS = 1024  # query rows per block of the plain exact search

_warned_auto = set()


def resolve_chamfer_mode(mode: str, n_x: int, n_y: int, n_devices: int = 1,
                         sharded_exact: bool = True,
                         hints_available: bool = False,
                         exact_ms_per_pair: float | None = None,
                         grid_ms_per_point: float | None = None) -> str:
    """Resolve ``'auto'`` to ``'band'`` / ``'exact'`` / ``'grid'`` from the
    cloud sizes: band whenever projection hints exist, otherwise the
    cheaper of exact (cost ~ n_x * n_y, divided by ``n_devices`` only when
    ``sharded_exact``) and grid (cost ~ n_x + n_y) by their cost laws.
    Picking the approximate grid warns once per size."""
    if mode != "auto":
        return mode
    if hints_available:
        return "band"
    eff_dev = max(int(n_devices), 1) if sharded_exact else 1
    exact_cost = (float(n_x) * float(n_y)
                  * (exact_ms_per_pair or _EXACT_MS_PER_PAIR) / eff_dev)
    grid_cost = (float(n_x) + float(n_y)) * (grid_ms_per_point
                                             or _GRID_MS_PER_POINT)
    if exact_cost <= grid_cost:
        return "exact"
    key = (n_x, n_y, eff_dev)
    if key not in _warned_auto:
        _warned_auto.add(key)
        warnings.warn(
            f"chamfer_mode 'auto' picked the APPROXIMATE Morton-window mode "
            f"for cloud sizes ({n_x}, {n_y}) (est. exact {exact_cost:.1f} ms "
            f"vs grid {grid_cost:.1f} ms); set tpu.chamfer_mode: exact to "
            "pin reference semantics.")
    return "grid"


# ---------------------------------------------------------------------------
# Exact mode (plain version; Kernel D computes the same indices)
# ---------------------------------------------------------------------------


def sentinel_prep(pts, valid, sentinel):
    """Move the points whose ``valid`` entry is not > 0 to ``sentinel``."""
    if valid is None:
        return pts
    return torch.where(valid[:, None] > 0.0, pts,
                       torch.full_like(pts, sentinel))


def nearest_one_direction(X, Y):
    """For every row of X, the first index j minimising the direct squared
    distance ``((x0 - y0)^2 + (x1 - y1)^2) + (x2 - y2)^2`` (no FMAs), or 0
    where no pair is below :data:`BIG` -- Kernel D's strict-``<`` carry
    from (BIG, 0). Blocked over BLOCK_ROWS query rows, so at most a few
    (BLOCK_ROWS, D) slabs are live."""
    X, Y = X.detach(), Y.detach()
    out = []
    for i in range(0, X.shape[0], BLOCK_ROWS):
        xb = X[i:i + BLOCK_ROWS]
        dist = None
        for c in range(3):
            d = xb[:, c:c + 1] - Y[:, c][None]
            dist = d * d if dist is None else dist + d * d
        dist.masked_fill_(~(dist < BIG), BIG)  # also turns nan into BIG
        out.append(torch.argmin(dist, dim=1))
    return torch.cat(out).to(torch.int32)


def nearest_idx(X, Y, x_valid=None, y_valid=None):
    """Exact nearest valid neighbour both ways: (idx_x (S,) into Y, idx_y
    (D,) into X), int32, no gradient. Invalid points move to the +-1e5
    sentinels, so they never win; indices at invalid rows are arbitrary
    (callers mask them)."""
    Xp = sentinel_prep(X.detach(), x_valid, SENTINEL)
    Yp = sentinel_prep(Y.detach(), y_valid, -SENTINEL)
    return nearest_one_direction(Xp, Yp), nearest_one_direction(Yp, Xp)


def _safe_dist(v):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 1e-24))


def gather_loss(X, Y, idx_x, idx_y, x_valid=None, y_valid=None, mesh=None,
                rows=(slice(None), slice(None))):
    """The differentiable half of every Chamfer mode: (masked) mean
    distance to the gathered neighbour, both directions summed.

    Under a ray mesh (``parallel/mesh.py``) X and Y are whole on every rank,
    ``idx_x`` / ``idx_y`` are the neighbours of this rank's rows ``rows =
    (slice of X, slice of Y)``, and the means are global: one all-reduce of
    the rank's parts, whose gradient is this rank's share."""
    rx, ry = rows
    dx = _safe_dist(X[rx] - Y[idx_x.long()])
    dy = _safe_dist(Y[ry] - X[idx_y.long()])

    def mean(d, valid, r, n):
        if valid is None:
            return mesh_mean(d, mesh, n)
        num, den = mesh_sums((torch.sum(d * valid[r]), torch.sum(valid[r])),
                             mesh)
        return num / torch.clamp_min(den, 1.0)

    return (mean(dx, x_valid, rx, X.shape[0])
            + mean(dy, y_valid, ry, Y.shape[0]))


def chamfer_loss(X, Y, x_valid=None, y_valid=None):
    """mean_x ||x - y_nn(x)|| + mean_y ||y - x_nn(y)|| with the exact plain
    search (validity-masked means when masks are given)."""
    idx_x, idx_y = nearest_idx(X, Y, x_valid, y_valid)
    return gather_loss(X, Y, idx_x, idx_y, x_valid, y_valid)


# ---------------------------------------------------------------------------
# Grid mode: approximate nearest neighbours in Morton-sorted windows
# ---------------------------------------------------------------------------


def _morton_code(P, lo, inv_extent, probe=0):
    """30-bit Morton code per point: each axis quantised to 10 bits (768
    bins with 0.3 extent of headroom for probe 1's origin shift) and
    interleaved; probe 1 also permutes the axes."""
    q = torch.clamp((((P - lo) * inv_extent + 0.3 * probe) * 768.0)
                    .to(torch.int64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    a, b, c = (0, 1, 2) if probe == 0 else (1, 2, 0)
    return (spread(q[:, c]) << 2) | (spread(q[:, b]) << 1) | spread(q[:, a])


def _window_direction(Xs, Ys, pos_sorted, window, block):
    """Nearest index into ``Ys`` for every row of ``Xs`` (both sorted),
    searching the ``window`` consecutive Ys centred on the median insertion
    rank of each ``block`` of consecutive Xs (score form, full f32)."""
    D = Ys.shape[0]
    nb = Xs.shape[0] // block
    mid = pos_sorted.reshape(nb, block)[:, block // 2]
    start = torch.clamp(mid - window // 2, 0, max(D - window, 0))
    widx = start[:, None] + torch.arange(window, device=Xs.device)[None]
    Yw = Ys[widx]                                        # (nb, W, 3)
    yy = torch.sum(Yw * Yw, dim=-1)
    scores = yy[:, None, :] - 2.0 * torch.bmm(Xs.reshape(nb, block, 3),
                                              Yw.transpose(1, 2))
    return (start[:, None] + torch.argmin(scores, dim=-1)).reshape(-1)


def _pad_rows(a, n):
    """Pad to a multiple of n rows by repeating the last row."""
    p = (-a.shape[0]) % n
    return torch.cat([a, a[-1:].expand(p, *a.shape[1:])]) if p else a


def _scatter_rows(values, mask, rank, size):
    """out[rank[i]] = values[i] where mask[i]; the other rows go to a slot
    past the end that is dropped (no host synchronisation)."""
    out = torch.zeros(size + 1, dtype=values.dtype, device=values.device)
    out.scatter_(0, torch.where(mask, rank, torch.full_like(rank, size)),
                 values)
    return out[:size]


def nearest_idx_window(X, Y, window: int = 512, block: int = 128):
    """APPROXIMATE nearest neighbours (``tpu.chamfer_mode: grid``): both
    clouds sorted along two Z-order curves, each query searching a window
    of Morton-consecutive candidates, the nearer of the two probes kept.
    One stable sort of the tagged concatenation of both clouds' codes per
    probe gives each point its rank in its own cloud and its insertion rank
    in the other. Returns (idx_x (S,) into Y, idx_y (D,) into X), int64,
    no gradient."""
    X, Y = X.detach(), Y.detach()
    S, D = X.shape[0], Y.shape[0]
    n2 = S + D
    dev = X.device
    allp = torch.cat([X, Y])
    lo = torch.amin(allp, dim=0)
    inv_extent = 1.0 / torch.clamp_min(torch.amax(allp, dim=0) - lo, 1e-12)
    p_pos = torch.arange(n2, device=dev)

    def one_probe(probe):
        comb = torch.cat([_morton_code(X, lo, inv_extent, probe) << 1,
                          (_morton_code(Y, lo, inv_extent, probe) << 1) | 1])
        pc = torch.sort(comb, stable=True).indices   # combined order -> concat idx
        is_x = pc < S
        i_rank = torch.cumsum(is_x, 0) - 1
        j_rank = torch.cumsum(~is_x, 0) - 1
        perm_x = _scatter_rows(pc, is_x, i_rank, S)
        perm_y = _scatter_rows(pc - S, ~is_x, j_rank, D)
        pos_x = _scatter_rows(p_pos - i_rank, is_x, i_rank, S)  # #Y before
        pos_y = _scatter_rows(p_pos - j_rank, ~is_x, j_rank, D)  # #X before
        Xs, Ys = X[perm_x], Y[perm_y]
        idx_xs = _window_direction(_pad_rows(Xs, block), Ys,
                                   _pad_rows(pos_x, block), min(window, D),
                                   block)[:S]
        idx_ys = _window_direction(_pad_rows(Ys, block), Xs,
                                   _pad_rows(pos_y, block), min(window, S),
                                   block)[:D]
        idx_x = torch.empty(S, dtype=torch.int64, device=dev)
        idx_y = torch.empty(D, dtype=torch.int64, device=dev)
        idx_x[perm_x] = perm_y[idx_xs]
        idx_y[perm_y] = perm_x[idx_ys]
        return idx_x, idx_y

    def d2(A, B, idx):
        diff = A - B[idx]
        return torch.sum(diff * diff, dim=-1)

    ix0, iy0 = one_probe(0)
    ix1, iy1 = one_probe(1)
    return (torch.where(d2(X, Y, ix0) <= d2(X, Y, ix1), ix0, ix1),
            torch.where(d2(Y, X, iy0) <= d2(Y, X, iy1), iy0, iy1))


def chamfer_loss_window(X, Y, window: int = 512, block: int = 128):
    """Symmetric Chamfer with the approximate Morton-window search."""
    idx_x, idx_y = nearest_idx_window(X, Y, window=window, block=block)
    return gather_loss(X, Y, idx_x, idx_y)
