"""Kernel B's semantics in numpy, shared by tests/test_torch_band.py (the
split-band design replayed on the CPU) and tests/test_torch_cuda.py (the
kernel on the card): the sequential strict '<' sweep of each query group's
band over the sentinel-padded clouds, and clouds with exact ties, NaN,
infinite and sentinel rows. No JAX, so the card tests can import it.
"""
import numpy as np

TILE = QB = 1024
SENTINEL = np.float32(1e5)


def sq_dist(x, y):
    """((x0-y0)^2 + (x1-y1)^2) + (x2-y2)^2 in f32, (Q, 3) x (W, 3) -> (Q, W);
    numpy rounds every operation, as the kernel's _rn intrinsics do."""
    with np.errstate(invalid="ignore", over="ignore"):
        d = x[:, None, :] - y[None, :, :]
        sq = d * d
        return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def band(n_y, start, k_tiles):
    """(the clamped start tile, the tiles swept) of a group's band."""
    n_tiles = -(-n_y // TILE)
    k = min(k_tiles, n_tiles)
    return min(max(int(start), 0), max(n_tiles - k, 0)), k


def sequential_sweep(X, Y, starts, k_tiles):
    """Kernel B's result by definition: X padded with +1e5 rows, Y with -1e5
    rows, one strict '<' sweep of each group's band in row order from +inf
    (so a NaN distance never wins and a query with no finite distance keeps
    its band's first row)."""
    S, D = len(X), len(Y)
    n_tiles = -(-D // TILE)
    Xp = np.concatenate([X, np.full((-S % QB, 3), SENTINEL, np.float32)])
    Yp = np.concatenate([Y, np.full((n_tiles * TILE - D, 3), -SENTINEL,
                                    np.float32)])
    out = np.empty(len(Xp), np.int32)
    for g in range(len(Xp) // QB):
        start, k = band(D, starts[g], k_tiles)
        d = sq_dist(Xp[g * QB:(g + 1) * QB],
                    Yp[start * TILE:(start + k) * TILE])
        best = np.full(QB, np.inf, np.float32)
        idx = np.full(QB, start * TILE, np.int64)
        for j in range(d.shape[1]):
            better = d[:, j] < best
            best = np.where(better, d[:, j], best)
            idx = np.where(better, start * TILE + j, idx)
        out[g * QB:(g + 1) * QB] = idx
    return out[:S]


def clouds(rng, S, D, special):
    """Normal clouds with duplicate rows of Y and queries on rows of Y
    (exact ties); with ``special`` NaN and infinite rows and entries in
    both and rows equal to the -1e5 sentinel."""
    X = rng.normal(size=(S, 3)).astype(np.float32)
    Y = rng.normal(size=(D, 3)).astype(np.float32)
    Y[rng.integers(0, D, D // 4)] = Y[rng.integers(0, D, D // 4)]
    X[: S // 8] = Y[rng.integers(0, D, S // 8)]
    if special:
        Y[rng.integers(0, D, 20)] = np.nan
        Y[rng.integers(0, D, 20), rng.integers(0, 3, 20)] = np.inf
        Y[rng.integers(0, D, 5)] = -SENTINEL
        X[rng.integers(0, S, 20)] = np.nan
        X[rng.integers(0, S, 20), 1] = -np.inf
        X[rng.integers(0, S, 5)] = np.inf
    return X, Y
