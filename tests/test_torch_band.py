"""Kernel B's split-band design (``nope_nerf_tpu_torch/csrc/chamfer_band.cu``)
on the CPU: a numpy replay of its algorithm (no padded copies, Y's rows past
its end as the -1e5 sentinel row, the query tail masked, the band split in
contiguous parts, a running minimum per chunk of candidates, the first row
at the minimum found by a rescan, the parts merged in band order) against
the sequential strict '<' sweep of the per-query kernel it replaced over
the padded clouds, the port's plain version and the JAX package's Pallas
kernel in interpret mode. The card tests (tests/test_torch_cuda.py) hold
the kernel itself to the per-query one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TILE = QB = 1024
SENTINEL = np.float32(1e5)


def _sq_dist(x, y):
    """((x0-y0)^2 + (x1-y1)^2) + (x2-y2)^2 in f32, (Q, 3) x (W, 3) -> (Q, W);
    numpy rounds every operation, as the kernels' _rn intrinsics do."""
    with np.errstate(invalid="ignore", over="ignore"):
        d = x[:, None, :] - y[None, :, :]
        sq = d * d
        return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _band(n_y, start, k_tiles):
    n_tiles = -(-n_y // TILE)
    k = min(k_tiles, n_tiles)
    return min(max(int(start), 0), max(n_tiles - k, 0)), k


def split_kernel_replay(X, Y, starts, k_tiles, split=8, chunk=16):
    """The split-band kernel's algorithm, query group by query group."""
    S, D = len(X), len(Y)
    out = np.empty(S, np.int32)
    for g in range(-(-S // QB)):
        q = X[g * QB: min((g + 1) * QB, S)]            # the masked tail
        start, k = _band(D, starts[g], k_tiles)
        rows = start * TILE + np.arange(k * TILE)
        yb = np.where((rows < D)[:, None], Y[np.minimum(rows, D - 1)],
                      -SENTINEL)                        # sentinel rows
        d = _sq_dist(q, yb)
        best_all = np.full(len(q), np.inf, np.float32)
        idx_all = np.full(len(q), start * TILE, np.int64)
        part = k * TILE // split
        for s in range(split):
            ds = d[:, s * part:(s + 1) * part]
            mins = np.fmin.reduce(ds.reshape(len(q), -1, chunk), axis=2)
            best = np.full(len(q), np.inf, np.float32)
            first = np.full(len(q), -1)
            for c in range(mins.shape[1]):              # strict '<' on chunks
                better = mins[:, c] < best
                best = np.where(better, mins[:, c], best)
                first = np.where(better, c, first)
            idx = np.full(len(q), start * TILE, np.int64)
            for j in range(chunk - 1, -1, -1):          # the rescan
                col = np.clip(first * chunk + j, 0, part - 1)
                hit = (first >= 0) & (ds[np.arange(len(q)), col] == best)
                idx = np.where(hit, start * TILE + s * part + col, idx)
            better = best < best_all                    # the merge
            best_all = np.where(better, best, best_all)
            idx_all = np.where(better, idx, idx_all)
        out[g * QB: g * QB + len(q)] = idx_all
    return out


def sequential_sweep(X, Y, starts, k_tiles):
    """The per-query kernel: X padded with +1e5 rows, Y with -1e5 rows, one
    strict '<' sweep of each group's band in row order from +inf."""
    S, D = len(X), len(Y)
    n_tiles = -(-D // TILE)
    Xp = np.concatenate([X, np.full((-S % QB, 3), SENTINEL, np.float32)])
    Yp = np.concatenate([Y, np.full((n_tiles * TILE - D, 3), -SENTINEL,
                                    np.float32)])
    out = np.empty(len(Xp), np.int32)
    for g in range(len(Xp) // QB):
        start, k = _band(D, starts[g], k_tiles)
        d = _sq_dist(Xp[g * QB:(g + 1) * QB],
                     Yp[start * TILE:(start + k) * TILE])
        best = np.full(QB, np.inf, np.float32)
        idx = np.full(QB, start * TILE, np.int64)
        for j in range(d.shape[1]):
            better = d[:, j] < best
            best = np.where(better, d[:, j], best)
            idx = np.where(better, start * TILE + j, idx)
        out[g * QB:(g + 1) * QB] = idx
    return out[:S]


def _clouds(rng, S, D, special):
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


@pytest.mark.parametrize("S,D", [(100, 900), (1500, 2100), (2100, 1500)])
@pytest.mark.parametrize("special", [False, True])
def test_split_band_replay_equals_sequential_sweep(S, D, special):
    """Every k_tiles from 1 to past Y's tiles, starts clamped at both ends,
    and 4, 8 or 16 parts: the replay gives the sequential sweep's indices
    on every input, NaN and infinite rows included, and the plain
    version's on finite inputs."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    rng = np.random.default_rng(S + D + special)
    X, Y = _clouds(rng, S, D, special)
    n_tiles = -(-D // TILE)
    for k in sorted({1, 2, n_tiles, n_tiles + 1}):
        starts = rng.integers(-2, n_tiles + 2, size=-(-S // QB))
        want = sequential_sweep(X, Y, starts, k)
        for split in (4, 8, 16):
            got = split_kernel_replay(X, Y, starts, k, split=split)
            np.testing.assert_array_equal(got, want, err_msg=f"{k} {split}")
        if not special:
            plain = cb.nearest_idx_banded_reference(
                torch.from_numpy(X), torch.from_numpy(Y),
                torch.from_numpy(starts.astype(np.int32)), k)
            np.testing.assert_array_equal(plain.numpy(), want)


def test_split_band_replay_keeps_the_band_start_without_a_finite_distance():
    """Queries whose distances are all NaN or all +inf keep the first row
    of their band; so does the sequential sweep."""
    rng = np.random.default_rng(3)
    Y = rng.normal(size=(3000, 3)).astype(np.float32)
    X = np.full((1500, 3), np.nan, np.float32)
    X[1024:] = np.inf
    starts = np.array([1, 9])
    want = np.array([1024] * 1024 + [1024] * 476)
    np.testing.assert_array_equal(sequential_sweep(X, Y, starts, 2), want)
    np.testing.assert_array_equal(split_kernel_replay(X, Y, starts, 2), want)


def test_split_band_replay_equals_pallas_kernel():
    """On two warped depth-map clouds (the pc loss's inputs) the replay
    gives the indices of the Pallas kernel it replaces, run in interpret
    mode."""
    from nope_nerf_tpu.ops.pallas import chamfer_band as jcb

    hs, ws = 45, 60
    rng = np.random.default_rng(11)
    yy, xx = np.meshgrid(np.linspace(-1, 1, hs), np.linspace(-1, 1, ws),
                         indexing="ij")
    depth = 2.0 + 0.3 * np.sin(3 * xx) * np.cos(2 * yy)
    pts = np.stack([xx * depth, yy * depth, -depth], -1).reshape(-1, 3)
    X = (pts + 0.01 * rng.normal(size=pts.shape)).astype(np.float32)
    Y = (pts + 0.01 * rng.normal(size=pts.shape)).astype(np.float32)
    starts = np.array([0, 1, 2], np.int32)
    for k in (1, 2):
        jidx = jcb.nearest_idx_banded(jnp.asarray(X), jnp.asarray(Y),
                                      jnp.asarray(starts), k, interpret=True)
        np.testing.assert_array_equal(split_kernel_replay(X, Y, starts, k),
                                      np.asarray(jidx))
