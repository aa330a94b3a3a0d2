"""Kernel B's split-band design (``nope_nerf_tpu_torch/csrc/chamfer_band.cu``)
on the CPU: a numpy replay of its algorithm (no padded copies, Y's rows past
its end as the -1e5 sentinel row, the query tail masked, the band split in
contiguous parts, a running minimum per chunk of candidates, the first row
at the minimum found by a rescan, the parts merged in band order) against
the sequential strict '<' sweep over the padded clouds
(tests/_band_sweep.py), the port's plain version and the JAX package's
Pallas kernel in interpret mode. The card tests (tests/test_torch_cuda.py)
hold the kernel itself to the same sweep.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _band_sweep import (QB, SENTINEL, TILE, band, clouds, sequential_sweep,
                         sq_dist)

torch.set_num_threads(1)


def split_kernel_replay(X, Y, starts, k_tiles, split=8, chunk=16):
    """The split-band kernel's algorithm, query group by query group."""
    S, D = len(X), len(Y)
    out = np.empty(S, np.int32)
    for g in range(-(-S // QB)):
        q = X[g * QB: min((g + 1) * QB, S)]            # the masked tail
        start, k = band(D, starts[g], k_tiles)
        rows = start * TILE + np.arange(k * TILE)
        yb = np.where((rows < D)[:, None], Y[np.minimum(rows, D - 1)],
                      -SENTINEL)                        # sentinel rows
        d = sq_dist(q, yb)
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


@pytest.mark.parametrize("S,D", [(100, 900), (1500, 2100), (2100, 1500)])
@pytest.mark.parametrize("special", [False, True])
def test_split_band_replay_equals_sequential_sweep(S, D, special):
    """Every k_tiles from 1 to past Y's tiles, starts clamped at both ends,
    and 4, 8 or 16 parts: the replay gives the sequential sweep's indices
    on every input, NaN and infinite rows included, and the plain
    version's on finite inputs."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    rng = np.random.default_rng(S + D + special)
    X, Y = clouds(rng, S, D, special)
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
