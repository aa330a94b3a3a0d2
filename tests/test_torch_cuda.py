"""Kernel tests of the PyTorch port that need a CUDA device (marker
``cuda``); without one they skip. On the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each hand-written kernel against its plain PyTorch version on the card, at
small shapes.
"""
import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp_min(torch.linalg.vector_norm(b), 1e-12))


def _kernel_a_inputs(dev, N, S, hidden, seed):
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = {"model": {"hidden_dim": hidden, "pos_enc_levels": 10,
                     "dir_enc_levels": 4}, "rendering": {"white_background": False}}
    rng = np.random.default_rng(seed)
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg, dev)
    rays = rng.normal(size=(N, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 4.0, size=(N, S)), axis=1)
    deltas = np.concatenate([np.diff(z, axis=1), np.full((N, 1), 1e10)], 1)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    geo = [t(np.broadcast_to(rng.normal(scale=0.1, size=3), (N, 3))),
           t(rays), t(-rays)]
    cots = [t(rng.normal(size=s) / N) for s in ((N, 3), (N, 1), (N, S))]
    return mk.collect_weights(params), geo, t(z), t(deltas), cots


@pytest.mark.parametrize("act,dist_alpha,white_bg,alpha_cot", [
    ("softplus", False, False, False),  # the stock step's regime
    ("relu", True, True, True),         # dist_alpha + white background
])
def test_kernel_a_matches_plain(dev, act, dist_alpha, white_bg, alpha_cot):
    """Forward at tests/test_pallas.py's bars (rgb atol 0.03, alpha rtol
    0.08 / atol 0.05), gradients at its relL2 0.02; one launch counted per
    direction."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    S = 32
    ws, geo, z, deltas, cots = _kernel_a_inputs(dev, 256, S, 64, 1)
    if not alpha_cot:
        cots[2] = torch.zeros_like(cots[2])
    static = (10, 4, act, not dist_alpha, dist_alpha, white_bg, S)
    results = []
    for fn in (mk.fused_mlp_composite, mk.fused_mlp_composite_reference):
        w = [x.clone().requires_grad_() for x in ws]
        g = [x.clone().requires_grad_() for x in geo]
        f0, b0 = mk.FWD_LAUNCHES.count, mk.BWD_LAUNCHES.count
        out = fn(w, *g, z, deltas, *static)
        grads = torch.autograd.grad(out, w + g, cots)
        launches = (mk.FWD_LAUNCHES.count - f0, mk.BWD_LAUNCHES.count - b0)
        results.append(([o.detach() for o in out], grads, launches))
    (ok, gk, lk), (orf, gr, lr) = results
    assert lk == (1, 1) and lr == (0, 0)
    torch.testing.assert_close(ok[0], orf[0], atol=0.03, rtol=0)
    torch.testing.assert_close(ok[2], orf[2], atol=0.05, rtol=0.08)
    assert float(torch.max(torch.abs(ok[1] - orf[1]))) < 0.03 * 4.0
    for i, (a, b) in enumerate(zip(gk, gr)):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) < 0.02, i


def test_kernel_a_two_frames_in_one_launch(dev):
    """Two frames' 1024 rays x 128 samples at the stock width (the batch of
    ``tpu.rays_per_step_multiplier`` 2: each frame's rays from its own
    camera centre) through ONE forward and ONE backward launch, against
    the plain version under the training step's cotangents (rgb and depth,
    none on alpha) at chip_smoke.py's bars: outputs max|err| 1e-3,
    gradients relL2 1e-2."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    N, S = 1024, 128
    frames = [_kernel_a_inputs(dev, N, S, 256, seed) for seed in (5, 6)]
    ws = frames[0][0]
    geo = [torch.cat([f[1][i] for f in frames]) for i in range(3)]
    z = torch.cat([f[2] for f in frames])
    deltas = torch.cat([f[3] for f in frames])
    cots = [torch.cat([f[4][0] for f in frames]),
            torch.cat([f[4][1] for f in frames]),
            torch.zeros((2 * N, S), device=dev)]
    static = (10, 4, "softplus", True, False, False, S)
    results = []
    for fn in (mk.fused_mlp_composite, mk.fused_mlp_composite_reference):
        w = [x.clone().requires_grad_() for x in ws]
        g = [x.clone().requires_grad_() for x in geo]
        f0, b0 = mk.FWD_LAUNCHES.count, mk.BWD_LAUNCHES.count
        out = fn(w, *g, z, deltas, *static)
        grads = torch.autograd.grad(out, w + g, cots)
        launches = (mk.FWD_LAUNCHES.count - f0, mk.BWD_LAUNCHES.count - b0)
        results.append(([o.detach() for o in out], grads, launches))
    (ok, gk, lk), (orf, gr, lr) = results
    assert lk == (1, 1) and lr == (0, 0)
    assert ok[0].shape == (2 * N, 3) and ok[2].shape == (2 * N, S)
    for a, b in zip(ok, orf):
        assert float(torch.max(torch.abs(a - b))) < 1e-3
    for i, (a, b) in enumerate(zip(gk, gr)):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) < 1e-2, i


def test_kernel_a_backward_is_deterministic(dev):
    """Split-K partial sums reduced in a fixed order: two backward passes
    give bitwise equal gradients."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, geo, z, deltas, cots = _kernel_a_inputs(dev, 128, 16, 64, 2)
    static = (10, 4, "softplus", True, False, False, 16)
    w = [x.clone().requires_grad_() for x in ws]
    out = mk.fused_mlp_composite(w, *geo, z, deltas, *static)
    g1 = torch.autograd.grad(out, w, cots, retain_graph=True)
    g2 = torch.autograd.grad(out, w, cots)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_kernel_a_rejects_other_dtypes(dev):
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, geo, z, deltas, _ = _kernel_a_inputs(dev, 64, 16, 32, 3)
    with pytest.raises(ValueError, match="f32"):
        mk.fused_mlp_composite(ws, *(g.double() for g in geo), z, deltas,
                               10, 4, "softplus", True, False, False, 16)


@pytest.mark.parametrize("S,D,k", [(3000, 5000, 2), (1024, 700, 8)])
def test_kernel_b_matches_plain(dev, S, D, k):
    """Identical indices, with padded query groups and k_tiles clamped to
    the tiles Y has."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    rng = np.random.default_rng(4)
    X = torch.tensor(rng.normal(size=(S, 3)), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.normal(size=(D, 3)), dtype=torch.float32, device=dev)
    groups = -(-S // cb.QB)
    starts = torch.tensor(rng.integers(0, 5, size=groups), dtype=torch.int32,
                          device=dev)
    n0 = cb.LAUNCHES.count
    idx = cb.nearest_idx_banded(X, Y, starts, k)
    assert cb.LAUNCHES.count == n0 + 1
    ref = cb.nearest_idx_banded_reference(X, Y, starts, k)
    assert idx.dtype == torch.int32 and idx.shape == (S,)
    assert torch.equal(idx, ref)


def _band_clouds(rng, S, D, special):
    """Normal X (S, 3) and Y (D, 3) with duplicate rows of Y and queries on
    rows of Y (exact ties); with ``special`` also NaN and infinite rows and
    entries in both, and rows equal to Y's -1e5 padding sentinel."""
    X = rng.normal(size=(S, 3)).astype(np.float32)
    Y = rng.normal(size=(D, 3)).astype(np.float32)
    Y[rng.integers(0, D, D // 4)] = Y[rng.integers(0, D, D // 4)]
    X[: S // 8] = Y[rng.integers(0, D, S // 8)]
    if special:
        Y[rng.integers(0, D, 20)] = np.nan
        Y[rng.integers(0, D, 20), rng.integers(0, 3, 20)] = np.inf
        Y[rng.integers(0, D, 5)] = -1e5
        X[rng.integers(0, S, 20)] = np.nan
        X[rng.integers(0, S, 20), 1] = -np.inf
        X[rng.integers(0, S, 5)] = np.inf
    return X, Y


# (S, D): S below one query group, ragged, several groups; Y ragged
BAND_SHAPES = [(100, 900), (1024, 3000), (3000, 5000), (5000, 4100)]


@pytest.mark.parametrize("S,D", BAND_SHAPES)
@pytest.mark.parametrize("special", [False, True])
def test_kernel_b_equals_per_query_kernel(dev, S, D, special):
    """The split-band kernel returns the per-query kernel's indices bit for
    bit, NaN and infinite rows included, and the plain version's on finite
    inputs, for k_tiles from 1 to all of Y's tiles (and past them) with
    starts clamped at both ends; one launch a call, the per-query kernel
    never on the wrapper's path."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    rng = np.random.default_rng(S + D + special)
    X, Y = (torch.tensor(a, device=dev) for a in _band_clouds(rng, S, D,
                                                               special))
    n_tiles = -(-D // cb.TILE)
    for k in sorted({1, 2, n_tiles, n_tiles + 3}):
        starts = torch.tensor(rng.integers(-2, n_tiles + 2,
                                           size=-(-S // cb.QB)),
                              dtype=torch.int32, device=dev)
        n0, p0 = cb.LAUNCHES.count, cb.PER_QUERY_LAUNCHES.count
        idx = cb.nearest_idx_banded(X, Y, starts, k)
        assert (cb.LAUNCHES.count, cb.PER_QUERY_LAUNCHES.count) == (n0 + 1,
                                                                    p0)
        old = cb._nearest_idx_banded_per_query(X, Y, starts, k)
        assert idx.dtype == torch.int32 and idx.shape == (S,)
        assert torch.equal(idx, old), k
        if not special:
            assert torch.equal(idx, cb.nearest_idx_banded_reference(
                X, Y, starts, k)), k


def test_kernel_b_all_nan_queries_keep_the_band_start(dev):
    """A query whose every distance is NaN keeps its band's first row, in
    both kernels."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    X = torch.full((1500, 3), float("nan"), device=dev)
    Y = torch.randn(5000, 3, device=dev)
    starts = torch.tensor([1, 9], dtype=torch.int32, device=dev)
    idx = cb.nearest_idx_banded(X, Y, starts, 2)
    want = torch.tensor([1024] * 1024 + [3 * 1024] * 476, dtype=torch.int32,
                        device=dev)
    assert torch.equal(idx, want)
    assert torch.equal(cb._nearest_idx_banded_per_query(X, Y, starts, 2),
                       want)


def test_kernel_b_rejects_what_it_cannot_take(dev):
    """Other dtypes, shapes, devices and start counts raise before any
    launch; an empty query set returns without one."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    X = torch.randn(1500, 3, device=dev)
    Y = torch.randn(2000, 3, device=dev)
    starts = torch.zeros(2, dtype=torch.int32, device=dev)
    n0 = cb.LAUNCHES.count
    for args in ((X.double(), Y, starts), (X, Y[:, :2], starts),
                 (X, Y.cpu(), starts), (X, Y, starts[:1])):
        with pytest.raises(ValueError):
            cb.nearest_idx_banded(*args, 2)
    empty = cb.nearest_idx_banded(X[:0], Y, starts[:0], 2)
    assert empty.shape == (0,) and cb.LAUNCHES.count == n0


def _kernel_c_inputs(dev, M, hidden, seed):
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = {"model": {"hidden_dim": hidden, "pos_enc_levels": 10,
                     "dir_enc_levels": 4}, "rendering": {"white_background": False}}
    rng = np.random.default_rng(seed)
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg, dev)
    d = rng.normal(size=(M, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    pts = t(rng.normal(size=(M, 3)))
    cots = [t(rng.normal(size=s) / M) for s in ((M, 3), (M, 1))]
    return mk.collect_weights(params), [pts, t(d)], cots


@pytest.mark.parametrize("act,occ_alpha", [("softplus", True),
                                           ("softplus", False),
                                           ("relu", True), ("relu", False)])
def test_kernel_c_matches_plain(dev, act, occ_alpha):
    """Kernel C against its plain version over the four head-activation
    branches on a ragged batch (1500 points): forward at tests/
    test_pallas.py's bars (rgb atol 0.03, density rtol 0.08 / atol 0.05),
    gradients at its relL2 0.02; one launch counted per direction."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, ins, cots = _kernel_c_inputs(dev, 1500, 64, 5)
    results = []
    for fn in (mk.fused_mlp, mk.fused_mlp_reference):
        w = [x.clone().requires_grad_() for x in ws]
        x = [a.clone().requires_grad_() for a in ins]
        f0 = (mk.FWD_POINT_LAUNCHES.count, mk.BWD_POINT_LAUNCHES.count)
        out = fn(w, *x, 10, 4, act, occ_alpha)
        grads = torch.autograd.grad(out, w + x, cots)
        launches = (mk.FWD_POINT_LAUNCHES.count - f0[0],
                    mk.BWD_POINT_LAUNCHES.count - f0[1])
        results.append(([o.detach() for o in out], grads, launches))
    (ok, gk, lk), (orf, gr, lr) = results
    assert lk == (1, 1) and lr == (0, 0)
    assert ok[0].shape == (1500, 3) and ok[1].shape == (1500, 1)
    torch.testing.assert_close(ok[0], orf[0], atol=0.03, rtol=0)
    torch.testing.assert_close(ok[1], orf[1], atol=0.05, rtol=0.08)
    for i, (a, b) in enumerate(zip(gk, gr)):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) < 0.02, i


def test_kernel_c_backward_is_deterministic(dev):
    """Two backward passes of Kernel C give bitwise equal weight
    gradients."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, ins, cots = _kernel_c_inputs(dev, 2048, 64, 6)
    w = [x.clone().requires_grad_() for x in ws]
    out = mk.fused_mlp(w, *ins, 10, 4, "softplus", True)
    g1 = torch.autograd.grad(out, w, cots, retain_graph=True)
    g2 = torch.autograd.grad(out, w, cots)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def _kernel_call(dev, kernel):
    """(fn(weights, inputs) -> outputs, weights, inputs, cotangents) of
    Kernel A (256 rays x 32 samples) or Kernel C (1500 points), width 64."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    if kernel == "A":
        ws, geo, z, deltas, cots = _kernel_a_inputs(dev, 256, 32, 64, 7)
        static = (10, 4, "softplus", True, False, False, 32)
        cots[2] = torch.zeros_like(cots[2])
        return (lambda w, x: mk.fused_mlp_composite(w, *x, z, deltas, *static),
                ws, geo, cots)
    ws, ins, cots = _kernel_c_inputs(dev, 1500, 64, 8)
    return (lambda w, x: mk.fused_mlp(w, *x, 10, 4, "softplus", True), ws,
            ins, cots)


@pytest.mark.parametrize("kernel", ["A", "C"])
def test_forward_without_graph_saves_nothing(dev, kernel):
    """With nothing to differentiate (no input requires grad, or grad
    disabled) the fused forward stores nothing but its outputs and builds
    no graph; its outputs equal the saving forward's bit for bit, and it
    counts one launch."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    fn, ws, ins, _ = _kernel_call(dev, kernel)
    counter = mk.FWD_LAUNCHES if kernel == "A" else mk.FWD_POINT_LAUNCHES
    w = [x.clone().requires_grad_() for x in ws]
    saving = fn(w, ins)
    n0 = counter.count
    plain_inputs = fn(ws, ins)
    with torch.no_grad():
        no_grad = fn(w, ins)
    assert counter.count == n0 + 2
    assert saving[0].grad_fn is not None
    for outs in (plain_inputs, no_grad):
        assert all(o.grad_fn is None for o in outs)
        for a, b in zip(outs, saving):
            assert torch.equal(a, b.detach())


@pytest.mark.parametrize("kernel", ["A", "C"])
def test_input_only_backward_is_bitwise(dev, kernel):
    """When no weight needs a gradient (test-time pose optimisation), the
    backward runs its ten fused passes with their weight-gradient half off
    and none of the launches that serve only the weight gradients, and
    returns the input gradients of the full backward bit for bit; the
    layer-by-layer GEMMs never run."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    fn, ws, ins, cots = _kernel_call(dev, kernel)
    x = [a.clone().requires_grad_() for a in ins]
    w = [a.clone().requires_grad_() for a in ws]
    counters = (mk.WGRAD_LAUNCHES, mk.MLP_FUSED_BWD_LAUNCHES,
                mk.GEMM_WGRAD_LAUNCHES, mk.GEMM_DGRAD_LAUNCHES,
                mk.GEMM_NN_LAUNCHES)
    n0 = [c.count for c in counters]
    full = torch.autograd.grad(fn(w, x), x + w, cots)
    n1 = [c.count for c in counters]
    inputs_only = torch.autograd.grad(fn(ws, x), x, cots)
    n2 = [c.count for c in counters]
    assert [b - a for a, b in zip(n0, n1)] == [
        mk.WGRAD_PER_BWD[kernel], mk.FUSED_BWD_PER_BWD, 0, 0, 0]
    assert [b - a for a, b in zip(n1, n2)] == [
        0, mk.FUSED_BWD_PER_BWD, 0, 0, 0]
    for a, b in zip(inputs_only, full[:len(x)]):
        assert torch.equal(a, b)


# the fused forward (csrc/mlp_fused_fwd.cu): (samples a ray, hidden width,
# density activation, dist_alpha, white_bg) -- the stock shape, the recovery
# scripts' (hidden 128, 64 samples), and S = 96, which does not tile 128
# points and takes the raw route (composite_fwd after the fused kernel)
FUSED_CASES = [(128, 256, "softplus", False, False),
               (64, 128, "relu", True, True),
               (96, 64, "softplus", True, False)]


def _fused_inputs(dev, S, D, seed):
    """Kernel A's inputs at S samples and width D, rays chosen so that the
    last 128-point tile is partial (A), and the same points for Kernel C."""
    N = {128: 37, 64: 101, 96: 77}[S]
    ws, geo, z, deltas, cots = _kernel_a_inputs(dev, N, S, D, seed)
    geo = [g.contiguous() for g in geo]  # as fused_mlp_composite passes them
    o, r, d = geo
    pts = (o[:, None, :] + r[:, None, :] * z[..., None]).reshape(-1, 3)
    pdirs = d[:, None, :].expand(N, S, 3).reshape(-1, 3).contiguous()
    return ws, geo, z, deltas, cots, pts, pdirs


@pytest.mark.parametrize("S,D,act,dist_alpha,white_bg", FUSED_CASES)
def test_fused_forward_matches_plain(dev, S, D, act, dist_alpha, white_bg):
    """Kernel A's and Kernel C's fused forwards against their plain
    versions at chip_smoke.py's bars (max|err| 1e-3), one fused launch
    each (A's raw route adds composite_fwd), and Kernel C + the plain
    compositing against Kernel A within 2e-5 (rgb, alpha)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.rendering import composite

    ws, geo, z, deltas, _, pts, pdirs = _fused_inputs(dev, S, D, 11)
    N = z.shape[0]
    static = (10, 4, act, not dist_alpha, dist_alpha, white_bg, S)
    counters = (mk.MLP_FUSED_FWD_LAUNCHES, mk.COMPOSITE_AFTER_LAUNCHES,
                mk.GEMM_SM90_LAUNCHES)
    n0 = [c.count for c in counters]
    with torch.no_grad():
        a = mk.fused_mlp_composite(ws, *geo, z, deltas, *static)
        c = mk.fused_mlp(ws, pts, pdirs, 10, 4, act, not dist_alpha)
    n1 = [c_.count - n for c_, n in zip(counters, n0)]
    assert n1 == [2, int(S == 96), 0]
    a_ref = mk.fused_mlp_composite_reference(ws, *geo, z, deltas, *static)
    c_ref = mk.fused_mlp_reference(ws, pts, pdirs, 10, 4, act,
                                   not dist_alpha)
    for x, y in zip((*a, *c), (*a_ref, *c_ref)):
        assert x.shape == y.shape and torch.isfinite(x).all()
        assert float(torch.max(torch.abs(x - y))) <= 1e-3
    if not dist_alpha:  # C's density is then A's alpha
        rgbv, _, _ = composite(c[0].reshape(N, S, 3), c[1].reshape(N, S), z,
                               white_background=white_bg)
        assert float(torch.max(torch.abs(rgbv - a[0]))) <= 2e-5
        assert float(torch.max(torch.abs(c[1].reshape(N, S) - a[2]))) <= 2e-5


@pytest.mark.parametrize("S,D,act,dist_alpha,white_bg", FUSED_CASES)
def test_fused_saves_equal_the_layer_by_layer_forward(dev, S, D, act,
                                                      dist_alpha, white_bg):
    """The saving fused forward against the layer-by-layer one it replaced
    (encodings, _chain_fwd's GEMMs, heads, compositing): outputs and every
    tensor the backward reads (enc, denc at their true widths, feat, hr,
    raw, the 8 trunk outputs) bit for bit, in the same shapes, dtypes and
    strides."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, geo, z, deltas, _, pts, pdirs = _fused_inputs(dev, S, D, 12)
    cfg_a = (10, 4, act, not dist_alpha, dist_alpha, white_bg, S)
    cfg_c = (10, 4, act, not dist_alpha)
    runs = [(mk._composite_fwd, mk._composite_fwd_layered,
             (*geo, z, deltas, cfg_a), 5),
            (mk._point_fwd, mk._point_fwd_layered, (pts, pdirs, cfg_c), 2)]
    for fused, layered, args, first in runs:
        out_f, dims, sav_f = fused(*args, ws, save=True)
        out_l, _, sav_l = layered(*args, ws, save=True)
        n_pos, n_dir = dims[:2]
        for x, y in zip(out_f, out_l):
            assert torch.equal(x, y)
        for i, (x, y) in enumerate(zip(sav_f[first:first + 13],
                                       sav_l[first:first + 13])):
            assert (x.shape, x.dtype, x.stride()) == (y.shape, y.dtype,
                                                      y.stride()), i
            width = {0: n_pos, 1: n_dir}.get(i, x.shape[1])
            assert torch.equal(x[:, :width], y[:, :width]), i


@pytest.mark.parametrize("kernel", ["A", "C"])
def test_fused_forward_gradients_match_plain(dev, kernel):
    """The fused forward + the unchanged backward at the recovery scripts'
    shape (hidden 128, 64 samples) against the plain version under the
    training step's cotangents: gradients within chip_smoke.py's relL2
    1e-2."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, geo, z, deltas, cots, pts, pdirs = _fused_inputs(dev, 64, 128, 13)
    if kernel == "A":
        static = (10, 4, "softplus", True, False, False, 64)
        cots[2] = torch.zeros_like(cots[2])

        def fn(f, w, x):
            return f(w, *x, z, deltas, *static)
        ins, fns = geo, (mk.fused_mlp_composite,
                         mk.fused_mlp_composite_reference)
    else:
        gen = np.random.default_rng(13)
        cots = [torch.tensor(gen.normal(size=s) / s[0], dtype=torch.float32,
                             device=dev) for s in ((pts.shape[0], 3),
                                                   (pts.shape[0], 1))]

        def fn(f, w, x):
            return f(w, *x, 10, 4, "softplus", True)
        ins, fns = (pts, pdirs), (mk.fused_mlp, mk.fused_mlp_reference)
    grads = []
    for f in fns:
        w = [t.clone().requires_grad_() for t in ws]
        x = [t.clone().requires_grad_() for t in ins]
        grads.append(torch.autograd.grad(fn(f, w, x), x + w, cots))
    for i, (a, b) in enumerate(zip(*grads)):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) < 1e-2, i


def test_fused_forward_captured_equals_eager(dev):
    """The fused forward captured in a CUDA graph (the training step's
    route) replays the eager call's outputs and saves bit for bit, and the
    capture records one fused launch."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, geo, z, deltas, _, _, _ = _fused_inputs(dev, 128, 256, 14)
    cfg = (10, 4, "softplus", True, False, False, 128)

    def run():  # the encodings at their true widths (the padding is unset)
        outs, _, saved = mk._composite_fwd(*geo, z, deltas, cfg, ws,
                                           save=True)
        return [*outs, saved[5][:, :63], saved[6][:, :27], *saved[7:18]]

    eager = [t.clone() for t in run()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    c0 = mk.MLP_FUSED_FWD_LAUNCHES.captured
    with torch.cuda.graph(graph):
        captured = run()
    assert mk.MLP_FUSED_FWD_LAUNCHES.captured == c0 + 1
    for t in captured:
        t.fill_(float("nan")) if t.dtype == torch.float32 else t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(captured, eager)):
        assert torch.equal(a, b), i


def test_fused_forward_rejects_what_it_cannot_take(dev):
    """Widths, encodings and routes the fused kernel does not take raise;
    nothing falls back to the layer-by-layer forward."""
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, geo, z, deltas, _, pts, pdirs = _fused_inputs(dev, 96, 64, 15)
    cfg = {"model": {"hidden_dim": 96, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    w96 = mk.collect_weights(init_nerf_params(torch.Generator().manual_seed(0),
                                              cfg, dev))
    cfg["model"].update(hidden_dim=64, pos_enc_levels=11)
    w11 = mk.collect_weights(init_nerf_params(torch.Generator().manual_seed(0),
                                              cfg, dev))
    counters = (mk.MLP_FUSED_FWD_LAUNCHES, mk.GEMM_SM90_LAUNCHES)
    n0 = [c.count for c in counters]
    with pytest.raises(ValueError, match="hidden width"):
        mk.fused_mlp(w96, pts, pdirs, 10, 4, "softplus", True)
    with pytest.raises(ValueError, match="encodings"):
        mk.fused_mlp(w11, pts, pdirs, 11, 4, "softplus", True)
    Wt, _, Wh, Bs = mk._kernel_weights(ws, False)
    dims = mk._dims(ws, 10, 4)
    N, S = z.shape
    outs = [torch.empty(s, device=dev) for s in ((N, 3), (N, 1), (N, S))]
    with pytest.raises(ValueError, match="raw route"):
        mk.fused_fwd(Wt, Wh, Bs, dims, mk.MODE_COMPOSITE, (10, 4), S,
                     (*geo, z, deltas), outs, (1, 1, 0, 0))
    with pytest.raises(ValueError, match="contiguous"):
        mk.fused_fwd(Wt, Wh, Bs, dims, mk.MODE_POINTS, (10, 4), 1,
                     (pts.double(), None, pdirs, None, None),
                     (outs[0], outs[1], None), (1, 1, 0, 0))
    with pytest.raises(ValueError, match="write raw"):
        mk.fused_fwd(Wt, Wh, Bs, dims, mk.MODE_RAW, (10, 4), S,
                     (*geo, z, deltas), (None,) * 3, (1, 1, 0, 0))
    assert [c.count for c in counters] == n0


@pytest.mark.parametrize("S,D,masked", [(1500, 2100, False),
                                        (1024, 700, False),
                                        (1500, 2100, True)])
def test_kernel_d_matches_plain(dev, S, D, masked):
    """Kernel D gives the plain version's indices, both directions, on
    ragged sizes and with validity masks; one launch per direction."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck

    rng = np.random.default_rng(7)
    X = torch.tensor(rng.normal(size=(S, 3)), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.normal(size=(D, 3)), dtype=torch.float32, device=dev)
    masks = (None, None)
    if masked:
        masks = tuple(torch.tensor((rng.uniform(size=n) > 0.3).astype(
            np.float32), device=dev) for n in (S, D))
    n0 = ck.LAUNCHES.count
    idx = ck.nearest_idx_exact(X, Y, *masks)
    assert ck.LAUNCHES.count == n0 + 2
    ref = ck.nearest_idx_exact_reference(X, Y, *masks)
    for a, b, n in zip(idx, ref, (S, D)):
        assert a.dtype == torch.int32 and a.shape == (n,)
        assert torch.equal(a, b)


def _ulps(out, ref):
    """max |out - ref| in bf16 ulps of max(|ref|, |out|, max|ref| / 256):
    below max|ref| / 256 a value is a cancellation whose f32 order error is
    set by its terms, not by the value."""
    out, ref = out.float(), ref.float()
    mag = torch.maximum(torch.maximum(ref.abs(), out.abs()),
                        ref.abs().max() / 256)
    return float(torch.max((out - ref).abs()
                           / torch.exp2(torch.floor(torch.log2(mag)) - 7)))


def _nan_padded(dev, gen, rows, k):
    """bf16 (rows, k) normal values in a buffer padded to 8 columns of NaN:
    the kernel must read only the true width."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    buf = torch.full((rows, mk._pad8(k)), float("nan"), dtype=torch.bfloat16,
                     device=dev)
    buf[:, :k] = torch.randn((rows, k), generator=gen, device=dev)
    return buf[:, :k]


@pytest.mark.parametrize("M", [1000, 131072])
@pytest.mark.parametrize("k1,k2,n,rowterm,relu", [
    (63, 0, 256, False, True),    # trunk0_0
    (256, 0, 256, False, True),   # trunk0_1..3, trunk1_1..3
    (256, 63, 256, False, True),  # trunk1_0: A2 is the position encoding
    (256, 0, 256, False, False),  # fc_feature
    (256, 0, 128, True, True),    # rgb_layer + the direction row term
    (64, 63, 64, False, True),    # hidden 64
    (64, 0, 32, True, True),      # hidden 64's rgb_layer
])
def test_gemm_sm90_matches_reference(dev, M, k1, k2, n, rowterm, relu):
    """The forward GEMM against gemm_fwd_reference at every forward layer
    shape, ragged and stock M: at most one bf16 ulp (the f32 sums differ in
    order only), the row term to 1e-5, finite (the NaN padding is never
    read), bitwise equal on a second run; one launch counted per call."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(M + k1 + k2 + n)
    w = torch.randn((k1 + k2, n), generator=gen, device=dev) * (k1 + k2) ** -0.5
    b = torch.randn((n,), generator=gen, device=dev) * 0.1
    wt = mk._padded_t(w)
    a1 = _nan_padded(dev, gen, M, k1)
    a2 = _nan_padded(dev, gen, M, k2) if k2 else None
    two = dict(a2=a2, w2t=wt[:, k1:k1 + k2]) if k2 else {}
    rt, div = None, 1
    if rowterm:
        div = 128
        denc = _nan_padded(dev, gen, -(-M // div), 27)
        wd = torch.randn((27, n), generator=gen, device=dev) * 0.2
        rt = mk.gemm_fwd(denc, mk._padded_t(wd)[:, :27], out=torch.empty(
            (denc.shape[0], n), dtype=torch.float32, device=dev))
        want = mk.gemm_fwd_reference(denc.float(), wd,
                                     out_dtype=torch.float32)
        assert float(torch.max(torch.abs(rt - want))) <= 1e-5
    n0 = mk.GEMM_SM90_LAUNCHES.count
    outs = [mk.gemm_fwd(a1, wt[:, :k1], bias=b, relu=relu, rowterm=rt,
                        div=div, **two) for _ in range(2)]
    assert mk.GEMM_SM90_LAUNCHES.count == n0 + 2
    ref = mk.gemm_fwd_reference(a1.float(), w[:k1],
                                None if a2 is None else a2.float(),
                                w[k1:] if k2 else None, b, relu, rt, div)
    assert outs[0].dtype == torch.bfloat16 and outs[0].shape == (M, n)
    assert torch.isfinite(outs[0].float()).all()
    assert torch.equal(outs[0], outs[1])
    assert _ulps(outs[0], ref) <= 1.0


def test_gemm_sm90_rejects_what_it_cannot_take(dev):
    """An operand the kernel cannot take raises; nothing falls back."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(0)
    a = _nan_padded(dev, gen, 256, 64)
    wt = mk._padded_t(torch.randn((64, 256), device=dev))
    n0 = mk.GEMM_SM90_LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte"):
        mk.gemm_fwd(a[:, 1:], wt[:, 1:])  # misaligned base address
    with pytest.raises(ValueError, match="widths"):
        mk.gemm_fwd(a, mk._padded_t(torch.randn((64, 48), device=dev)))
    with pytest.raises(ValueError, match="bf16"):
        mk.gemm_fwd(a.float(), wt)
    with pytest.raises(ValueError, match="rowterm"):  # wider than 128
        mk.gemm_fwd(a, wt, rowterm=torch.zeros((256, 256), device=dev))
    assert mk.GEMM_SM90_LAUNCHES.count == n0


# the backward's input-gradient GEMMs: (K, N, output, ReLU mask, fc_density's
# rank-1 term, column sums) at the stock widths and at hidden 64
DGRAD_SHAPES = [
    (128, 256, "bf16", False, False, True),  # rgb_layer -> feat
    (128, 27, "f32", False, False, False),   # rgb_layer -> direction encoding
    (256, 256, "bf16", True, True, True),    # fc_feature + fc_density
    (256, 256, "bf16", True, False, True),   # trunk1_3 .. trunk0_1
    (256, 63, "f32", False, False, False),   # trunk1_0 -> enc, trunk0_0
    (64, 64, "bf16", True, True, True),      # hidden 64
    (32, 64, "bf16", False, False, True),    # hidden 64's rgb_layer -> feat
    (64, 63, "f32", False, False, False),
]


@pytest.mark.parametrize("M", [1000, 131072])
@pytest.mark.parametrize("K,N,odt,masked,rank1,sums", DGRAD_SHAPES)
def test_gemm_dgrad_matches_reference(dev, M, K, N, odt, masked, rank1,
                                      sums):
    """The input-gradient GEMM against gemm_dgrad_reference at every
    backward layer shape, ragged and stock M: bf16 outputs within one bf16
    ulp of the rounded reference, f32 outputs and the column sums to relL2
    1e-5 (f32 order only), finite (the NaN row padding is never read; rows
    past M add nothing to the sums), bitwise equal on a second run; one
    launch counted per call."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    dtype = torch.bfloat16 if odt == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    a = _nan_padded(dev, gen, M, K)
    w = mk._padded(torch.randn((N, K), generator=gen, device=dev) * K ** -0.5)
    mask = _nan_padded(dev, gen, M, N) if masked else None
    g_raw = torch.randn((M, 4), generator=gen, device=dev)
    wd = torch.randn((N,), generator=gen, device=dev).to(torch.bfloat16)
    extra = dict(gsig=g_raw[:, 0], wd=wd) if rank1 else {}
    n0 = mk.GEMM_DGRAD_LAUNCHES.count
    outs = []
    for _ in range(2):
        out = torch.empty((M, mk._pad8(N)), dtype=dtype, device=dev)[:, :N]
        outs.append(mk.gemm_dgrad(a, w, out, mask=mask, colsum=sums,
                                  **extra))
    assert mk.GEMM_DGRAD_LAUNCHES.count == n0 + 2
    ref = mk.gemm_dgrad_reference(
        a.float(), w.float(), None if mask is None else mask.float(),
        g_raw[:, 0] if rank1 else None, wd.float() if rank1 else None)
    (got, s1), (again, s2) = outs
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    if dtype == torch.bfloat16:
        assert _ulps(got, ref.to(dtype)) <= 1.0
    else:
        assert _rel_l2(got, ref) <= 1e-5
    if sums:
        assert s1.shape == (N,) and torch.equal(s1, s2)
        assert _rel_l2(s1, ref.sum(0)) <= 1e-5
    else:
        assert s1 is None


@pytest.mark.parametrize("M", [1000, 131072])
@pytest.mark.parametrize("K,N", [(256, 256), (63, 256), (256, 128),
                                 (27, 128), (64, 64), (63, 64), (64, 32)])
def test_gemm_wgrad_matches_reference(dev, M, K, N):
    """The weight-gradient GEMM (MN-major wgmma operands) against
    gemm_wgrad_reference at every backward layer shape, ragged and stock M:
    relL2 1e-5 (f32 order only), finite (the NaN padding of a 63- or 27-wide
    activation is never read), bitwise equal on a second run, written into a
    row slice of a larger dW; one launch counted per call."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(M + K + N + 1)
    x = _nan_padded(dev, gen, M, K)
    g = _nan_padded(dev, gen, M, N)
    n0 = mk.GEMM_WGRAD_LAUNCHES.count
    big = torch.full((K + 8, N), float("nan"), device=dev)
    got = mk.gemm_wgrad(x, g, big[8:])
    again = mk.gemm_wgrad(x, g)
    assert mk.GEMM_WGRAD_LAUNCHES.count == n0 + 2
    assert torch.isnan(big[:8]).all() and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel_l2(got, mk.gemm_wgrad_reference(x.float(), g.float())) <= 1e-5


@pytest.mark.parametrize("rays,S,N", [(1024, 128, 128), (37, 8, 32)])
def test_dir_weight_grad_and_heads_bwd_match_plain(dev, rays, S, N):
    """Kernel A's per-ray direction weight gradient, the rgb head's
    backward (bf16 cotangent + column sums) and the narrow heads' weight
    gradients (g_raw's f32 columns) against their plain versions:
    f32 order only (relL2 1e-5, the bf16 g_hr within one ulp), bitwise on a
    rerun."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(rays + S)
    M = rays * S
    denc = _nan_padded(dev, gen, rays, 27)
    g = _nan_padded(dev, gen, M, N)
    got = [mk.dir_weight_grad(denc, g, S, torch.empty((27, N), device=dev))
           for _ in range(2)]
    assert torch.equal(got[0], got[1])
    assert _rel_l2(got[0], mk.dir_weight_grad_reference(denc, g, S)) <= 1e-5

    g_raw = torch.randn((M, 4), generator=gen, device=dev)
    hr = torch.randn((M, N), generator=gen, device=dev).relu().to(
        torch.bfloat16)
    wc = torch.randn((N, 3), generator=gen, device=dev).to(torch.bfloat16)
    outs = [mk.heads_bwd(g_raw, hr, wc, torch.empty_like(hr), colsum=True)
            for _ in range(2)]
    ref = mk.heads_bwd_reference(g_raw, hr.float(), wc.float())
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert _ulps(outs[0][0], ref.to(torch.bfloat16)) <= 1.0
    assert _rel_l2(outs[0][1], ref.sum(0)) <= 1e-5

    for x, cols in ((hr, slice(1, 4)), (g, slice(0, 1))):  # fc_rgb, fc_density
        got = [mk.head_weight_grad(x, g_raw[:, cols]) for _ in range(2)]
        assert torch.equal(got[0], got[1])
        assert _rel_l2(got[0], mk.gemm_wgrad_reference(
            x.float(), g_raw[:, cols])) <= 1e-5


def test_backward_gemms_reject_what_they_cannot_take(dev):
    """An operand the backward GEMMs cannot take raises; nothing falls
    back, and nothing is counted."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(0)
    a = _nan_padded(dev, gen, 256, 64)
    w = mk._padded(torch.randn((64, 64), device=dev))
    out = torch.empty((256, 64), dtype=torch.bfloat16, device=dev)
    counters = (mk.GEMM_DGRAD_LAUNCHES, mk.GEMM_WGRAD_LAUNCHES)
    n0 = [c.count for c in counters]
    with pytest.raises(ValueError, match="16-byte"):
        mk.gemm_dgrad(a[:, 1:], w[:, 1:], out)  # misaligned base address
    with pytest.raises(ValueError, match="bf16"):
        mk.gemm_dgrad(a.float(), w, out)
    with pytest.raises(ValueError, match="no GEMM tile"):
        mk.gemm_dgrad(a, mk._padded(torch.randn((256, 64), device=dev)),
                      torch.empty((256, 256), device=dev))  # f32 is <= 128
    with pytest.raises(ValueError, match="mask"):  # a mask of an f32 output
        mk.gemm_dgrad(a, w, torch.empty((256, 64), device=dev), mask=out)
    with pytest.raises(ValueError, match="column sums"):
        mk.gemm_dgrad(a, w[:63], torch.empty(
            (256, 64), dtype=torch.bfloat16, device=dev)[:, :63], colsum=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        mk.gemm_wgrad(a, torch.empty((256, 27), dtype=torch.bfloat16,
                                     device=dev))
    with pytest.raises(ValueError, match="bf16"):
        mk.gemm_wgrad(a, a.float())
    assert [c.count for c in counters] == n0


# the fused backward pass (csrc/mlp_fused_bwd.cu), one case per pass of the
# backward: (first group's width, second group's (0: none), N, masked,
# rank-1 term) at the stock widths, hidden 128 and hidden 64; the first
# group's output is f32 where it is an encoding's (63 wide)
DWGRAD_PASSES = [
    (256, 27, 128, False, False),   # rgb_layer: [feat | denc]
    (256, 0, 256, True, True),      # fc_feature (+ fc_density)
    (256, 0, 256, True, False),     # trunk1_3 .. trunk1_1, trunk0_3 .. 1
    (256, 63, 256, True, False),    # trunk1_0: [a03 | enc]
    (63, 0, 256, False, False),     # trunk0_0
    (128, 27, 64, False, False),    # hidden 128
    (128, 63, 128, True, False),
    (128, 0, 128, True, True),
    (64, 27, 32, False, False),     # hidden 64
    (64, 0, 64, True, True),
]


def _dwgrad_operands(dev, M, K0, K1, N, masked, rank1, seed):
    """A pass's operands: (g, the two groups' inputs, the weight rows, g_raw
    and wd for the rank-1 term)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(seed)
    g = (torch.randn((M, N), generator=gen, device=dev) * 1e-2).to(
        torch.bfloat16)
    xs = [_nan_padded(dev, gen, M, k) if k else None for k in (K0, K1)]
    w = mk._padded(torch.randn((K0 + K1, N), generator=gen, device=dev)
                   * N ** -0.5)
    g_raw = torch.randn((M, 4), generator=gen, device=dev) * 1e-2
    wd = torch.randn((K0,), generator=gen, device=dev).to(torch.bfloat16)
    return g, xs, (w[:K0], w[K0:]), g_raw, wd


def _dwgrad_groups(dev, M, K0, K1, N, masked, xs, ws, weight_grads):
    """The pass's :class:`DwGroup` s with fresh outputs (the first group's
    f32 when it is an encoding's) and, with ``weight_grads``, fresh column
    sums and weight gradients (rows of one dW)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    f32 = torch.float32
    dt0 = f32 if K0 % 64 else torch.bfloat16
    dw = torch.full((K0 + K1, N), float("nan"), device=dev)
    groups = [mk.DwGroup(
        ws[0], torch.empty((M, mk._pad8(K0)), dtype=dt0, device=dev)[:, :K0],
        x=xs[0] if (masked or weight_grads) else None, mask=masked,
        colsum=(torch.empty(K0, device=dev) if weight_grads
                and dt0 != f32 else None),
        dw=dw[:K0] if weight_grads else None)]
    if K1:
        groups.append(mk.DwGroup(
            ws[1], torch.empty((M, mk._pad8(K1)), dtype=f32,
                               device=dev)[:, :K1],
            x=xs[1] if weight_grads else None,
            dw=dw[K0:] if weight_grads else None))
    return groups


@pytest.mark.parametrize("M", [1000, 131072])
@pytest.mark.parametrize("K0,K1,N,masked,rank1", DWGRAD_PASSES)
def test_fused_bwd_pass_matches_plain(dev, M, K0, K1, N, masked, rank1):
    """One fused backward pass against gemm_dwgrad_reference (the plain
    gemm_dgrad_reference and gemm_wgrad_reference), ragged and stock M: the
    bf16 input gradient within one bf16 ulp of the rounded reference, the
    f32 ones, the column sums and the weight gradients (fc_density's too)
    to relL2 1e-5 (f32 order only), finite (the NaN row padding is never
    read); bitwise equal on a rerun; the input-only pass's outputs bitwise
    those of the full pass. One launch counted per pass, and one split
    reduction per full pass."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    g, xs, ws, g_raw, wd = _dwgrad_operands(dev, M, K0, K1, N, masked, rank1,
                                            M + K0 + K1 + N)
    rank = dict(gsig=g_raw[:, 0], wd=wd) if rank1 else {}
    runs = []
    counts = []
    for weight_grads in (True, True, False):
        groups = _dwgrad_groups(dev, M, K0, K1, N, masked, xs, ws,
                                weight_grads)
        dwd = (torch.empty((K0, 1), device=dev) if rank1 and weight_grads
               else None)
        n0 = (mk.MLP_FUSED_BWD_LAUNCHES.count, mk.WGRAD_LAUNCHES.count)
        mk.gemm_dwgrad(g, groups, dwd=dwd, **rank)
        counts.append((mk.MLP_FUSED_BWD_LAUNCHES.count - n0[0],
                       mk.WGRAD_LAUNCHES.count - n0[1]))
        runs.append((groups, dwd))
    assert counts == [(1, 1), (1, 1), (1, 0)]
    (full, dwd), (again, dwd2), (inputs_only, _) = runs
    for i, grp in enumerate(full):
        y, dw = mk.gemm_dwgrad_reference(
            g.float(), grp.w.float(), xs[i].float(),
            xs[i].float() if grp.mask else None,
            g_raw[:, 0] if rank1 and i == 0 else None,
            wd.float() if rank1 and i == 0 else None)
        assert torch.isfinite(grp.out.float()).all()
        assert torch.equal(grp.out, again[i].out)
        assert torch.equal(grp.out, inputs_only[i].out)
        if grp.out.dtype == torch.bfloat16:
            assert _ulps(grp.out, y.to(torch.bfloat16)) <= 1.0
        else:
            assert _rel_l2(grp.out, y) <= 1e-5
        assert torch.isfinite(grp.dw).all() and torch.equal(grp.dw, again[i].dw)
        assert _rel_l2(grp.dw, dw) <= 1e-5, i
        if grp.colsum is not None:
            assert torch.equal(grp.colsum, again[i].colsum)
            assert _rel_l2(grp.colsum, y.sum(0)) <= 1e-5
    if rank1:
        assert torch.equal(dwd, dwd2)
        assert _rel_l2(dwd, mk.gemm_wgrad_reference(
            xs[0].float(), g_raw[:, :1])) <= 1e-5


@pytest.mark.parametrize("rays,S,H2", [(1024, 128, 128), (37, 8, 32),
                                       (40, 64, 64)])
def test_heads_bwd_fused_matches_plain(dev, rays, S, H2):
    """The rgb head's backward with the heads' weight-gradient work folded
    in against its plain versions: g_hr within one bf16 ulp of
    heads_bwd_reference and bitwise that of the input-only call, the column
    sums, fc_rgb's dW and g_raw's column sums to relL2 1e-5; bitwise on a
    rerun."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(rays + S + H2)
    M = rays * S
    g_raw = torch.randn((M, 4), generator=gen, device=dev)
    hr = torch.randn((M, H2), generator=gen, device=dev).relu().to(
        torch.bfloat16)
    wc = torch.randn((H2, 3), generator=gen, device=dev).to(torch.bfloat16)
    outs = []
    for wgrad in (True, True, False):
        sums = ([torch.empty(s, device=dev) for s in ((H2,), (H2, 3), (4,))]
                if wgrad else [None] * 3)
        outs.append((mk.heads_bwd_fused(g_raw, hr, wc, torch.empty_like(hr),
                                        *sums), sums))
    (g_hr, sums), (again, sums2), (alone, _) = outs
    ref = mk.heads_bwd_reference(g_raw, hr.float(), wc.float())
    assert torch.equal(g_hr, again) and torch.equal(g_hr, alone)
    assert _ulps(g_hr, ref.to(torch.bfloat16)) <= 1.0
    want = (ref.sum(0), mk.gemm_wgrad_reference(hr.float(), g_raw[:, 1:]),
            g_raw.sum(0))
    for got, got2, w in zip(sums, sums2, want):
        assert torch.equal(got, got2)
        assert _rel_l2(got, w) <= 1e-5


def test_fused_bwd_pass_rejects_what_it_cannot_take(dev):
    """An operand the fused backward pass cannot take raises; nothing falls
    back, and nothing is counted."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(1)
    M = 256
    g = _nan_padded(dev, gen, M, 64)
    x = _nan_padded(dev, gen, M, 64)
    w = mk._padded(torch.randn((64, 64), device=dev))
    out = torch.empty((M, 64), dtype=torch.bfloat16, device=dev)
    f32_out = torch.empty((M, 64), device=dev)
    misaligned = torch.zeros(M * 64 + 8, dtype=torch.bfloat16,
                             device=dev)[1:1 + M * 64].view(M, 64)
    n0 = (mk.MLP_FUSED_BWD_LAUNCHES.count, mk.WGRAD_LAUNCHES.count)
    bad = [
        ("bf16 cotangent", _nan_padded(dev, gen, M, 48),
         [mk.DwGroup(mk._padded(torch.randn((64, 48), device=dev)), out)]),
        ("bf16 cotangent", g.float(), [mk.DwGroup(w, out)]),
        ("16-byte", g, [mk.DwGroup(w, out, x=misaligned, mask=True)]),
        ("first group", g, [mk.DwGroup(w, out), mk.DwGroup(w, out, x=x,
                                                          mask=True)]),
        ("first group", g, [mk.DwGroup(w, f32_out, x=x,
                                       colsum=torch.empty(64, device=dev))]),
        ("reads the group's input", g, [mk.DwGroup(w, out, mask=True)]),
        ("reads the group's input", g, [mk.DwGroup(
            w, out, dw=torch.empty((64, 64), device=dev))]),
        ("one or two groups", g, [mk.DwGroup(w, out)] * 3),
    ]
    for match, gg, groups in bad:
        with pytest.raises(ValueError, match=match):
            mk.gemm_dwgrad(gg, groups)
    with pytest.raises(ValueError, match="rank-1"):
        mk.gemm_dwgrad(g, [mk.DwGroup(w, out, x=x, mask=True)],
                       gsig=torch.zeros(M, device=dev))
    with pytest.raises(ValueError, match="come together"):
        mk.heads_bwd_fused(torch.zeros((M, 4), device=dev), out, torch.zeros(
            (64, 3), dtype=torch.bfloat16, device=dev), out.clone(),
            b_rgb=torch.empty(64, device=dev))
    assert (mk.MLP_FUSED_BWD_LAUNCHES.count, mk.WGRAD_LAUNCHES.count) == n0


# the backwards held to the layer-by-layer one: (kernel, hidden width)
FUSED_BWD_CASES = [("A", 256), ("A", 128), ("A", 64), ("C", 256), ("C", 128),
                   ("C", 64)]


def _layered_grads(fn, w, x, cots):
    """The same backward through mlp_kernel._chain_bwd_layered."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    real = mk._chain_bwd
    mk._chain_bwd = mk._chain_bwd_layered
    try:
        return torch.autograd.grad(fn(w, x), x + w, cots)
    finally:
        mk._chain_bwd = real


@pytest.mark.parametrize("kernel,D", FUSED_BWD_CASES)
def test_fused_backward_matches_layered_and_plain(dev, kernel, D):
    """Kernel A's backward (64 rays x 128 samples) and Kernel C's (1500
    points) on the fused passes against the layer-by-layer backward they
    replaced (relL2 1e-3: the same bf16 cotangents, the weight and bias
    gradients summed in another f32 order) and against the plain version
    (relL2 1e-2, chip_smoke.py's bar), at every width the fused kernels
    take; bitwise equal on a rerun; ten fused passes and no layer-by-layer
    GEMM per backward."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    if kernel == "A":
        ws, geo, z, deltas, cots = _kernel_a_inputs(dev, 64, 128, D, D + 1)
        static = (10, 4, "softplus", True, False, False, 128)
        cots[2] = torch.zeros_like(cots[2])

        def fn(w, x, f=mk.fused_mlp_composite):
            return f(w, *x, z, deltas, *static)
        plain = mk.fused_mlp_composite_reference
        ins = geo
    else:
        ws, ins, cots = _kernel_c_inputs(dev, 1500, D, D + 2)

        def fn(w, x, f=mk.fused_mlp):
            return f(w, *x, 10, 4, "softplus", True)
        plain = mk.fused_mlp_reference
    x = [a.clone().requires_grad_() for a in ins]
    w = [a.clone().requires_grad_() for a in ws]
    counters = (mk.MLP_FUSED_BWD_LAUNCHES, mk.GEMM_DGRAD_LAUNCHES,
                mk.GEMM_WGRAD_LAUNCHES)
    n0 = [c.count for c in counters]
    got = torch.autograd.grad(fn(w, x), x + w, cots)
    n1 = [c.count for c in counters]
    again = torch.autograd.grad(fn(w, x), x + w, cots)
    layered = _layered_grads(fn, w, x, cots)
    ref = torch.autograd.grad(fn(w, x, plain), x + w, cots)
    assert [b - a for a, b in zip(n0, n1)] == [mk.FUSED_BWD_PER_BWD, 0, 0]
    for i, (a, b, l, r) in enumerate(zip(got, again, layered, ref)):
        assert torch.isfinite(a).all() and torch.equal(a, b), i
        assert _rel_l2(a, l) < 1e-3, (i, _rel_l2(a, l))
        assert _rel_l2(a, r) < 1e-2, (i, _rel_l2(a, r))


# Kernel A's compositing and encoding backward: (rays, samples), ragged
# blocks and sample counts that tile no warp or block among them
COMPOSITE_BWD_SHAPES = [(1024, 128), (300, 64), (37, 96), (50, 12),
                        (3, 700), (1, 2000)]
COMPOSITE_FLAGS = [(True, True, False, False), (False, False, True, True),
                   (True, False, True, False), (False, True, False, True)]


def _composite_bwd_operands(dev, N, S, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    z = torch.sort(rnd(N, S).abs() * 2.0 + 0.5, dim=1).values
    deltas = torch.cat([z[:, 1:] - z[:, :-1],
                        torch.full((N, 1), 1e10, device=dev)], 1)
    return (rnd(N * S, 4, scale=2.0), z, deltas, rnd(N, 3), rnd(N, 1),
            rnd(N, S))


@pytest.mark.parametrize("N,S", COMPOSITE_BWD_SHAPES)
@pytest.mark.parametrize("flags", COMPOSITE_FLAGS)
def test_composite_bwd_equals_per_ray_kernel(dev, N, S, flags):
    """composite_bwd_group against the one-thread-per-ray kernel it
    replaced, bit for bit, and against its plain version within relL2 1e-5;
    one launch counted."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    args = (*_composite_bwd_operands(dev, N, S, N + S), flags)
    n0 = mk.COMPOSITE_BWD_LAUNCHES.count
    got = mk.composite_bwd(*args)
    assert mk.COMPOSITE_BWD_LAUNCHES.count == n0 + 1
    old = mk._composite_bwd_per_ray(*args)
    ref = mk.composite_bwd_reference(*args)
    assert got.shape == (N * S, 4) and torch.isfinite(got).all()
    assert torch.equal(got, old)
    assert _rel_l2(got, ref) < 1e-5, _rel_l2(got, ref)


ENCODE_BWD_CASES = [(1024, 128, 10, 4), (300, 64, 10, 4), (37, 96, 10, 4),
                    (50, 12, 10, 4), (9, 40, 4, 6), (5, 33, 10, 16)]


def _encode_bwd_operands(dev, N, S, l_pos, l_dir, seed):
    """Per-ray geometry and z, and the encodings' cotangents as the chain
    backward leaves them: f32 rows padded to 8 columns (NaN in the
    padding, which the kernels must not read into a result)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(seed)
    M = N * S
    rays = torch.nn.functional.normalize(
        torch.randn((N, 3), generator=gen, device=dev), dim=1)
    origins = (torch.randn((1, 3), generator=gen, device=dev) * 0.1).expand(
        N, 3).contiguous()
    z = torch.sort(torch.rand((N, S), generator=gen, device=dev) * 3.5 + 0.5,
                   dim=1).values

    def cot(k):
        buf = torch.full((M, mk._pad8(k)), float("nan"), device=dev)
        buf[:, :k] = torch.randn((M, k), generator=gen, device=dev) * 1e-3
        return buf[:, :k]

    n_pos, n_dir = 3 * (2 * l_pos + 1), 3 * (2 * l_dir + 1)
    return (origins, rays, -rays, z, cot(n_pos), cot(n_pos), cot(n_dir),
            l_pos, l_dir)


@pytest.mark.parametrize("N,S,l_pos,l_dir", ENCODE_BWD_CASES)
def test_encode_bwd_equals_per_ray_kernel(dev, N, S, l_pos, l_dir):
    """encode_bwd_staged against the one-warp-per-ray kernel it replaced,
    bit for bit (d_origins, d_rays, d_dirs), and against its plain version
    within relL2 1e-5 each, at the stock levels and at direction encodings
    of two and four 32-column groups; one launch counted."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    args = _encode_bwd_operands(dev, N, S, l_pos, l_dir, N + S)
    n0 = mk.ENCODE_BWD_LAUNCHES.count
    got = mk.encode_bwd(*args)
    assert mk.ENCODE_BWD_LAUNCHES.count == n0 + 1
    old = mk._encode_bwd_per_ray(*args)
    ref = mk.encode_bwd_reference(*args)
    for name, a, b, r in zip(("d_o", "d_r", "d_d"), got, old, ref):
        assert a.shape == (N, 3) and torch.isfinite(a).all(), name
        assert torch.equal(a, b), name
        assert _rel_l2(a, r) < 1e-5, (name, _rel_l2(a, r))


@contextlib.contextmanager
def _per_ray_pair():
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    real = mk.composite_bwd, mk.encode_bwd
    mk.composite_bwd = mk._composite_bwd_per_ray
    mk.encode_bwd = mk._encode_bwd_per_ray
    try:
        yield
    finally:
        mk.composite_bwd, mk.encode_bwd = real


@pytest.mark.parametrize("N,S,D,flags", [
    (256, 128, 256, ("softplus", True, False, False)),
    (100, 64, 128, ("relu", False, True, True)),
    (37, 96, 64, ("softplus", True, False, True))])
def test_kernel_a_backward_equals_per_ray_pair(dev, N, S, D, flags):
    """Kernel A's whole backward, full and input-only, on the group and
    staged kernels against the same backward on the per-ray pair they
    replaced: every gradient bit for bit; each new kernel launched once a
    backward, the per-ray ones never."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    ws, geo, z, deltas, cots = _kernel_a_inputs(dev, N, S, D, N + D)
    static = (10, 4, *flags, S)
    g = [x.clone().requires_grad_() for x in geo]
    counters = (mk.COMPOSITE_BWD_LAUNCHES, mk.ENCODE_BWD_LAUNCHES,
                mk.COMPOSITE_BWD_PER_RAY_LAUNCHES,
                mk.ENCODE_BWD_PER_RAY_LAUNCHES)
    for weights in ([x.clone().requires_grad_() for x in ws], ws):
        out = mk.fused_mlp_composite(weights, *g, z, deltas, *static)
        inputs = g + [w for w in weights if w.requires_grad]
        n0 = [c.count for c in counters]
        got = torch.autograd.grad(out, inputs, cots, retain_graph=True)
        assert [c.count - n for c, n in zip(counters, n0)] == [1, 1, 0, 0]
        with _per_ray_pair():
            old = torch.autograd.grad(out, inputs, cots)
        assert len(got) == len(inputs)
        for i, (a, b) in enumerate(zip(got, old)):
            assert torch.isfinite(a).all() and torch.equal(a, b), i


def test_composite_and_encode_bwd_reject_what_they_cannot_take(dev):
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    c_args = _composite_bwd_operands(dev, 4, 16, 0)
    flags = (True, True, False, False)
    with pytest.raises(ValueError, match="g_alpha"):
        mk.composite_bwd(*c_args[:5], c_args[5][:, :8], flags)
    with pytest.raises(ValueError, match="contiguous f32"):
        mk.composite_bwd(c_args[0], c_args[1].t().contiguous().t(),
                         *c_args[2:], flags)
    big = _composite_bwd_operands(dev, 1, 15000, 0)
    with pytest.raises(ValueError, match="samples a ray"):
        mk.composite_bwd(*big, flags)
    e_args = list(_encode_bwd_operands(dev, 4, 16, 10, 4, 0))
    with pytest.raises(ValueError, match="at most"):
        mk.encode_bwd(*e_args[:7], 10, 17)
    shifted = torch.zeros((64, 68), device=dev)[:, 1:64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        mk.encode_bwd(*e_args[:4], shifted, *e_args[5:])
    narrow = torch.zeros((64, 63), device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mk.encode_bwd(*e_args[:5], narrow, *e_args[6:])


def _shaped_field(dev):
    """A width-64 field (4 / 2 encoding levels; Kernel C takes widths of
    64 and up) with a surface in view of :func:`_view`: first layer x4,
    density head x60, its bias bisected until ~35% of probe points in
    [-3, 3]^3 are occupied above tau = 0.5."""
    from nope_nerf_tpu_torch.models.nerf import apply_nerf, init_nerf_params

    cfg = {"model": {"hidden_dim": 64, "pos_enc_levels": 4,
                     "dir_enc_levels": 2},
           "rendering": {"white_background": False}}
    params = init_nerf_params(torch.Generator().manual_seed(14), cfg, dev)
    params["trunk0_0"]["w"] = params["trunk0_0"]["w"] * 4.0
    params["fc_density"]["w"] = params["fc_density"]["w"] * 60.0
    probe = torch.tensor(np.random.default_rng(0).uniform(-3, 3, (2048, 3)),
                         dtype=torch.float32, device=dev)
    rc = {"occ_activation": "softplus", "pos_enc_levels": 4,
          "dir_enc_levels": 2, "dist_alpha": False}
    bias = params["fc_density"]["b"].clone()
    lo, hi = -10.0, 10.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        params["fc_density"]["b"] = bias + mid
        occ = apply_nerf(params, probe, None, rc, only_occupancy=True)
        lo, hi = (lo, mid) if float((occ > 0.5).float().mean()) > 0.35 else (
            mid, hi)
    params["fc_density"]["b"] = bias + hi
    return params


def _render_cfg(stock):
    """The render config of a width-64 field: ``stock`` routes it as the
    stock config does on the card (Kernel A, bf16 MLP operands)."""
    return {"num_points": 32, "outside_steps": 0, "depth_range": [0.5, 6.0],
            "sample_option": "uniform", "dist_alpha": False,
            "use_ray_dir": True, "normalise_ray": True,
            "white_background": False, "normal_loss": False,
            "occ_activation": "softplus", "pos_enc_levels": 4,
            "dir_enc_levels": 2, "hidden_dim": 64,
            "n_max_network_queries": 2 ** 21, "mlp_bf16": stock,
            "use_pallas_mlp": stock, "fuse_compositing": True}


def _view(dev):
    from nope_nerf_tpu_torch.utils.synthetic import lookat_c2w

    K = torch.tensor([[1.6, 0, 0, 0], [0, -2.0, 0, 0], [0, 0, -1, 0],
                      [0, 0, 0, 1]], dtype=torch.float32, device=dev)
    world = torch.tensor(np.linalg.inv(lookat_c2w([0.8, 0.3, 2.4], [0, 0, 0])),
                         dtype=torch.float32, device=dev)
    return K, world, torch.eye(4, device=dev)


@pytest.mark.parametrize("stock", [False, True])
def test_phong_render_matches_cpu(dev, stock):
    """``phong_render`` of 54 x 96 rays (the stock vis_resolution: 2.65 M
    proposal points, chunked) on the card against the same call on the
    CPU. f32 (``stock`` False): rgb and rgb_surf to 1e-4 on >= 98% of the
    rays (the rest may pick another bracket near tau). Stock routing (bf16
    occupancy queries, the surface colour through Kernel C, one forward
    counted): the same share to 1e-2."""
    from nope_nerf_tpu_torch.geometry.rays import arange_pixels
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.phong import phong_render

    cpu = torch.device("cpu")
    cfg = _render_cfg(stock)
    outs = []
    for d in (dev, cpu):
        params = _shaped_field(d)
        _, pix = arange_pixels((54, 96), device=d)
        c0 = mk.FWD_POINT_LAUNCHES.count
        out = phong_render(params, pix, *_view(d), cfg, rad=4.0)
        outs.append({k: v.cpu() for k, v in out.items()})
        if d.type == "cuda":
            assert mk.FWD_POINT_LAUNCHES.count - c0 == (1 if stock else 0)
    bar = 1e-2 if stock else 1e-4
    rows = torch.ones(54 * 96, dtype=torch.bool)
    for key in ("rgb", "rgb_surf"):
        assert torch.isfinite(outs[0][key]).all()
        rows &= (outs[0][key] - outs[1][key]).abs().amax(-1) <= bar
    assert float(rows.float().mean()) >= 0.98
    shaded = (outs[1]["rgb"] != 1.0).any(-1)
    assert shaded.any() and (~shaded).any()


def test_render_visdata_matches_cpu(dev, tmp_path):
    """``render_visdata`` at 54 x 96 with the stock routing on the card
    (rgb and depth through Kernel A's forward, one launch; Phong as above)
    against the same call on the CPU (Kernel A's plain version): the img
    and depth PNGs within +-1 on >= 99% of the pixels, geo on >= 98%."""
    import types

    from PIL import Image

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.training.visualize import render_visdata

    cfg = {"pose": {"learn_pose": False, "learn_focal": False},
           "training": {"vis_geo": True}, "rendering": {"radius": 4.0}}
    scene = types.SimpleNamespace(
        K=np.array([[1.6, 0, 0, 0], [0, -2.0, 0, 0], [0, 0, -1, 0],
                    [0, 0, 0, 1]], np.float32),
        scale_mat=np.eye(4, dtype=np.float32))
    for d in (dev, torch.device("cpu")):
        state = types.SimpleNamespace(params={"nerf": _shaped_field(d)})
        f0 = mk.FWD_LAUNCHES.count
        render_visdata(state, cfg, _render_cfg(True), None, scene, (54, 96), 0,
                       str(tmp_path / d.type))
        if d.type == "cuda":
            assert mk.FWD_LAUNCHES.count - f0 == 1

    def png(who, name):
        return np.asarray(Image.open(tmp_path / who / name)).astype(np.int32)

    for name, share in (("0000_img.png", 0.99), ("0000_depth.png", 0.99),
                        ("0000_geo.png", 0.98)):
        diff = np.abs(png("cuda", name) - png("cpu", name))
        if diff.ndim == 3:
            diff = diff.max(-1)
        assert (diff <= 1).mean() >= share, name


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("net", ["dpt", "lpips"])
def test_frozen_nets_on_card_match_cpu(dev, net):
    """DPT (a batch of two 64x96 frames, the published widths) and LPIPS
    (40x48) on the card against the same call on the CPU, from seeded
    weights with the published checkpoints' keys and shapes converted by
    the port's converters: depth relL2 <= 1e-4 (chip_smoke.py's bar against
    float64), LPIPS rel <= 2e-4. Each call runs in full f32 and leaves the
    caller's TF32 flags (here both on) as they were."""
    import chip_smoke
    from nope_nerf_tpu_torch.convert import (dpt_params_from_jax,
                                             lpips_params_from_jax, tree_to)

    gen = torch.Generator().manual_seed(0)
    if net == "dpt":
        from nope_nerf_tpu_torch.convert_dpt import convert
        from nope_nerf_tpu_torch.models.dpt import apply_dpt_batched as fn

        state = chip_smoke.seeded_state(chip_smoke.dpt_checkpoint_shapes(),
                                        gen, 0.05)
        state["scratch.output_conv.4.bias"].fill_(chip_smoke.DPT_HEAD_BIAS)
        params = dpt_params_from_jax(convert(state))
        args = (torch.rand((2, 64, 96, 3), generator=gen) * 2 - 1,)
    else:
        from nope_nerf_tpu_torch.convert_lpips import convert
        from nope_nerf_tpu_torch.models.lpips import lpips_distance as fn

        vgg, lin = (chip_smoke.seeded_state(s, gen, 0.08)
                    for s in chip_smoke.lpips_checkpoint_shapes())
        params = lpips_params_from_jax(convert(
            vgg, {k: v.abs() for k, v in lin.items()}))
        args = tuple(torch.rand((40, 48, 3), generator=gen) for _ in "ab")
    want = fn(params, *args)
    saved = _tf32_flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fn(tree_to(params, dev), *(a.to(dev) for a in args))
        assert _tf32_flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    if net == "dpt":
        assert got.shape == want.shape == (2, 64, 96)
        assert _rel_l2(got.cpu(), want) <= 1e-4
    else:
        assert float(want) > 1e-3
        assert float(got) == pytest.approx(float(want), rel=2e-4)


@pytest.mark.parametrize("config", ["stock", "ssim_normal"])
def test_captured_epoch_equals_eager_epoch(dev, config):
    """``make_epoch_step`` on the card: two epochs of 4 steps replayed from
    one captured CUDA graph of the step against the same two epochs run
    eagerly, twice, from the same parameters, Adam state and generator
    state (a small stock-route model: Kernels A and B; ``ssim_normal`` adds
    the SSIM map to rgb_s and turns on the normal term). The per-step
    losses, the parameters and Adam's moments of all three runs are equal
    bit for bit; each replay runs Kernel A once each way and Kernel B
    twice; a call on another state or generator than the capture's
    raises."""
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training import capture
    from nope_nerf_tpu_torch.training.loop import (build_params,
                                                   scene_batch_arrays)
    from nope_nerf_tpu_torch.training.scheduler import Scheduler
    from nope_nerf_tpu_torch.training.trainer import (init_train_state,
                                                      make_epoch_step,
                                                      make_render_cfg)

    cfg = load_config(DEFAULT_CONFIG)
    cfg["model"]["hidden_dim"] = 64
    cfg["rendering"]["num_points"] = 32
    cfg["training"]["n_training_points"] = 256
    if config == "ssim_normal":
        cfg["training"]["with_ssim"] = True
        cfg["rendering"]["normal_loss"] = True
    scene = MemoryScene(4, 96, 128, 0)
    cfg["_num_cams"] = 4
    batch0 = scene_batch_arrays(scene, cfg, dev)
    sched = Scheduler(cfg)
    w_l1, w_l2 = sched.rgb_loss_switch(0)
    scalars = {"weights": sched.weights(0), "w_l1": w_l1, "w_l2": w_l2,
               "lrs": sched.applied_lrs(0)}
    static = sched.static_flags(0)
    orders = [np.array([2, 0, 3, 1]), np.array([1, 3, 0, 2])]
    results = []
    for capture_it in (False, True, False):
        params, init_c2w = build_params(cfg, scene,
                                        torch.Generator().manual_seed(0), dev)
        state = init_train_state(params, capturable=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        run = make_epoch_step(cfg, make_render_cfg(cfg, dev), init_c2w,
                              device=dev, eager=not capture_it)
        assert run.route == ("cuda graph" if capture_it else "eager")
        losses = []
        for order in orders:
            run(state, batch0, order, (order + 1) % 4, scalars, gen, static)
            losses.append(run.steps["loss"].clone())
        opt = state.optimizer
        results.append((torch.cat(losses),
                        [p.detach().clone() for g in opt.param_groups
                         for p in g["params"]],
                        [opt.state[p][m].clone() for g in opt.param_groups
                         for p in g["params"] for m in ("exp_avg",
                                                        "exp_avg_sq")]))
        if capture_it:
            (graph,) = run.graphs.graphs.values()
            assert graph.record.replays == 7  # 8 steps, the first eager
            launches = graph.record.launches
            assert (launches["mlp_composite_fwd"], launches[
                "mlp_composite_bwd"], launches["chamfer_band"]) == (1, 1, 2)
            assert capture.replayed_launches()["chamfer_band"] >= 14
            # a replay writes the storage of its capture: another state or
            # generator is refused, not silently left untouched
            other, _ = build_params(cfg, scene,
                                    torch.Generator().manual_seed(0), dev)
            for args in ((init_train_state(other, capturable=True), gen),
                         (state, torch.Generator(device=dev))):
                with pytest.raises(ValueError, match="captured on other"):
                    run(args[0], batch0, orders[0], (orders[0] + 1) % 4,
                        scalars, args[1], static)
    (le, pe, me) = results[0]
    assert torch.isfinite(le).all()
    for lg, pg, mg in results[1:]:
        assert torch.equal(le, lg)
        assert all(torch.equal(a, b) for a, b in zip(pe, pg))
        assert all(torch.equal(a, b) for a, b in zip(me, mg))


def test_captured_epoch_sections_tile_the_dispatch(dev):
    """The section timing events of a captured ``make_epoch_step`` (a small
    stock-route model, 8 steps an epoch): the last replay's sections,
    ``step.rays`` ... ``step.aux`` with Kernel A's backward in
    ``step.backward.field``, sum to the dispatch's device ms over its steps
    within 5%, the replays queued behind a busy device so that none waits
    for the host; the eager warm-up keeps its own sections."""
    from nope_nerf_tpu_torch import tracing
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import (build_params,
                                                   scene_batch_arrays)
    from nope_nerf_tpu_torch.training.scheduler import Scheduler
    from nope_nerf_tpu_torch.training.trainer import (init_train_state,
                                                      make_epoch_step,
                                                      make_render_cfg)

    tracing.reset()
    cfg = load_config(DEFAULT_CONFIG)
    cfg["model"]["hidden_dim"] = 64
    cfg["rendering"]["num_points"] = 32
    cfg["training"]["n_training_points"] = 256
    n = 8
    scene = MemoryScene(n, 96, 128, 0)
    cfg["_num_cams"] = n
    batch0 = scene_batch_arrays(scene, cfg, dev)
    sched = Scheduler(cfg)
    w_l1, w_l2 = sched.rgb_loss_switch(0)
    scalars = {"weights": sched.weights(0), "w_l1": w_l1, "w_l2": w_l2,
               "lrs": sched.applied_lrs(0)}
    params, init_c2w = build_params(cfg, scene,
                                    torch.Generator().manual_seed(0), dev)
    state = init_train_state(params, capturable=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    run = make_epoch_step(cfg, make_render_cfg(cfg, dev), init_c2w,
                          device=dev)
    order = np.arange(n)
    refs = np.array([scene.sample_ref_idx(int(i)) for i in order])
    static = sched.static_flags(0)
    run(state, batch0, order, refs, scalars, gen, static)
    names = {"step.rays", "step.field", "step.pair", "step.loss",
             "step.backward", "step.backward.field", "step.update",
             "step.aux"}
    warm = tracing.section_ms("train", eager=True)
    assert set(warm) == names and all(v > 0 for v in warm.values())
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms: the epoch queues behind it
    run(state, batch0, order, refs, scalars, gen, static)
    per_step = run.last_dispatch.device_ms() / n
    got = tracing.section_ms("train")
    assert set(got) == names and all(v > 0 for v in got.values())
    assert sum(got.values()) == pytest.approx(per_step, rel=0.05)
    (graph,) = run.graphs.graphs.values()
    assert graph.sections.names[-1] == tracing.END
    assert graph.sections.names.count("step.backward") == 2
