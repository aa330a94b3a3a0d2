"""Kernel tests of the PyTorch port that need a CUDA device (marker
``cuda``); without one they skip. On the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each hand-written kernel against its plain PyTorch version on the card, at
small shapes.
"""
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
    disabled) the forward runs on ping-pong buffers and builds no graph;
    its outputs equal the saving forward's bit for bit, and it counts one
    launch."""
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
    backward runs none of the 12 weight-gradient GEMMs and returns the input
    gradients of the full backward bit for bit."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    fn, ws, ins, cots = _kernel_call(dev, kernel)
    x = [a.clone().requires_grad_() for a in ins]
    w = [a.clone().requires_grad_() for a in ws]
    counters = (mk.WGRAD_LAUNCHES, mk.GEMM_WGRAD_LAUNCHES,
                mk.GEMM_DGRAD_LAUNCHES, mk.GEMM_NN_LAUNCHES)
    n0 = [c.count for c in counters]
    full = torch.autograd.grad(fn(w, x), x + w, cots)
    n1 = [c.count for c in counters]
    inputs_only = torch.autograd.grad(fn(ws, x), x, cots)
    n2 = [c.count for c in counters]
    on_wgmma = 11 if kernel == "A" else 12  # C's direction half is per point
    assert [b - a for a, b in zip(n0, n1)] == [
        mk.WGRAD_PER_BWD, on_wgmma, mk.DGRAD_PER_BWD, 0]
    assert [b - a for a, b in zip(n1, n2)] == [0, 0, mk.DGRAD_PER_BWD, 0]
    for a, b in zip(inputs_only, full[:len(x)]):
        assert torch.equal(a, b)


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
