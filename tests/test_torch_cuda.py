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
