"""Parity of Kernel C (per-point fused MLP) and Kernel D (exact Chamfer)
plain versions, the ``grid`` Chamfer mode and the ``auto`` rule with the
JAX package, at small sizes (hidden 32, 2048 points). Inputs come from a
numpy seed and feed both sides; the JAX Pallas kernels run in interpret
mode, as the JAX package's own tests run them on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

D_SMALL = 32


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _rel_l2(a, b):
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def nerf():
    """JAX-initialised field weights (hidden 32), as numpy and as port
    tensors."""
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.convert import params_from_jax

    cfg = {"model": {"hidden_dim": D_SMALL, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    tree = jax.device_get(init_nerf_params(jax.random.PRNGKey(3), cfg))
    return tree, params_from_jax({"nerf": tree})["nerf"]


# ---------------------------------------------------------------------------
# Kernel C
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act,occ_alpha", [("softplus", True),
                                           ("softplus", False),
                                           ("relu", True),
                                           ("relu", False)])
def test_fused_mlp_reference_vs_pallas(nerf, act, occ_alpha):
    """Kernel C's plain version against the JAX Pallas ``fused_mlp`` in
    interpret mode, all four head-activation branches, forward and the
    gradients of every weight, the points and the directions.

    The bars are tests/test_pallas.py's for the bf16 kernel (rgb atol 0.03,
    density rtol 0.08 / atol 0.05, gradients relL2 0.02): both round the
    same operands to bf16 and differ in f32 summation order, which can flip
    a bf16 rounding or a relu mask. (Measured on the CPU: at most 2.6e-5
    relL2 in every branch, relu included; Kernel A's relu + dist_alpha
    deviation of the Pallas interpret run does not appear here.)
    """
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(21)
    M = 2048
    pts = rng.normal(size=(M, 3)).astype(np.float32)
    d = rng.normal(size=(M, 3))
    dirs = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    c_rgb = rng.normal(size=(M, 3)).astype(np.float32) / M
    c_den = rng.normal(size=(M, 1)).astype(np.float32) / M

    jw = jmk.collect_weights(jax.tree.map(jnp.asarray, nerf[0]))

    def jloss(w, p, q):
        rgb, den = jmk.fused_mlp(w, p, q, 10, 4, act, occ_alpha)
        return (jnp.sum(rgb * jnp.asarray(c_rgb))
                + jnp.sum(den * jnp.asarray(c_den))), (rgb, den)

    jmk.INTERPRET = True
    try:
        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
            jw, jnp.asarray(pts), jnp.asarray(dirs))
    finally:
        jmk.INTERPRET = False
    jgrads = list(jg[0]) + [jg[1], jg[2]]

    ws = [w.detach().clone().requires_grad_()
          for w in mk.collect_weights(nerf[1])]
    ins = [torch.tensor(a).requires_grad_() for a in (pts, dirs)]
    n0 = (mk.FWD_POINT_LAUNCHES.count, mk.BWD_POINT_LAUNCHES.count)
    rgb, den = mk.fused_mlp(ws, *ins, 10, 4, act, occ_alpha)
    (torch.sum(rgb * torch.tensor(c_rgb))
     + torch.sum(den * torch.tensor(c_den))).backward()
    assert (mk.FWD_POINT_LAUNCHES.count, mk.BWD_POINT_LAUNCHES.count) == n0
    assert rgb.shape == (M, 3) and den.shape == (M, 1)
    np.testing.assert_allclose(_np(rgb), np.asarray(jout[0]), atol=0.03)
    np.testing.assert_allclose(_np(den), np.asarray(jout[1]), rtol=0.08,
                               atol=0.05)
    names = [f"{n}/{k}" for n in mk.W_NAMES for k in "wb"] + ["pts", "dirs"]
    for name, x, jgr in zip(names, ws + ins, jgrads):
        assert _rel_l2(x.grad, jgr) < 0.02, name


def _render_setup(nerf, rng, dist_alpha, white_bg):
    from nope_nerf_tpu.geometry.so3 import make_c2w

    N, S = 64, 24
    cfg = {
        "num_points": S, "outside_steps": 0, "depth_range": [0.1, 4.0],
        "sample_option": "uniform", "dist_alpha": dist_alpha,
        "use_ray_dir": True, "normalise_ray": True,
        "white_background": white_bg, "normal_loss": False,
        "occ_activation": "relu" if dist_alpha else "softplus",
        "pos_enc_levels": 10, "dir_enc_levels": 4, "hidden_dim": D_SMALL,
        "n_max_network_queries": 2 ** 21, "mlp_bf16": True,
        "use_pallas_mlp": True, "fuse_compositing": False,
    }
    pix = rng.uniform(-1, 1, size=(N, 2)).astype(np.float32)
    dep = rng.uniform(0.5, 3.0, size=N).astype(np.float32)
    cam = np.array([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                    [0, 0, 0, 1]], np.float32)
    c2w = np.asarray(make_c2w(jnp.asarray([0.05, -0.1, 0.02]),
                              jnp.asarray([0.1, 0.2, -0.3])))
    world = np.linalg.inv(c2w).astype(np.float32)
    return cfg, (pix, dep, cam, world, np.eye(4, dtype=np.float32))


@pytest.mark.parametrize("dist_alpha,white_bg", [(False, False),
                                                 (True, True)])
def test_render_unfused_kernel_c_path(nerf, dist_alpha, white_bg):
    """``render_rays`` with ``use_pallas_mlp`` and ``fuse_compositing:
    False`` (Kernel C's plain version, then the plain compositing): against
    the port's fused Kernel A path at atol 2e-5 on rgb and alpha (the same
    MLP numerics, only the compositing differs; tests/test_pallas.py holds
    the JAX kernels to the same bar), and against the JAX package's
    unfused Pallas path in interpret mode at the bf16 bars (rgb atol 0.03,
    alpha rtol 0.08 / atol 0.05). A bound of 1000 points exercises the
    chunk loop, whose chunks round down to whole BMs."""
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu.ops.rendering import render_rays as jrender
    from nope_nerf_tpu_torch.ops.rendering import render_rays

    cfg, arrays = _render_setup(nerf, np.random.default_rng(22), dist_alpha,
                                white_bg)
    out = render_rays(nerf[1], *map(_t, arrays), cfg)
    fused = render_rays(nerf[1], *map(_t, arrays),
                        dict(cfg, fuse_compositing=True))
    chunked = render_rays(nerf[1], *map(_t, arrays),
                          dict(cfg, n_max_network_queries=1000))
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(_np(out[k]), _np(fused[k]), atol=2e-5,
                                   err_msg=k)
        np.testing.assert_allclose(_np(out[k]), _np(chunked[k]), atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(_np(out["depth_pred"]),
                               _np(fused["depth_pred"]), atol=2e-4)
    jmk.INTERPRET = True
    try:
        jout = jrender(jax.tree.map(jnp.asarray, nerf[0]),
                       *map(jnp.asarray, arrays), cfg)
    finally:
        jmk.INTERPRET = False
    np.testing.assert_allclose(_np(out["rgb"]), np.asarray(jout["rgb"]),
                               atol=0.03)
    np.testing.assert_allclose(_np(out["alpha"]), np.asarray(jout["alpha"]),
                               rtol=0.08, atol=0.05)


def test_apply_nerf_pads_to_bm(nerf):
    """``apply_nerf`` on the Kernel C path pads M to a multiple of BM and
    slices back: 1500 points give the rows of the padded evaluation."""
    from nope_nerf_tpu_torch.models.nerf import apply_nerf
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(23)
    pts = _t(rng.normal(size=(1500, 3)))
    dirs = _t(rng.normal(size=(1500, 3)))
    cm = {"occ_activation": "softplus", "pos_enc_levels": 10,
          "dir_enc_levels": 4, "dist_alpha": False, "use_pallas_mlp": True}
    rgb, den = apply_nerf(nerf[1], pts, dirs, cm)
    assert rgb.shape == (1500, 3) and den.shape == (1500, 1)
    pad = torch.zeros((2048 - 1500, 3))
    want = mk.fused_mlp_reference(mk.collect_weights(nerf[1]),
                                  torch.cat([pts, pad]),
                                  torch.cat([dirs, pad]), 10, 4,
                                  "softplus", True)
    torch.testing.assert_close(rgb, want[0][:1500], rtol=0, atol=0)
    torch.testing.assert_close(den, want[1][:1500], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Kernel D and the exact mode
# ---------------------------------------------------------------------------


def test_exact_nearest_matches_jax():
    """The direct-distance plain version gives the indices of the JAX
    Pallas kernel (interpret mode) and of the JAX score-form search, on
    tests/test_pallas.py's shapes (1500 x 2100)."""
    from nope_nerf_tpu.ops.chamfer import nearest_idx as jnearest
    from nope_nerf_tpu.ops.pallas.chamfer_kernel import nearest_idx_pallas
    from nope_nerf_tpu_torch.ops.chamfer import nearest_idx
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck

    rng = np.random.default_rng(24)
    X = rng.normal(size=(1500, 3)).astype(np.float32)
    Y = rng.normal(size=(2100, 3)).astype(np.float32)
    n0 = ck.LAUNCHES.count
    ix, iy = ck.nearest_idx_exact(_t(X), _t(Y))
    assert ck.LAUNCHES.count == n0
    assert ix.dtype == torch.int32 and ix.shape == (1500,)
    jx, jy = nearest_idx_pallas(jnp.asarray(X), jnp.asarray(Y),
                                interpret=True)
    sx, sy = jnearest(jnp.asarray(X), jnp.asarray(Y), block=512)
    for a, b, c in ((ix, jx, sx), (iy, jy, sy)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    ox, oy = nearest_idx(_t(X), _t(Y))
    np.testing.assert_array_equal(ox.numpy(), ix.numpy())
    np.testing.assert_array_equal(oy.numpy(), iy.numpy())
    only_x = ck.nearest_idx_exact(_t(X), _t(Y), two_dir=False)
    np.testing.assert_array_equal(only_x.numpy(), ix.numpy())


def test_exact_validity_masks():
    """Validity masks move points to the +-1e5 sentinels: the valid rows'
    indices equal JAX's (Pallas interpret and score form); with one valid
    Y point every query pairs with it; a query that has no pair below 1e10
    answers 0, as the Pallas kernel's carry does."""
    from nope_nerf_tpu.ops.chamfer import nearest_idx as jnearest
    from nope_nerf_tpu.ops.pallas.chamfer_kernel import nearest_idx_pallas
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck

    rng = np.random.default_rng(25)
    X = rng.normal(size=(300, 3)).astype(np.float32)
    Y = rng.normal(size=(400, 3)).astype(np.float32)
    xv = (rng.uniform(size=300) > 0.3).astype(np.float32)
    yv = (rng.uniform(size=400) > 0.3).astype(np.float32)
    ix, iy = ck.nearest_idx_exact(_t(X), _t(Y), _t(xv), _t(yv))
    jx, jy = nearest_idx_pallas(jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(xv), jnp.asarray(yv),
                                interpret=True)
    sx, sy = jnearest(jnp.asarray(X), jnp.asarray(Y), x_valid=jnp.asarray(xv),
                      y_valid=jnp.asarray(yv))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ix.numpy()[xv > 0], np.asarray(sx)[xv > 0])
    np.testing.assert_array_equal(iy.numpy()[yv > 0], np.asarray(sy)[yv > 0])
    assert (yv[ix.numpy()[xv > 0]] > 0).all()
    assert (xv[iy.numpy()[yv > 0]] > 0).all()

    one = np.zeros(64, np.float32)
    one[7] = 1.0
    ix, _ = ck.nearest_idx_exact(_t(X[:64]), _t(Y[:64]), y_valid=_t(one))
    assert (ix.numpy() == 7).all()
    none = ck.nearest_idx_exact(_t(X[:64]), _t(Y[:64]), y_valid=_t(0 * one),
                                two_dir=False)
    assert (none.numpy() == 0).all()


def test_exact_loss_matches_jax():
    """chamfer_loss_exact (and the masked variant) against the JAX Pallas
    loss in interpret mode, within 1e-6: identical indices, f32 gather."""
    from nope_nerf_tpu.ops.pallas.chamfer_kernel import chamfer_loss_pallas
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck

    rng = np.random.default_rng(26)
    X = rng.normal(size=(700, 3)).astype(np.float32)
    Y = rng.normal(size=(900, 3)).astype(np.float32)
    xv = (rng.uniform(size=700) > 0.2).astype(np.float32)
    for masks in ((None, None), (xv, None)):
        got = float(ck.chamfer_loss_exact(
            _t(X), _t(Y), *(None if m is None else _t(m) for m in masks)))
        want = float(chamfer_loss_pallas(
            jnp.asarray(X), jnp.asarray(Y),
            *(None if m is None else jnp.asarray(m) for m in masks),
            interpret=True))
        assert abs(got - want) < 1e-6, (masks[0] is None, got, want)


def test_exact_split_len_covers_the_cloud():
    """The kernel's split of the reduced cloud: whole shared-memory tiles,
    and at least one split."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck

    for nq, nr in ((32400, 32400), (129600, 129600), (1500, 2100), (10, 5)):
        sl = ck.split_len(nq, nr)
        assert sl % ck.SPLIT_TILE == 0 and sl > 0
        assert -(-nr // sl) * sl >= nr
        assert -(-nr // sl) <= -(-nr // ck.SPLIT_TILE)


# ---------------------------------------------------------------------------
# grid mode and the auto rule
# ---------------------------------------------------------------------------


def _depth_clouds(hs, ws, seed):
    """A backprojected depth-map pair, the second warped by a small rigid
    motion (the production distribution of the pc loss)."""
    from nope_nerf_tpu.geometry.rays import arange_pixels, transform_to_world
    from nope_nerf_tpu.geometry.so3 import make_c2w

    rng = np.random.default_rng(seed)
    cam = jnp.asarray([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                       [0, 0, 0, 1]], jnp.float32)
    _, pix = arange_pixels((hs, ws))
    yy, xx = np.meshgrid(np.linspace(0, 1, hs), np.linspace(0, 1, ws),
                         indexing="ij")
    depth = 2.0 + 0.5 * np.sin(3 * xx) * np.cos(2 * yy)
    d1, d2 = (jnp.asarray((depth + 0.01 * rng.normal(size=depth.shape))
                          .reshape(-1), jnp.float32) for _ in range(2))
    rel = make_c2w(jnp.asarray([0.01, -0.02, 0.005]),
                   jnp.asarray([0.02, 0.01, -0.03]))
    X = transform_to_world(pix, d1, cam) @ rel[:3, :3].T + rel[:3, 3]
    Y = transform_to_world(pix, d2, cam)
    return np.asarray(X), np.asarray(Y)


def test_morton_codes_match_jax():
    from nope_nerf_tpu.ops import chamfer as jc
    from nope_nerf_tpu_torch.ops import chamfer as pc

    X, _ = _depth_clouds(30, 40, 27)
    lo = X.min(0)
    inv = (1.0 / np.maximum(X.max(0) - lo, 1e-12)).astype(np.float32)
    for probe in (0, 1):
        np.testing.assert_array_equal(
            pc._morton_code(_t(X), _t(lo), _t(inv), probe).numpy(),
            np.asarray(jc._morton_code(jnp.asarray(X), jnp.asarray(lo),
                                       jnp.asarray(inv), probe)))


def test_grid_matches_jax():
    """nearest_idx_window on a 60x80 depth-map pair: at most 0.1% of the
    indices differ from JAX's (the window search is a K=3 score-form dot,
    whose summation order can flip near-ties, and sort ties may order
    otherwise), and the loss agrees within rtol 1e-5; the grid branch of
    the pc loss is the same loss."""
    from nope_nerf_tpu.ops.chamfer import (chamfer_loss_window as jloss,
                                           nearest_idx_window as jwindow)
    from nope_nerf_tpu_torch.losses.losses import chamfer_pc_loss
    from nope_nerf_tpu_torch.ops.chamfer import (chamfer_loss_window,
                                                 nearest_idx_window)

    X, Y = _depth_clouds(60, 80, 28)
    ix, iy = nearest_idx_window(_t(X), _t(Y))
    jx, jy = jwindow(jnp.asarray(X), jnp.asarray(Y))
    mism = (int(np.sum(ix.numpy() != np.asarray(jx)))
            + int(np.sum(iy.numpy() != np.asarray(jy))))
    assert mism <= 1e-3 * (X.shape[0] + Y.shape[0]), mism
    want = float(jloss(jnp.asarray(X), jnp.asarray(Y)))
    got = float(chamfer_loss_window(_t(X), _t(Y)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    pc = chamfer_pc_loss(_t(X), _t(Y), use_kernel=True, mode="grid")
    assert float(pc) == got


def test_resolve_chamfer_mode_matches_jax():
    """Both packages resolve alike over a grid of sizes, with and without
    hints, given the same explicit costs. Without hints, large clouds go to
    grid: the port once resolved every hint-less 'auto' to exact."""
    from nope_nerf_tpu.ops.chamfer import resolve_chamfer_mode as jresolve
    from nope_nerf_tpu_torch.ops.chamfer import resolve_chamfer_mode

    costs = dict(exact_ms_per_pair=1e-9, grid_ms_per_point=1e-4)
    sizes = (100, 3000, 32400, 129600, 10 ** 6)
    seen = set()
    with pytest.warns(UserWarning, match="APPROXIMATE"):
        for n_x in sizes:
            for n_y in sizes:
                for hints in (False, True):
                    for mode in ("auto", "exact", "grid", "band"):
                        kw = dict(hints_available=hints, **costs)
                        got = resolve_chamfer_mode(mode, n_x, n_y, **kw)
                        assert got == jresolve(mode, n_x, n_y, **kw)
                        seen.add(got)
        assert resolve_chamfer_mode("auto", 10 ** 6, 10 ** 6) == "grid"
    assert seen == {"exact", "grid", "band"}
    assert resolve_chamfer_mode("auto", 100, 100) == "exact"
    assert resolve_chamfer_mode("auto", 10 ** 6, 10 ** 6,
                                hints_available=True) == "band"
