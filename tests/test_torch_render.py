"""Parity of the port's field, renderer, Kernel A / Kernel B plain versions
and losses with the JAX package, at small sizes (hidden 32, <= 16 samples,
64 rays). Inputs come from a numpy seed and feed both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

D_SMALL, S_SMALL, N_RAYS = 32, 16, 64


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).requires_grad_(grad)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _cfg(**model):
    return {"model": {"hidden_dim": D_SMALL, "pos_enc_levels": 10,
                      "dir_enc_levels": 4, **model},
            "rendering": {"white_background": False}}


@pytest.fixture(scope="module")
def nerf():
    """One set of JAX-initialised field weights, as numpy and as port
    tensors."""
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.convert import params_from_jax

    tree = jax.device_get(init_nerf_params(jax.random.PRNGKey(3), _cfg()))
    return tree, params_from_jax({"nerf": tree})["nerf"]


@pytest.mark.parametrize("act,dist_alpha", [("softplus", False),
                                            ("relu", True)])
def test_apply_nerf_f32(nerf, act, dist_alpha):
    from nope_nerf_tpu.models.nerf import apply_nerf as japply
    from nope_nerf_tpu_torch.models.nerf import apply_nerf

    rng = np.random.default_rng(1)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    cm = {"occ_activation": act, "pos_enc_levels": 10, "dir_enc_levels": 4,
          "dist_alpha": dist_alpha}
    rgb, den = apply_nerf(nerf[1], _t(pts), _t(dirs), cm)
    jrgb, jden = japply(jax.tree.map(jnp.asarray, nerf[0]), jnp.asarray(pts),
                        jnp.asarray(dirs), cm)
    np.testing.assert_allclose(_np(rgb), jrgb, atol=1e-5)
    np.testing.assert_allclose(_np(den), jden, atol=1e-5)


def test_apply_nerf_bf16(nerf):
    """The mlp_bf16 path rounds the same operands and activations as the
    JAX one; only f32 summation order differs, which can move a value
    across a bf16 rounding boundary (one bf16 ulp, 2^-8 relative)."""
    from nope_nerf_tpu.models.nerf import apply_nerf as japply
    from nope_nerf_tpu_torch.models.nerf import apply_nerf

    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    cm = {"occ_activation": "softplus", "pos_enc_levels": 10,
          "dir_enc_levels": 4, "dist_alpha": False, "mlp_bf16": True}
    rgb, den = apply_nerf(nerf[1], _t(pts), _t(dirs), cm)
    jrgb, jden = japply(jax.tree.map(jnp.asarray, nerf[0]), jnp.asarray(pts),
                        jnp.asarray(dirs), cm)
    np.testing.assert_allclose(_np(rgb), jrgb, atol=1e-2)
    np.testing.assert_allclose(_np(den), jden, atol=1e-2)


def _render_cfg(sample_option, dist_alpha, white_bg):
    return {
        "num_points": S_SMALL, "outside_steps": 0,
        "depth_range": [0.1, 4.0], "sample_option": sample_option,
        "dist_alpha": dist_alpha, "use_ray_dir": True, "normalise_ray": True,
        "white_background": white_bg, "normal_loss": False,
        "occ_activation": "softplus", "pos_enc_levels": 10,
        "dir_enc_levels": 4, "hidden_dim": D_SMALL,
        "n_max_network_queries": 2 ** 21,
        "mlp_bf16": False, "use_pallas_mlp": False, "fuse_compositing": True,
    }


@pytest.mark.parametrize("sample_option,dist_alpha,white_bg,eval_mode", [
    ("uniform", False, False, False),  # the stock regime: occupancy alpha
    ("ndc", True, True, False),        # the LLFF regime
    ("uniform", False, False, True),   # eval-time dist -> depth division
])
def test_render_rays_unfused(nerf, sample_option, dist_alpha, white_bg,
                             eval_mode):
    from nope_nerf_tpu.geometry.so3 import make_c2w
    from nope_nerf_tpu.ops.rendering import render_rays as jrender
    from nope_nerf_tpu_torch.ops.rendering import render_rays

    rng = np.random.default_rng(4)
    cfg = _render_cfg(sample_option, dist_alpha, white_bg)
    pix = rng.uniform(-1, 1, size=(N_RAYS, 2)).astype(np.float32)
    dep = rng.uniform(0.5, 3.0, size=N_RAYS).astype(np.float32)
    dep[:3] = 0.0  # invalid rays stay in the batch, masked
    cam = np.array([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                    [0, 0, 0, 1]], np.float32)
    c2w = np.asarray(make_c2w(jnp.asarray([0.05, -0.1, 0.02]),
                              jnp.asarray([0.1, 0.2, -0.3])))
    world = np.linalg.inv(c2w).astype(np.float32)
    scale = np.eye(4, dtype=np.float32)
    out = render_rays(nerf[1], _t(pix), _t(dep), _t(cam), _t(world),
                      _t(scale), cfg, eval_mode=eval_mode)
    jout = jrender(jax.tree.map(jnp.asarray, nerf[0]), jnp.asarray(pix),
                   jnp.asarray(dep), jnp.asarray(cam), jnp.asarray(world),
                   jnp.asarray(scale), cfg, eval_mode=eval_mode)
    for k in ("rgb", "depth_pred", "depth_gt", "valid_mask", "z_vals",
              "alpha", "points_surface"):
        np.testing.assert_allclose(_np(out[k]), np.asarray(jout[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("act,dist_alpha,white_bg", [
    ("softplus", False, False),  # stock: occupancy alpha
    ("relu", True, True),        # dist_alpha + white background (LLFF)
])
def test_fused_composite_reference_vs_pallas(nerf, act, dist_alpha, white_bg):
    """Kernel A's plain version against the JAX Pallas kernel run in
    interpret mode, forward and gradients (weights, origins, rays, dirs).

    Both round the same operands and activations to bf16 and accumulate in
    f32; they differ in f32 summation order and in the transmittance (the
    Pallas kernel takes the cumprod in log space). The forward bars are
    tests/test_pallas.py's for the bf16 kernel against the bf16 field (rgb
    atol 0.03, alpha rtol 0.08 / atol 0.05; dist, a weighted mean of z,
    rgb's bar times the far plane 4), the gradient bar its relL2 0.02: a
    summation-order difference can flip a bf16 rounding or a relu mask, and
    the flips compound through ten chained matmuls and the 2^9 encoding
    frequencies.

    A float64 evaluation of the plain version (same bf16 rounding points,
    f64 accumulation) is the oracle for the gradients: the plain version
    must stay within 2e-3 of it. In the dist_alpha regime the Pallas run
    itself is ~6% (relL2) from that oracle in trunk1_2 and below (ROADMAP
    "Faults found"); there the port may differ from it by no more than the
    Pallas run's own error.
    """
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    rng = np.random.default_rng(5)
    N, S = N_RAYS, S_SMALL
    rays = rng.normal(size=(N, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    o = np.broadcast_to(rng.normal(scale=0.1, size=3), (N, 3))
    z = np.sort(rng.uniform(0.1, 4.0, size=(N, S)), axis=1)
    deltas = np.concatenate([np.diff(z, axis=1), np.full((N, 1), 1e10)], 1)
    cots = [rng.normal(size=s) / N for s in ((N, 3), (N, 1), (N, S))]
    static = (10, 4, act, not dist_alpha, dist_alpha, white_bg, S)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731

    jw = jmk.collect_weights(jax.tree.map(jnp.asarray, nerf[0]))

    def jloss(w, o_, r_, d_):
        out = jmk.fused_mlp_composite(w, o_, r_, d_, jnp.asarray(f32(z)),
                                      jnp.asarray(f32(deltas)), *static)
        return sum(jnp.sum(a * jnp.asarray(f32(c)))
                   for a, c in zip(out, cots)), out

    jmk.INTERPRET = True
    try:
        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
            jw, *(jnp.asarray(f32(a)) for a in (o, rays, -rays)))
    finally:
        jmk.INTERPRET = False
    jgrads = list(jg[0]) + list(jg[1:])

    def port(dtype):
        ws = [w.detach().to(dtype).requires_grad_()
              for w in mk.collect_weights(nerf[1])]
        ins = [torch.tensor(f32(a)).to(dtype).requires_grad_()
               for a in (o, rays, -rays)]
        t = lambda a: torch.tensor(f32(a)).to(dtype)  # noqa: E731
        out = mk.fused_mlp_composite(ws, *ins, t(z), t(deltas), *static)
        sum(torch.sum(a * t(c)) for a, c in zip(out, cots)).backward()
        return out, [x.grad for x in ws + ins]

    out, grads = port(torch.float32)
    _, oracle = port(torch.float64)
    np.testing.assert_allclose(_np(out[0]), jout[0], atol=0.03)
    np.testing.assert_allclose(_np(out[1]), jout[1], atol=0.03 * 4.0)
    np.testing.assert_allclose(_np(out[2]), jout[2], rtol=0.08, atol=0.05)
    names = [f"{n}/{k}" for n in mk.W_NAMES for k in "wb"] + [
        "origins", "rays", "dirs"]
    for name, g, jgr, og in zip(names, grads, jgrads, oracle):
        e_port, e_jax = _rel_l2(g, og), _rel_l2(jgr, og)
        assert e_port < 2e-3, (name, e_port)
        assert _rel_l2(g, jgr) < max(0.02, e_jax + 2e-3), (name, e_jax)
        if not dist_alpha:
            assert _rel_l2(g, jgr) < 0.02, name


def _depth_clouds(hs, ws, seed):
    """Two backprojected depth-map grids (hs x ws), the second warped by a
    small rigid motion: the production distribution of the pc loss."""
    from nope_nerf_tpu.geometry.rays import arange_pixels, transform_to_world
    from nope_nerf_tpu.geometry.so3 import make_c2w

    rng = np.random.default_rng(seed)
    cam = jnp.asarray([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                       [0, 0, 0, 1]], jnp.float32)
    _, pix = arange_pixels((hs, ws))
    yy, xx = np.meshgrid(np.linspace(0, 1, hs), np.linspace(0, 1, ws),
                         indexing="ij")
    depth = 2.0 + 0.5 * np.sin(3 * xx) * np.cos(2 * yy)
    d1 = jnp.asarray((depth + 0.01 * rng.normal(size=depth.shape)).reshape(-1),
                     jnp.float32)
    d2 = jnp.asarray((depth + 0.01 * rng.normal(size=depth.shape)).reshape(-1),
                     jnp.float32)
    rel = make_c2w(jnp.asarray([0.01, -0.02, 0.005]),
                   jnp.asarray([0.02, 0.01, -0.03]))
    X = transform_to_world(pix, d1, cam) @ rel[:3, :3].T + rel[:3, 3]
    Y = transform_to_world(pix, d2, cam)
    return np.asarray(X), np.asarray(Y), np.asarray(cam)


def test_band_start_tiles_exact_incl_nan():
    from nope_nerf_tpu.ops.pallas import chamfer_band as jcb
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    rng = np.random.default_rng(6)
    hint = rng.uniform(-5, 70, size=4500).astype(np.float32)
    hint[rng.integers(0, 4500, size=600)] = np.nan
    hint[1024:2048] = np.nan       # a group with no finite hint
    hint[10] = np.inf
    for k in (1, 2, 8):
        np.testing.assert_array_equal(
            cb.band_start_tiles(_t(hint), 4800, 80, k).numpy(),
            np.asarray(jcb.band_start_tiles(jnp.asarray(hint), 4800, 80, k)))


def test_banded_nearest_and_loss():
    from nope_nerf_tpu.geometry.rays import project_to_cam as jproj
    from nope_nerf_tpu.ops.pallas import chamfer_band as jcb
    from nope_nerf_tpu_torch.geometry.rays import project_to_cam
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    hs, ws = 60, 80
    X, Y, cam = _depth_clouds(hs, ws, 8)
    k = 2
    sx = cb.rows_to_start_tiles(_t(X), hs * ws, (hs, ws), _t(cam),
                                project_to_cam, k)
    jsx = jcb.rows_to_start_tiles(jnp.asarray(X), hs * ws, (hs, ws),
                                  jnp.asarray(cam), jproj, k)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    sy = cb.rows_to_start_tiles(_t(Y), hs * ws, (hs, ws), _t(cam),
                                project_to_cam, k)
    idx = cb.nearest_idx_banded_reference(_t(X), _t(Y), sx, k)
    jidx = jcb.nearest_idx_banded_xla(jnp.asarray(X), jnp.asarray(Y),
                                      jnp.asarray(sx.numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    loss = cb.chamfer_loss_banded(_t(X), _t(Y), sx, sy, k)
    jloss = jcb.chamfer_loss_banded(jnp.asarray(X), jnp.asarray(Y),
                                    jnp.asarray(sx.numpy()),
                                    jnp.asarray(sy.numpy()), k,
                                    use_pallas=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def test_exact_chamfer_loss():
    """The exact mode (the port's direct-distance argmin against JAX's
    score form, then the gather distance) on random clouds; the two forms
    can only swap near-tied neighbours, which moves the mean distance by
    far less than 1e-5."""
    from nope_nerf_tpu.ops.chamfer import chamfer_loss as jchamfer
    from nope_nerf_tpu_torch.ops.chamfer import chamfer_loss

    rng = np.random.default_rng(12)
    X = rng.normal(size=(700, 3)).astype(np.float32)
    Y = rng.normal(size=(900, 3)).astype(np.float32)
    np.testing.assert_allclose(float(chamfer_loss(_t(X), _t(Y))),
                               float(jchamfer(jnp.asarray(X), jnp.asarray(Y),
                                              block=256)), rtol=1e-5)


@pytest.mark.parametrize("depth_type,auto_mask", [("l1", False),
                                                  ("invariant", True)])
def test_total_loss_terms(depth_type, auto_mask):
    from nope_nerf_tpu.losses import total_loss as jtotal
    from nope_nerf_tpu.losses.losses import mse2psnr as jpsnr
    from nope_nerf_tpu_torch.losses.losses import mse2psnr, total_loss
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    rng = np.random.default_rng(9)
    hs, ws = 60, 80
    X, Y, _ = _depth_clouds(hs, ws, 10)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    arrays = {
        "rgb_pred": f(64, 3), "rgb_gt": f(64, 3), "depth_pred": f(64) + 1,
        "depth_gt": f(64) + 1, "depth_valid": (f(64) > 0.2).astype(np.float32),
        "t_list": rng.normal(size=(6, 3)).astype(np.float32), "X": X, "Y": Y,
        "rgb_pc1": f(hs, ws, 3), "rgb_pc1_proj": f(hs, ws, 3),
        "valid_points": (f(hs, ws, 1) > 0.3).astype(np.float32),
        "rgb_pc1_ori": f(hs, ws, 3),
    }
    starts = (np.array([0, 1, 2, 2, 3], np.int32),
              np.array([0, 0, 1, 2, 3], np.int32))
    weights = {"rgb_weight": 1.0, "depth_weight": 0.04, "pc_weight": 1.0,
               "rgb_s_weight": 0.7, "depth_consistency_weight": 0.0,
               "weight_dist_1st_loss": 0.3, "weight_dist_2nd_loss": 0.2}
    kw = dict(w_l1=0.0, w_l2=1.0, depth_loss_type=depth_type,
              with_auto_mask=auto_mask, chamfer_mode="auto",
              chamfer_band_tiles=2)
    out = total_loss(weights, **{k: _t(v) for k, v in arrays.items()},
                     chamfer_starts=tuple(torch.tensor(s) for s in starts),
                     **kw)
    jout = jtotal({k: np.float32(v) for k, v in weights.items()},
                  **{k: jnp.asarray(v) for k, v in arrays.items()},
                  chamfer_starts=tuple(jnp.asarray(s) for s in starts), **kw)
    assert set(out) == set(jout)
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(mse2psnr(0.01)), float(jpsnr(0.01)),
                               rtol=1e-6)
    assert cb.QB == 1024


@pytest.mark.parametrize("auto_mask", [False, True])
def test_rgb_s_loss_with_ssim(auto_mask):
    """``training.with_ssim``: 0.15 |d| + 0.85 SSIM-map on the mask, the
    auto-mask read from the raw diff before the blend. Value at rtol 1e-5
    and both colour gradients at relL2 1e-5 against ``jax.grad``: the same
    f32 arithmetic, the 3x3 box sums in another order."""
    from nope_nerf_tpu.losses.losses import rgb_s_loss as jloss
    from nope_nerf_tpu_torch.losses.losses import rgb_s_loss

    rng = np.random.default_rng(12)
    hs, ws = 20, 28
    rgb1 = rng.uniform(size=(hs, ws, 3)).astype(np.float32)
    rgb2 = np.clip(rgb1 + 0.2 * rng.normal(size=(hs, ws, 3)), 0, 1).astype(
        np.float32)
    ori = rng.uniform(size=(hs, ws, 3)).astype(np.float32)
    valid = (rng.uniform(size=(hs, ws, 1)) > 0.2).astype(np.float32)

    def jf(a, b):
        return jloss(a, b, jnp.asarray(valid), True,
                     rgb2_ori=jnp.asarray(ori) if auto_mask else None)

    jval, jgrads = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(rgb1), jnp.asarray(rgb2))
    a, b = _t(rgb1, True), _t(rgb2, True)
    val = rgb_s_loss(a, b, _t(valid), True,
                     rgb2_ori=_t(ori) if auto_mask else None)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    plain = rgb_s_loss(a, b, _t(valid), False,
                       rgb2_ori=_t(ori) if auto_mask else None)
    assert abs(float(plain) - float(val)) > 1e-3  # the map moved the loss
    for got, want in zip((a.grad, b.grad), jgrads):
        assert _rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("levels,nd_atol,grad_rel", [(4, 1e-5, 1e-4),
                                                   (10, 2e-3, 2e-2)])
def test_render_rays_normal_diff(levels, nd_atol, grad_rel):
    """``rendering.normal_loss``: normal_diff at the prior-depth surface
    points and their jittered neighbours, against the JAX renderer given
    the same jitter (the port's draw replaced by JAX's uniform of the same
    key), and d sum(normal_diff) / d weights against ``jax.grad`` through
    the double backward of the f32 MLP. At 4 position levels: value atol
    1e-5, weight gradients relL2 1e-4. At the stock 10 the top band's
    derivative is 2^9 times its value, and where the density gradient
    nearly vanishes its normal amplifies f32 round-off (at the stock width,
    relL2 against float64 reaches 9.5e-4 over 4,096 random points); the
    two packages sum in other orders: atol 2e-3 and relL2 2e-2."""
    import nope_nerf_tpu_torch.ops.rendering as prender
    from nope_nerf_tpu.geometry.so3 import make_c2w
    from nope_nerf_tpu.ops.rendering import render_rays as jrender

    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.convert import params_from_jax

    tree = jax.device_get(init_nerf_params(jax.random.PRNGKey(3),
                                           _cfg(pos_enc_levels=levels)))
    rng = np.random.default_rng(14)
    cfg = dict(_render_cfg("uniform", False, False), normal_loss=True,
               pos_enc_levels=levels)
    pix = rng.uniform(-1, 1, size=(N_RAYS, 2)).astype(np.float32)
    dep = rng.uniform(0.5, 3.0, size=N_RAYS).astype(np.float32)
    dep[:2] = 0.0  # invalid rays: points_surface is the camera centre
    cam = np.array([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                    [0, 0, 0, 1]], np.float32)
    c2w = np.asarray(make_c2w(jnp.asarray([0.05, -0.1, 0.02]),
                              jnp.asarray([0.1, 0.2, -0.3])))
    world = np.linalg.inv(c2w).astype(np.float32)
    mats = [cam, world, np.eye(4, dtype=np.float32)]
    key = jax.random.PRNGKey(5)
    jitter = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                           (N_RAYS, 3)))

    def jsum(params):
        out = jrender(params, jnp.asarray(pix), jnp.asarray(dep),
                      *map(jnp.asarray, mats), cfg, rng=key, add_noise=False)
        return out["normal_diff"].sum(), out["normal_diff"]

    (_, jnd), jg = jax.value_and_grad(jsum, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    params = params_from_jax({"nerf": tree})["nerf"]
    for layer in params.values():
        for v in layer.values():
            v.requires_grad_(True)
    real = prender.normal_jitter
    prender.normal_jitter = lambda shape, gen, dev: _t(jitter)
    try:
        out = prender.render_rays(params, _t(pix), _t(dep), *map(_t, mats),
                                  cfg)
    finally:
        prender.normal_jitter = real
    nd = out["normal_diff"]
    np.testing.assert_allclose(_np(nd), np.asarray(jnd), atol=nd_atol)
    assert float(nd.min()) > 0 and nd.shape == (N_RAYS,)
    nd.sum().backward()
    for name, layer in params.items():
        for k, v in layer.items():
            if v.grad is None:  # the rgb head: no path from the density
                assert not np.any(np.asarray(jg[name][k])), (name, k)
            else:
                assert _rel_l2(v.grad, jg[name][k]) < grad_rel, (name, k)
    # eval renders and the frozen-weight Phong gradient keep no such term
    assert prender.render_rays(params, _t(pix), _t(dep), *map(_t, mats), cfg,
                               eval_mode=True)["normal_diff"] is None
