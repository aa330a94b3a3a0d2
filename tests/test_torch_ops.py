"""Parity of the PyTorch port's host-side modules with the JAX package.

Same inputs, made from a numpy seed, go through the JAX function and its
counterpart in ``nope_nerf_tpu_torch``; f32 on both sides. The bars are
f32 round-off (rtol 1e-5): the port keeps each function's arithmetic.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port)
                                          else port),
                               np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture
def nrng():
    return np.random.default_rng(7)


def test_so3(nrng):
    from nope_nerf_tpu.geometry import so3 as jso3
    from nope_nerf_tpu_torch.geometry import so3

    r = nrng.normal(size=(6, 3)).astype(np.float32)
    r[0] = 0.0
    r[1] = 1e-5  # the small-angle Taylor branch
    t = nrng.normal(size=(6, 3)).astype(np.float32)
    _close(so3.vec2skew(_t(r)), jso3.vec2skew(jnp.asarray(r)))
    _close(so3.exp_so3(_t(r)), jso3.exp_so3(jnp.asarray(r)))
    _close(so3.make_c2w(_t(r), _t(t)), jso3.make_c2w(jnp.asarray(r),
                                                     jnp.asarray(t)))
    # finite gradient at the zero-rotation init
    rz = torch.zeros(3, requires_grad=True)
    so3.exp_so3(rz).sum().backward()
    assert torch.isfinite(rz.grad).all()


def test_rays(nrng):
    from nope_nerf_tpu.geometry import rays as jr
    from nope_nerf_tpu_torch.geometry import rays as pr

    loc, sc = pr.arange_pixels((5, 7))
    jloc, jsc = jr.arange_pixels((5, 7))
    np.testing.assert_array_equal(loc.numpy(), np.asarray(jloc))
    _close(sc, jsc)
    idx = nrng.integers(0, 24 * 32, size=50)
    p, rr, rc = pr.pixels_from_flat_idx(torch.tensor(idx), (24, 32))
    jp, jrr, jrc = jr.pixels_from_flat_idx(jnp.asarray(idx), (24, 32))
    _close(p, jp)
    np.testing.assert_array_equal(rr.numpy(), np.asarray(jrr))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(jrc))

    from nope_nerf_tpu.geometry.so3 import make_c2w

    c2w = np.asarray(make_c2w(jnp.asarray(nrng.normal(size=3), jnp.float32),
                              jnp.asarray(nrng.normal(size=3), jnp.float32)))
    _close(pr.rigid_inv(_t(c2w)), jr.rigid_inv(jnp.asarray(c2w)))
    cam = np.array([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                    [0, 0, 0, 1]], np.float32)
    scale = np.diag([1.5, 1.5, 1.5, 1.0]).astype(np.float32)
    world = np.asarray(jr.rigid_inv(jnp.asarray(c2w)))
    args_p = (_t(cam), _t(world), _t(scale))
    args_j = (jnp.asarray(cam), jnp.asarray(world), jnp.asarray(scale))
    _close(pr.to_world_transform(*args_p), jr.to_world_transform(*args_j))
    _close(pr.origin_to_world(*args_p), jr.origin_to_world(*args_j))
    pix = nrng.uniform(-1, 1, size=(40, 2)).astype(np.float32)
    dep = nrng.uniform(0.5, 3, size=40).astype(np.float32)
    _close(pr.transform_to_world(_t(pix), _t(dep), _t(cam), _t(world),
                                 _t(scale)),
           jr.transform_to_world(jnp.asarray(pix), jnp.asarray(dep),
                                 *args_j))
    _close(pr.image_points_to_world(_t(pix), *args_p),
           jr.image_points_to_world(jnp.asarray(pix), *args_j))
    pts = np.concatenate([nrng.normal(size=(40, 2)),
                          -nrng.uniform(1, 3, size=(40, 1))], 1).astype(np.float32)
    xy, valid = pr.project_to_cam(_t(pts), _t(cam))
    jxy, jvalid = jr.project_to_cam(jnp.asarray(pts), jnp.asarray(cam))
    _close(xy, jxy)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    fxfy = np.array([1.3, 1.7], np.float32)
    _close(pr.camera_mat_from_fxfy(_t(fxfy)),
           jr.camera_mat_from_fxfy(jnp.asarray(fxfy)))
    ro = np.concatenate([nrng.normal(size=(30, 2)) * 0.1,
                         np.full((30, 1), 0.5)], 1).astype(np.float32)
    rd = np.concatenate([nrng.normal(size=(30, 2)) * 0.3,
                         -np.ones((30, 1))], 1).astype(np.float32)
    for a, b in zip(pr.get_ndc_rays_fxfy(_t(fxfy), 1.0, _t(ro), _t(rd)),
                    jr.get_ndc_rays_fxfy(jnp.asarray(fxfy), 1.0,
                                         jnp.asarray(ro), jnp.asarray(rd))):
        _close(a, b)


def test_pose_focal_distortion(nrng):
    from nope_nerf_tpu.models import distortion as jd
    from nope_nerf_tpu.models import intrinsics as ji
    from nope_nerf_tpu.models import pose as jp
    from nope_nerf_tpu_torch.models import distortion as pd
    from nope_nerf_tpu_torch.models import intrinsics as pi
    from nope_nerf_tpu_torch.models import pose as pp

    n = 5
    r = nrng.normal(size=(n, 3)).astype(np.float32) * 0.1
    t = nrng.normal(size=(n, 3)).astype(np.float32)
    init = np.stack([np.eye(4, dtype=np.float32)] * n)
    init[:, :3, 3] = nrng.normal(size=(n, 3))
    for i in (0, 3):
        _close(pp.pose_c2w({"r": _t(r), "t": _t(t)}, i, _t(init)),
               jp.pose_c2w({"r": jnp.asarray(r), "t": jnp.asarray(t)}, i,
                           jnp.asarray(init)))
    for fx_only in (False, True):
        for order in (1, 2):
            jpar = ji.init_focal_params(fx_only, order, [1.6, 1.8])
            ppar = pi.init_focal_params(fx_only, order, [1.6, 1.8])
            assert set(ppar) == set(jpar)
            for k in jpar:
                _close(ppar[k], jpar[k])
            _close(pi.focal_fxfy(ppar, fx_only, order),
                   ji.focal_fxfy(jpar, fx_only, order))
    scales = np.array([[1.2], [0.001], [0.7], [0.9], [1.3]], np.float32)
    shifts = nrng.normal(size=(n, 1)).astype(np.float32)
    for i in range(n):  # incl. the 0.01 floor (i=1) and fix_scaleN (i=4)
        for fix in (True, False):
            s, h = pd.distortion_scale_shift(
                {"scales": _t(scales), "shifts": _t(shifts)}, i, n, fix)
            js, jh = jd.distortion_scale_shift(
                {"scales": jnp.asarray(scales), "shifts": jnp.asarray(shifts)},
                i, n, fix)
            _close(s, js)
            _close(h, jh)


@pytest.mark.parametrize("levels", [4, 10])
def test_encoding(nrng, levels):
    from nope_nerf_tpu.ops.encoding import encode_position as jenc
    from nope_nerf_tpu_torch.ops.encoding import encode_position

    x = nrng.uniform(-3, 3, size=(64, 3)).astype(np.float32)
    # sin(2^9 x) at |x| <= 3: arguments up to ~1.5e3, where one f32 ulp of
    # the argument is ~1e-4; both sides use the same f32 products
    _close(encode_position(_t(x), levels), jenc(jnp.asarray(x), levels),
           atol=1e-5)


def test_interp(nrng):
    from nope_nerf_tpu.ops import interp as ji
    from nope_nerf_tpu_torch.ops import interp as pi

    img = nrng.uniform(size=(24, 32, 3)).astype(np.float32)
    coords = nrng.uniform(-1.2, 1.2, size=(100, 2)).astype(np.float32)
    for mode in ("bilinear", "nearest"):
        for ac in (True, False):
            _close(pi.grid_sample(_t(img), _t(coords), mode, ac),
                   ji.grid_sample(jnp.asarray(img), jnp.asarray(coords), mode,
                                  ac))
    dep = nrng.uniform(size=(24, 32)).astype(np.float32)
    for hw in ((7, 9), (6, 8), (24, 32), (35, 50)):
        _close(pi.resize_nearest(_t(dep), hw),
               ji.resize_nearest(jnp.asarray(dep), hw))
        _close(pi.resize_bilinear(_t(img), hw),
               ji.resize_bilinear(jnp.asarray(img), hw))


def test_scheduler_matches_jax():
    from nope_nerf_tpu.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu.training import scheduler as js
    from nope_nerf_tpu_torch.training import scheduler as ps

    for auto in (True, False):
        cfg = load_config(DEFAULT_CONFIG)
        cfg["training"].update(auto_scheduler=auto, length_smooth=3,
                               patient=2, scheduling_start=20,
                               annealing_epochs=5, scheduling_epoch=30)
        a, b = js.Scheduler(cfg), ps.Scheduler(cfg)
        psnr = [10, 12, 13, 13.5, 13.2, 13.1, 13.0, 12.9, 12.8] + [12.5] * 20
        for epoch, p in enumerate(psnr):
            assert a.weights(epoch) == b.weights(epoch)
            assert a.rgb_loss_switch(epoch) == b.rgb_loss_switch(epoch)
            assert a.applied_lrs(epoch) == b.applied_lrs(epoch)
            assert a.lrs(epoch) == b.lrs(epoch)
            assert a.static_flags(epoch) == b.static_flags(epoch)
            assert a.update_plateau(epoch, p) == b.update_plateau(epoch, p)
            assert a.state.to_dict() == b.state.to_dict()
            assert a.total_epochs == b.total_epochs


@pytest.mark.parametrize("scene_cfg", ["configs/default.yaml",
                                       "configs/Tanks/Ignatius.yaml"])
def test_config_matches_jax(scene_cfg):
    from nope_nerf_tpu import config as jc
    from nope_nerf_tpu_torch import config as pc

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, scene_cfg)
    assert pc.DEFAULT_CONFIG == jc.DEFAULT_CONFIG
    assert pc.load_config(path) == jc.load_config(path)
    a = {"tpu": {"parity": True}}
    b = {"tpu": {"parity": True}}
    assert pc.apply_parity_profile(a) == jc.apply_parity_profile(b)


def test_params_from_jax_round_trip():
    from nope_nerf_tpu.models.distortion import init_distortion_params
    from nope_nerf_tpu.models.intrinsics import init_focal_params
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu.models.pose import init_pose_params
    from nope_nerf_tpu_torch.convert import params_from_jax, params_to_numpy
    from nope_nerf_tpu_torch.ops.kernels.mlp_kernel import collect_weights

    cfg = {"model": {"hidden_dim": 32, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    tree = jax.device_get({
        "nerf": init_nerf_params(jax.random.PRNGKey(0), cfg),
        "pose": init_pose_params(4),
        "focal": init_focal_params(False, 2, [1.6, 1.8]),
        "distortion": init_distortion_params(4),
    })
    port = params_from_jax(tree)
    back = params_to_numpy(port)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), y)
    # the kernel's weight order is the JAX package's W_NAMES order
    from nope_nerf_tpu.ops.pallas import mlp_kernel as jmk

    for pw, jw in zip(collect_weights(port["nerf"]),
                      jmk.collect_weights(tree["nerf"])):
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    with pytest.raises(ValueError):
        params_from_jax({"nerf": {"not_a_layer": np.zeros(1)}})


def test_port_imports_without_jax():
    """The port, its kernel modules and its CLI import with jax blocked,
    and import nothing of the JAX package."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import nope_nerf_tpu_torch, nope_nerf_tpu_torch.train\n"
        "import nope_nerf_tpu_torch.ops.kernels.mlp_kernel\n"
        "import nope_nerf_tpu_torch.ops.kernels.chamfer_band\n"
        "import nope_nerf_tpu_torch.training.loop, nope_nerf_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m.startswith('nope_nerf_tpu.')\n"
        "       or m == 'nope_nerf_tpu' or (m.startswith('jax') and sys.modules[m])]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_wrappers_pick_plain_version_only_for_cpu(nrng):
    """CPU tensors run the plain version and count no launch; a tensor on
    any other non-CUDA device raises (a CUDA tensor launches the kernel)."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    X = _t(nrng.normal(size=(50, 3)))
    Y = _t(nrng.normal(size=(70, 3)))
    starts = torch.zeros(1, dtype=torch.int32)
    n0 = cb.LAUNCHES.count
    np.testing.assert_array_equal(
        cb.nearest_idx_banded(X, Y, starts, 2).numpy(),
        cb.nearest_idx_banded_reference(X, Y, starts, 2).numpy())
    assert cb.LAUNCHES.count == n0
    with pytest.raises(ValueError, match="unsupported device"):
        cb.nearest_idx_banded(X.to("meta"), Y.to("meta"), starts.to("meta"))

    ws = [torch.zeros(s) for s in ((63, 8), (1, 8))]
    with pytest.raises(ValueError, match="unsupported device"):
        mk.fused_mlp_composite([w.to("meta") for w in ws],
                               *(torch.zeros(2, 3, device="meta"),) * 3,
                               *(torch.zeros(2, 4, device="meta"),) * 2,
                               10, 4, "softplus", True, False, False, 4)
