"""Parity of the port's output paths with the JAX package: the field
gradient and occupancy queries, the Phong preview, the training
visualisation and reprojection-pair dumps, the loop's visualisation
triggers, ``tpu.debug_nans`` / ``tpu.profile_dir``, the video writer, and
the novel-view render and pose-visualisation CLIs.

Same numpy inputs (from a seed) go through the JAX function and its port,
f32 on both sides unless a test says otherwise. Every Phong call runs at
6 x 8 rays on a width-32 field, so the JAX package compiles its
ray-marching ops once per file.
"""
import importlib.util
import json
import os
import types
from datetime import datetime, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, L_POS, L_DIR = 32, 4, 2
VIS_HW = (6, 8)
RAD = 4.0
RC = {"occ_activation": "softplus", "pos_enc_levels": L_POS,
      "dir_enc_levels": L_DIR, "dist_alpha": False}


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel_l2(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int32)


def _jax_module(rel_path, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel_path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _FixedClock(datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime(2024, 5, 6, 7, 8, 9, tzinfo=timezone.utc)


@pytest.fixture(scope="module")
def field():
    """A width-32 JAX field with a surface: first layer x4, the density
    head x60 and its bias bisected until ~35% of probe points in [-3, 3]^3
    are occupied above tau = 0.5 (a random field hovers near 0.5
    everywhere). Returns (numpy tree, JAX tree, the port's tensors)."""
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.models.nerf import apply_nerf

    cfg = {"model": {"hidden_dim": D, "pos_enc_levels": L_POS,
                     "dir_enc_levels": L_DIR},
           "rendering": {"white_background": False}}
    tree = jax.device_get(init_nerf_params(jax.random.PRNGKey(3), cfg))
    tree = jax.tree.map(np.array, tree)
    tree["trunk0_0"]["w"] *= 4.0
    tree["fc_density"]["w"] *= 60.0
    port = params_from_jax({"nerf": tree})["nerf"]
    probe = _t(np.random.default_rng(0).uniform(-3, 3, (2048, 3)))
    bias = port["fc_density"]["b"].clone()
    lo, hi = -10.0, 10.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        port["fc_density"]["b"] = bias + mid
        occ = apply_nerf(port, probe, None, RC, only_occupancy=True)
        if float(torch.mean((occ > 0.5).float())) > 0.35:
            hi = mid
        else:
            lo = mid
    tree["fc_density"]["b"] = (tree["fc_density"]["b"] + hi).astype(np.float32)
    return (tree, jax.tree.map(jnp.asarray, tree),
            params_from_jax({"nerf": tree})["nerf"])


def _view():
    """(K, world_mat) of a camera at (0.8, 0.3, 2.4) looking at the origin."""
    from nope_nerf_tpu_torch.utils.synthetic import lookat_c2w

    K = np.array([[1.6, 0, 0, 0], [0, -2.0, 0, 0], [0, 0, -1, 0],
                  [0, 0, 0, 1]], np.float32)
    c2w = lookat_c2w([0.8, 0.3, 2.4], [0.0, 0.0, 0.0])
    return K, np.linalg.inv(c2w).astype(np.float32)


# ---------------------------------------------------------------------------
# the field: raw density, occupancy queries, gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_raw_density_and_occupancy_match_jax(field, bf16):
    """f32: relL2 <= 1e-5. bf16 (``mlp_bf16``): both round the same
    operands to bf16 and accumulate in f32, so they differ only where f32
    order flips a bf16 rounding of an activation; bar relL2 <= 1e-3 (a
    bf16 ulp is 3.9e-3 relative per element)."""
    from nope_nerf_tpu.models import nerf as jn
    from nope_nerf_tpu_torch.models import nerf as pn

    _, jt, pt = field
    pts = np.random.default_rng(1).uniform(-3, 3, (512, 3)).astype(np.float32)
    bar = 1e-3 if bf16 else 1e-5
    jx, jd = jn.raw_density(jt, jnp.asarray(pts), L_POS,
                            dtype=jnp.bfloat16 if bf16 else None)
    px, pd = pn.raw_density(pt, _t(pts), L_POS, bf16)
    assert pd.dtype == torch.float32 and tuple(pd.shape) == (512, 1)
    assert px.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert _rel_l2(pd, jd) <= bar
    assert _rel_l2(px.float(), np.asarray(jx, np.float32)) <= bar
    cfg = dict(RC, mlp_bf16=bf16)
    jo = jn.apply_nerf(jt, jnp.asarray(pts), None, cfg, only_occupancy=True)
    po = pn.apply_nerf(pt, _t(pts), None, cfg, only_occupancy=True)
    assert tuple(po.shape) == (512, 1)
    assert _rel_l2(po, jo) <= bar
    # the full field still returns (rgb, density) with the same density
    rgb, dens = pn.apply_nerf(pt, _t(pts), _t(-pts), cfg)
    assert tuple(rgb.shape) == (512, 3) and torch.equal(dens, po)


def test_only_occupancy_bypasses_kernel_c(field, monkeypatch):
    """With ``use_pallas_mlp`` an occupancy query takes the plain MLP (the
    fused wrapper is never called); a full query still goes to Kernel C."""
    from nope_nerf_tpu_torch.models import nerf as pn
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    _, _, pt = field
    pts = _t(np.random.default_rng(2).uniform(-1, 1, (64, 3)))
    cfg = dict(RC, mlp_bf16=True)
    want = pn.apply_nerf(pt, pts, None, cfg, only_occupancy=True)
    calls = []

    def fused(*args, **kwargs):
        calls.append(1)
        raise AssertionError("Kernel C reached")

    monkeypatch.setattr(mk, "fused_mlp", fused)
    got = pn.apply_nerf(pt, pts, None, dict(cfg, use_pallas_mlp=True),
                        only_occupancy=True)
    assert torch.equal(got, want) and not calls
    with pytest.raises(AssertionError, match="Kernel C reached"):
        pn.apply_nerf(pt, pts, -pts, dict(cfg, use_pallas_mlp=True))


def test_nerf_gradient_matches_jax(field):
    """-grad density against ``jax.grad``: relL2 <= 1e-5; f32 whatever
    ``mlp_bf16`` says; adds nothing to an enclosing graph."""
    from nope_nerf_tpu.models import nerf as jn
    from nope_nerf_tpu_torch.models import nerf as pn

    _, jt, pt = field
    pts = np.random.default_rng(3).uniform(-3, 3, (512, 3)).astype(np.float32)
    want = jn.nerf_gradient(jt, jnp.asarray(pts), RC)
    got = pn.nerf_gradient(pt, _t(pts), RC)
    assert tuple(got.shape) == (512, 3) and _rel_l2(got, want) <= 1e-5
    with torch.no_grad():
        again = pn.nerf_gradient(pt, _t(pts), dict(RC, mlp_bf16=True))
    assert torch.equal(again, got) and not again.requires_grad


# ---------------------------------------------------------------------------
# Phong: sphere intersection, ray marching, shading
# ---------------------------------------------------------------------------


def test_get_sphere_intersection_matches_jax():
    """The hit mask bitwise, misses and hits both; the depths to 1e-5.
    XLA's CPU dot is an FMA chain and torch's is not, so ray . cam differs
    by an f32 ulp (2.4e-7 here), which the square root amplifies near
    tangency: 4.3e-6 at most on these rays."""
    from nope_nerf_tpu.ops.phong import get_sphere_intersection as jsi
    from nope_nerf_tpu_torch.ops.phong import get_sphere_intersection

    rng = np.random.default_rng(4)
    cam = np.array([0.3, 0.2, 2.5], np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for r in (1.5, 4.0):
        ji, jm = jsi(jnp.asarray(cam), jnp.asarray(d), r)
        pi, pm = get_sphere_intersection(_t(cam), _t(d), r)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(pi.numpy(), np.asarray(ji), atol=1e-5)
    assert 0 < np.asarray(jsi(jnp.asarray(cam), jnp.asarray(d), 1.5)[1]).mean() < 1


def _rays(n_rays):
    """The camera of :func:`_view` and ``n_rays`` unit directions around
    its view of the origin."""
    K, world = _view()
    cam = np.linalg.inv(world)[:3, 3].astype(np.float32)
    rng = np.random.default_rng(5)
    d = -cam[None] + rng.normal(scale=0.8, size=(n_rays, 3))
    return cam, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def _proposal_index(occ, n_steps):
    """The first negative-to-positive sign change's index per ray, as
    ``ray_marching`` picks it (numpy)."""
    val = occ - 0.5
    sign = np.sign(val[:, :-1] * val[:, 1:])
    sign = np.concatenate([sign, np.ones_like(sign[:, :1])], axis=1)
    return np.argmin(sign * np.arange(n_steps, 0, -1)[None], axis=1)


def test_ray_marching_matches_jax(field):
    """Trouble: a ray whose occupancy crosses tau within f32 order noise may
    pick another bracket. Rays where both packages found the same proposal
    index must be >= 98% of all; on those the depths agree to 1e-4 and the
    sentinels (+inf: no surface, 0: first sample occupied) exactly. Chunked
    over rays (n_max_network_queries) the port gives the same depths."""
    from nope_nerf_tpu.models.nerf import apply_nerf as japply
    from nope_nerf_tpu.ops.phong import get_sphere_intersection as jsi
    from nope_nerf_tpu.ops.phong import ray_marching as jmarch
    from nope_nerf_tpu_torch.models.nerf import apply_nerf
    from nope_nerf_tpu_torch.ops.phong import (get_sphere_intersection,
                                               ray_marching)

    _, jt, pt = field
    n = VIS_HW[0] * VIS_HW[1]
    cam, d = _rays(n)
    want = np.asarray(jmarch(jt, jnp.asarray(cam), jnp.asarray(d), RC,
                             rad=RAD))
    got = ray_marching(pt, _t(cam), _t(d), RC, rad=RAD).numpy()
    chunked = ray_marching(pt, _t(cam), _t(d),
                           dict(RC, n_max_network_queries=512 * 5), rad=RAD)
    np.testing.assert_array_equal(chunked.numpy(), got)

    t = np.linspace(0.0, 1.0, 512, dtype=np.float32)
    jfar = np.asarray(jsi(jnp.asarray(cam), jnp.asarray(d), RAD)[0])[:, 1]
    pfar = get_sphere_intersection(_t(cam), _t(d), RAD)[0][:, 1].numpy()
    jpts = cam + d[:, None] * (jfar[:, None] * t)[..., None]
    ppts = cam + d[:, None] * (pfar[:, None] * t)[..., None]
    jocc = np.asarray(japply(jt, jnp.asarray(jpts.reshape(-1, 3)), None, RC,
                             only_occupancy=True)).reshape(n, 512)
    pocc = apply_nerf(pt, _t(ppts.reshape(-1, 3)), None, RC,
                      only_occupancy=True).numpy().reshape(n, 512)
    same = _proposal_index(jocc, 512) == _proposal_index(pocc, 512)
    assert same.mean() >= 0.98
    hit = np.isfinite(want) & (want != 0)
    assert hit[same].any() and (~hit[same]).any(), "vacuous comparison"
    np.testing.assert_array_equal(np.isfinite(got[same]),
                                  np.isfinite(want[same]))
    np.testing.assert_array_equal(got[same] == 0, want[same] == 0)
    np.testing.assert_allclose(got[same & hit], want[same & hit], atol=1e-4)


def test_phong_render_matches_jax(field):
    """rgb and rgb_surf to 1e-4 on >= 98% of the rays (the rest may have
    picked another bracket, see test_ray_marching_matches_jax)."""
    from nope_nerf_tpu.geometry.rays import arange_pixels
    from nope_nerf_tpu.ops.phong import phong_render as jphong
    from nope_nerf_tpu_torch.ops.phong import phong_render

    _, jt, pt = field
    K, world = _view()
    pix = np.asarray(arange_pixels(VIS_HW)[1])
    want = jphong(jt, jnp.asarray(pix), jnp.asarray(K), jnp.asarray(world),
                  jnp.eye(4), RC, rad=RAD)
    got = phong_render(pt, _t(pix), _t(K), _t(world), torch.eye(4), RC,
                       rad=RAD)
    rows = np.ones(pix.shape[0], bool)
    for key in ("rgb", "rgb_surf"):
        assert tuple(got[key].shape) == (pix.shape[0], 3)
        rows &= np.all(np.abs(got[key].numpy() - np.asarray(want[key]))
                       <= 1e-4, axis=1)
    assert rows.mean() >= 0.98
    shaded = np.any(np.asarray(want["rgb"]) != 1.0, axis=1)
    assert shaded.any() and (~shaded).any(), "vacuous comparison"


# ---------------------------------------------------------------------------
# the training visualisation and the reprojection-pair dumps
# ---------------------------------------------------------------------------


def _vis_cfg(out_dir):
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config

    cfg = load_config(DEFAULT_CONFIG)
    cfg["model"].update(hidden_dim=D, pos_enc_levels=L_POS,
                        dir_enc_levels=L_DIR)
    cfg["rendering"].update(num_points=16, depth_range=[0.5, 6.0])
    cfg["pose"].update(learn_focal=True, fx_only=False)
    cfg["training"].update(out_dir=str(out_dir), vis_geo=True,
                           vis_resolution=list(VIS_HW))
    return cfg


def test_render_visdata_matches_jax(field, tmp_path):
    """The three PNGs of JAX ``training/visualize.render_visdata`` (learned
    pose on an init_c2w, learned focal) from the same parameters: img and
    depth uint8 within +-1 everywhere, geo within +-1 on >= 98% of the
    pixels (see test_ray_marching_matches_jax)."""
    from nope_nerf_tpu.training.trainer import make_render_cfg as jrcfg
    from nope_nerf_tpu.training.visualize import render_visdata as jvis
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg
    from nope_nerf_tpu_torch.training.visualize import render_visdata

    tree, _, _ = field
    rng = np.random.default_rng(6)
    K, world = _view()
    init_c2w = np.stack([np.linalg.inv(world)] * 3).astype(np.float32)
    params = {"nerf": tree,
              "pose": {"r": rng.normal(scale=0.02, size=(3, 3)),
                       "t": rng.normal(scale=0.05, size=(3, 3))},
              "focal": {"fx": np.float32(1.3), "fy": np.float32(1.4)},
              "distortion": {"scales": np.ones((3, 1)),
                             "shifts": np.zeros((3, 1))}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    scene = types.SimpleNamespace(K=K, scale_mat=np.eye(4, dtype=np.float32))
    cfg = _vis_cfg(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jvis(types.SimpleNamespace(params=jax.tree.map(jnp.asarray, params)),
         cfg, jrcfg(cfg), jnp.asarray(init_c2w), scene, VIS_HW, 7, str(jdir),
         img_idx=1)
    rgb = render_visdata(
        types.SimpleNamespace(params=params_from_jax(params)), cfg,
        make_render_cfg(cfg, "cpu"), _t(init_c2w), scene, VIS_HW, 7,
        str(pdir), img_idx=1)
    assert rgb.shape == (*VIS_HW, 3)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "0001_depth.png", "0001_geo.png", "0001_img.png"]
    for name in ("0001_img.png", "0001_depth.png"):
        assert np.abs(_png(pdir / name) - _png(jdir / name)).max() <= 1, name
    geo_p, geo_j = _png(pdir / "0001_geo.png"), _png(jdir / "0001_geo.png")
    assert (np.abs(geo_p - geo_j).max(-1) <= 1).mean() >= 0.98
    assert (geo_j != 255).any(), "no surface in the geo image"


def _pair_setup(tmp_path):
    """A tiny config and a 4-frame scene of random frames and depths, with
    the JAX parameters and their port."""
    from nope_nerf_tpu.training.loop import build_params as jbuild
    from nope_nerf_tpu_torch.convert import params_from_jax

    rng = np.random.default_rng(8)
    n, h, w = 4, 16, 20
    cfg = _vis_cfg(tmp_path)
    cfg["_num_cams"] = n
    c2ws = np.stack([np.eye(4, dtype=np.float32)] * n)
    c2ws[:, 0, 3] = np.linspace(0.0, 0.2, n)
    scene = types.SimpleNamespace(
        N_imgs=n, H=h, W=w, K=_view()[0], scale_mat=np.eye(4, dtype=np.float32),
        c2ws=c2ws, imgs=rng.uniform(size=(n, h, w, 3)).astype(np.float32),
        dpt_depth=(1.0 + rng.uniform(size=(n, h, w))).astype(np.float32))
    jparams, _ = jbuild(cfg, scene, jax.random.PRNGKey(1))
    jparams = jax.device_get(jparams)
    jparams["pose"] = {k: rng.normal(scale=0.02, size=(n, 3)).astype(
        np.float32) for k in ("r", "t")}
    return cfg, scene, jparams, params_from_jax(jparams)


def test_pair_dump_matches_jax_compute_loss(tmp_path):
    """The dump's arrays (``compute_loss`` with ``static["pair_images"]``,
    no render) against the JAX ``compute_loss``'s: 1e-5; the two PNGs the
    loop's ``dump_pair_images`` writes hold them as uint8 within +-1."""
    from nope_nerf_tpu.training.loop import scene_batch_arrays as jbatch
    from nope_nerf_tpu.training.trainer import compute_loss as jloss
    from nope_nerf_tpu.training.trainer import make_render_cfg as jrcfg
    from nope_nerf_tpu_torch.training.loop import (dump_pair_images,
                                                   scene_batch_arrays)
    from nope_nerf_tpu_torch.training.trainer import (compute_loss,
                                                      make_render_cfg)

    cfg, scene, jparams, pparams = _pair_setup(tmp_path)
    weights = {k: 1.0 for k in ("rgb_weight", "depth_weight", "pc_weight",
                                "rgb_s_weight")}
    weights.update(depth_consistency_weight=0.0, weight_dist_1st_loss=0.0,
                   weight_dist_2nd_loss=0.0)
    scalars = {"weights": weights, "w_l1": 1.0, "w_l2": 0.0}
    static = {"pair_images": True, "render_model": False, "use_ref": True,
              "use_rgb_s": True}
    jb = jbatch(scene, cfg)
    jb.update(camera_mat_gt=jnp.asarray(scene.K),
              scale_mat=jnp.asarray(scene.scale_mat), idx=jnp.int32(1),
              ref_idx=jnp.int32(2))
    jfn = jax.jit(lambda p, b, s: jloss(p, b, s, jax.random.PRNGKey(0),
                                        cfg=cfg, static=static,
                                        render_cfg=jrcfg(cfg))[1])
    jaux = jfn(jax.tree.map(jnp.asarray, jparams), jb,
               jax.tree.map(np.float32, scalars))
    batch0 = scene_batch_arrays(scene, cfg, "cpu")
    rcfg = make_render_cfg(cfg, "cpu")
    with torch.no_grad():
        _, aux = compute_loss(pparams, dict(batch0, idx=1, ref_idx=2),
                              scalars, cfg=cfg, static=static,
                              render_cfg=rcfg)
    for key in ("rgb_pc1", "rgb_pc1_proj"):
        assert tuple(aux[key].shape) == (4, 5, 3)
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]),
                                   atol=1e-5)
    state = types.SimpleNamespace(params=pparams)
    dump_pair_images(state, cfg, rcfg, None, batch0, 1, 2, scalars, 12,
                     str(tmp_path / "rendering"))
    for tag, key in (("img1", "rgb_pc1"), ("img2", "rgb_pc1_proj")):
        want = np.clip(np.asarray(jaux[key]) * 255.0, 0, 255).astype(np.uint8)
        got = _png(tmp_path / "rendering" / f"12_0001_{tag}.png")
        assert np.abs(got - want).max() <= 1
    # without rgb_s there is no pair: nothing is written
    plain = dict(static, pair_images=False)
    with torch.no_grad():
        _, aux = compute_loss(pparams, dict(batch0, idx=1, ref_idx=2),
                              scalars, cfg=cfg, static=plain, render_cfg=rcfg)
    assert "rgb_pc1" not in aux


def _loop_cfg(out_dir):
    from nope_nerf_tpu_torch.utils.synthetic import tiny_config

    cfg = tiny_config(None, str(out_dir), n_training_points=32, num_points=8)
    cfg["model"].update(hidden_dim=D)
    cfg["pose"].update(learn_R=False, learn_t=False, init_pose=True,
                       init_pose_type="gt")
    cfg["training"].update(scheduling_start=0, annealing_epochs=0,
                           auto_scheduler=False, visualize_every=3,
                           vis_reprojection_every=2, vis_geo=True,
                           vis_resolution=list(VIS_HW))
    cfg["tpu"]["epoch_scan"] = False
    return cfg


def test_loop_rendering_names_match_jax(tmp_path):
    """Three epochs of 4 steps: the port's rendering/ tree has the file names
    of the JAX non-scan loop (``tpu.epoch_scan: False``): a visualisation
    at it % 3 == 0 and a pair dump at it % 2 == 0."""
    from nope_nerf_tpu.training.loop import train as jtrain
    from nope_nerf_tpu.utils.synthetic import SyntheticScene
    from nope_nerf_tpu_torch.training.loop import train

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=8)

    def names(out):
        root = out / "rendering"
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    jtrain(_loop_cfg(tmp_path / "jax"), max_epochs=3, scene=scene)
    train(_loop_cfg(tmp_path / "port"), max_epochs=3, scene=scene,
          device="cpu")
    got, want = names(tmp_path / "port"), names(tmp_path / "jax")
    assert got == want
    assert "0006_vis/0000_geo.png" in got
    assert sum(n.endswith("_img1.png") for n in got) >= 2


def test_debug_nans_raises_naming_the_step(tmp_path):
    """``tpu.debug_nans``: a scene whose frames are NaN raises
    FloatingPointError at the first step, naming it."""
    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=8,
                           device="cpu")
    scene.imgs[:] = np.nan
    cfg = _loop_cfg(tmp_path)
    cfg["training"].update(visualize_every=0, vis_reprojection_every=0)
    cfg["tpu"]["debug_nans"] = True
    with pytest.raises(FloatingPointError, match=r"it=0 \(epoch 0"):
        train(cfg, max_epochs=2, scene=scene, device="cpu")


def test_profile_dir_leaves_a_trace(tmp_path):
    """``tpu.profile_dir``: one profile over the run, written as a Chrome
    trace that names the step's ops."""
    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene

    scene = SyntheticScene(n_frames=4, hw=(16, 20), num_points=8,
                           device="cpu")
    cfg = _loop_cfg(tmp_path / "out")
    cfg["training"].update(visualize_every=0, vis_reprojection_every=0)
    cfg["tpu"]["profile_dir"] = str(tmp_path / "prof")
    *_, history = train(cfg, max_epochs=2, scene=scene, device="cpu")
    assert len(history) == 2
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names)


# ---------------------------------------------------------------------------
# the video writer and the CLIs
# ---------------------------------------------------------------------------


def test_write_video(tmp_path, monkeypatch):
    """``.mp4``: the bytes of the JAX ``write_mjpeg_mp4`` at imageio
    quality 9 -> JPEG 85; another suffix: one PNG per frame."""
    from nope_nerf_tpu.utils import mp4 as jmp4
    from nope_nerf_tpu_torch.utils import mp4
    from nope_nerf_tpu_torch.utils.video import write_video

    frames = np.random.default_rng(9).integers(0, 256, (3, 8, 10, 3),
                                               dtype=np.uint8)
    monkeypatch.setattr(mp4, "datetime", _FixedClock)
    monkeypatch.setattr(jmp4, "datetime", _FixedClock)
    path = write_video(str(tmp_path / "v.mp4"), frames)
    jmp4.write_mjpeg_mp4(str(tmp_path / "j.mp4"), frames, fps=30, quality=85)
    assert (tmp_path / "v.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()
    assert path.endswith("v.mp4")
    out = write_video(str(tmp_path / "v.gif"), frames)
    assert sorted(os.listdir(out)) == ["0000.png", "0001.png", "0002.png"]
    np.testing.assert_array_equal(_png(os.path.join(out, "0002.png")),
                                  frames[2])


@pytest.fixture(scope="module")
def run_dir(field, tmp_path_factory):
    """A 9-frame 12x16 scene on disk (the port's dataset writer) and a run
    directory whose checkpoints hold the shaped field and small learned
    poses of its 8 training views; the config renders 3 interp views at
    6 x 8 with the geo pass."""
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.make_synthetic_dataset import main as gen
    from nope_nerf_tpu_torch.training.checkpoints import CheckpointIO

    tree, _, _ = field
    base = tmp_path_factory.mktemp("render_cli")
    gen([str(base / "data" / "synth"), "--frames", "9", "--height", "12",
         "--width", "16", "--device", "cpu"])
    rng = np.random.default_rng(10)
    pose = {k: rng.normal(scale=0.02, size=(8, 3)).astype(np.float32)
            for k in ("r", "t")}
    cfg_yaml = {
        "dataloading": {"path": str(base / "data"), "scene": ["synth"],
                        "resize_factor": None, "spherify": False},
        "model": {"hidden_dim": D, "pos_enc_levels": L_POS,
                  "dir_enc_levels": L_DIR},
        "pose": {"init_pose": True},
        "extract_images": {"traj_option": "interp", "N_novel_imgs": 3,
                           "resolution": list(VIS_HW), "output_geo": True},
    }
    import yaml

    outs = {}
    for who in ("jax", "port"):
        out = base / who
        io = CheckpointIO(str(out))
        io.save("model.npz", {"params": tree})
        io.save("model_pose.npz", {"params": pose})
        cfg = dict(cfg_yaml, training={"out_dir": str(out)})
        path = base / f"{who}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        outs[who] = (out, load_config(str(path), DEFAULT_CONFIG))
    return outs


def test_render_cli_matches_jax(run_dir, monkeypatch):
    """``render.main`` against ``vis/render.py::main`` on the same
    checkpoints: the same artifact tree; img and depth PNGs uint8 +-1,
    geo +-1 on >= 98% of the pixels; the depth ``.npy`` to 1e-4; three
    videos of 3 frames each, whose bytes equal the JAX ``write_mjpeg_mp4``
    of the same frames (at one creation time)."""
    from nope_nerf_tpu.config import DEFAULT_CONFIG as JDEFAULT
    from nope_nerf_tpu.config import load_config as jload
    from nope_nerf_tpu.utils import mp4 as jmp4
    from nope_nerf_tpu_torch import render
    from nope_nerf_tpu_torch.utils import mp4

    monkeypatch.setattr(mp4, "datetime", _FixedClock)
    monkeypatch.setattr(jmp4, "datetime", _FixedClock)
    jout, jcfg = run_dir["jax"]
    pout, pcfg = run_dir["port"]
    jrender = _jax_module("vis/render.py", "jax_render_cli")
    jrender.main(jload(os.path.join(os.path.dirname(str(jout)), "jax.yaml"),
                       JDEFAULT))
    pdir = render.main(pcfg, device="cpu")
    sub = os.path.join("extraction", "extracted_images", "interp")
    jdir = os.path.join(str(jout), sub)
    assert pdir == os.path.join(str(pout), sub)

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(pdir) == tree(jdir)
    for i in range(3):
        name = f"{i:04d}.png"
        for kind in ("img_out", "depth_out"):
            diff = np.abs(_png(os.path.join(pdir, kind, name))
                          - _png(os.path.join(jdir, kind, name)))
            assert diff.max() <= 1, (kind, name)
        geo = np.abs(_png(os.path.join(pdir, "geo_out", name))
                     - _png(os.path.join(jdir, "geo_out", name)))
        assert (geo.max(-1) <= 1).mean() >= 0.98
        np.testing.assert_allclose(
            np.load(os.path.join(pdir, "depth_out", f"{i}.npy")),
            np.load(os.path.join(jdir, "depth_out", f"{i}.npy")), atol=1e-4)
    for kind, video in (("img_out", "img"), ("depth_out", "depth"),
                        ("geo_out", "geo")):
        path = os.path.join(pdir, "video_out", f"{video}.mp4")
        frames, _ = mp4.read_mjpeg_mp4(path)
        assert frames.shape[0] == 3
        assert jmp4.read_mjpeg_mp4(os.path.join(
            jdir, "video_out", f"{video}.mp4"))[0].shape[0] == 3
        pngs = np.stack([np.asarray(Image.open(os.path.join(
            pdir, kind, f"{i:04d}.png")).convert("RGB")) for i in range(3)])
        ref = os.path.join(str(pout), f"ref_{video}.mp4")
        jmp4.write_mjpeg_mp4(ref, pngs, fps=30, quality=85)
        with open(path, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read(), video


def _ply(path):
    """(header and edge lines, vertex coordinates (n, 3), vertex colours)
    of an ASCII PLY line set."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("element vertex"))
            .split()[-1])
    start = lines.index("end_header") + 1
    rows = [ln.split() for ln in lines[start:start + n]]
    return (lines[:start] + lines[start + n:],
            np.array([r[:3] for r in rows], np.float64),
            [r[3:] for r in rows])


@pytest.mark.parametrize("learned", [False, True])
def test_vis_poses_ply_matches_jax(run_dir, tmp_path, learned):
    """``vis_poses.main`` against ``vis/vis_poses.py::main``. At the
    initial poses (zero pose parameters) the ``est_poses.ply`` bytes are
    equal. At learned poses the PLY's full-precision floats carry the f32
    round-off of the pose composition (XLA's FMA matmul against torch's):
    the header, colours and edges equal, the vertices to 1e-6."""
    from nope_nerf_tpu.config import DEFAULT_CONFIG as JDEFAULT
    from nope_nerf_tpu.config import load_config as jload
    from nope_nerf_tpu_torch import vis_poses
    from nope_nerf_tpu_torch.training.checkpoints import CheckpointIO

    _, pcfg = run_dir["port"]
    rng = np.random.default_rng(11)
    pose = {k: (rng.normal(scale=0.05, size=(8, 3)) if learned
                else np.zeros((8, 3))).astype(np.float32) for k in "rt"}
    plys = []
    for who in ("jax", "port"):
        out = tmp_path / who
        CheckpointIO(str(out)).save("model_pose.npz", {"params": pose})
        cfg = dict(pcfg, training=dict(pcfg["training"], out_dir=str(out)))
        if who == "jax":
            jcfg = jload(os.path.join(ROOT, "configs", "default.yaml"),
                         JDEFAULT)
            jcfg.update({k: cfg[k] for k in ("dataloading", "pose",
                                              "extract_images", "training")})
            _jax_module("vis/vis_poses.py", "jax_vis_poses_cli").main(jcfg)
        else:
            assert vis_poses.main(cfg) == str(out / "est_poses.ply")
        plys.append(out / "est_poses.ply")
    if not learned:
        assert plys[0].read_bytes() == plys[1].read_bytes()
        return
    (jrest, jv, jc), (prest, pv, pc) = _ply(plys[0]), _ply(plys[1])
    assert prest == jrest and pc == jc
    np.testing.assert_allclose(pv, jv, atol=1e-6)
