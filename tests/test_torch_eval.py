"""Checkpoints, the loop's pose metrics and resume, and evaluation of the
PyTorch port against the JAX package, at small sizes (hidden 32, 16
samples, 16x20 images). Inputs come from numpy seeds and feed both sides.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

D_SMALL, S_SMALL, HW = 32, 16, (16, 20)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel_l2(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _trajectory(rng, n):
    """(n, 4, 4) c2w on a noisy smooth path."""
    from scipy.spatial.transform import Rotation

    rv = np.cumsum(rng.normal(scale=0.05, size=(n, 3)), axis=0)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = Rotation.from_rotvec(rv).as_matrix()
    out[:, :3, 3] = np.cumsum(rng.normal(scale=0.2, size=(n, 3)), axis=0)
    return out


# ---------------------------------------------------------------------------
# checkpoints: both directions, params and Adam moments
# ---------------------------------------------------------------------------


class _Scene:
    """4 frames of 16x20 on a smooth trajectory."""

    def __init__(self, seed=3):
        rng = np.random.default_rng(seed)
        self.N_imgs, (self.H, self.W) = 4, HW
        self.K = np.array([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                           [0, 0, 0, 1]], np.float32)
        self.scale_mat = np.eye(4, dtype=np.float32)
        self.c2ws = _trajectory(rng, 4).astype(np.float32)
        self.imgs = rng.uniform(size=(4, *HW, 3)).astype(np.float32)
        self.dpt_depth = (1.5 + rng.uniform(size=(4, *HW))).astype(np.float32)

    def sample_ref_idx(self, idx, rng=None):
        return idx - 1 if idx == self.N_imgs - 1 else idx + 1


def _train_cfg(out_dir):
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config

    cfg = load_config(DEFAULT_CONFIG)
    cfg["model"]["hidden_dim"] = D_SMALL
    cfg["rendering"]["num_points"] = S_SMALL
    cfg["training"].update(n_training_points=64, out_dir=str(out_dir),
                           print_every=0, visualize_every=0,
                           vis_reprojection_every=0)
    cfg["pose"]["learn_focal"] = True
    cfg["tpu"].update(use_pallas_mlp=False, mlp_bf16=False)
    return cfg


def _opt_leaf_target(path):
    """A JAX optax leaf's path -> ('count', group) or (moment, param key
    path): ``.inner_states[g].inner_state.mu[g][layer][w]``."""
    keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
    if keys[3] == "count":
        return "count", keys[1]
    return {"mu": "exp_avg", "nu": "exp_avg_sq"}[keys[3]], "/".join(keys[4:])


def _check_moments(jopt_state, pstate, pparams):
    """Every leaf of the JAX optax state equals the port's Adam state of
    the parameter its path names, exactly."""
    by_path = _leaves(pparams)
    groups = {g["name"]: g for g in pstate.optimizer.param_groups}
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jopt_state):
        kind, where = _opt_leaf_target(path)
        if kind == "count":
            p = groups[where]["params"][0]
            assert int(pstate.optimizer.state[p]["step"]) == int(leaf), where
        else:
            st = pstate.optimizer.state[by_path[where]]
            np.testing.assert_array_equal(st[kind].numpy(), np.asarray(leaf),
                                          err_msg=where)
        n += 1
    assert n == 4 + 2 * len(by_path)


def _stepped_port_state(pparams, rng):
    """The port's TrainState after two Adam steps on random gradients."""
    from nope_nerf_tpu_torch.training.trainer import init_train_state

    state = init_train_state(pparams)
    for group in state.optimizer.param_groups:
        group["lr"] = 1e-3
    for _ in range(2):
        for p in _leaves(pparams).values():
            p.grad = _t(rng.normal(size=tuple(p.shape)))
        state.optimizer.step()
    return state


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoints_cross_packages(tmp_path, direction):
    """The four streams with the scheduler scalars and the Adam moments:
    one package's ``save_all`` and the other's ``restore`` give equal
    params and scalars and exactly equal moments (the optax leaf mapping of
    ``convert``)."""
    from nope_nerf_tpu.training import checkpoints as jck
    from nope_nerf_tpu.training import loop as jloop
    from nope_nerf_tpu.training import scheduler as jsched
    from nope_nerf_tpu.training.trainer import TrainState
    from nope_nerf_tpu.training.trainer import init_train_state as jinit
    from nope_nerf_tpu_torch.convert import (adam_state_from_jax_leaves,
                                             params_from_jax)
    from nope_nerf_tpu_torch.training import checkpoints as pck
    from nope_nerf_tpu_torch.training import loop as ploop
    from nope_nerf_tpu_torch.training import scheduler as psched
    from nope_nerf_tpu_torch.training.trainer import init_train_state

    rng = np.random.default_rng(0)
    cfg = _train_cfg(tmp_path)
    scene = _Scene()
    jparams, _ = jloop.build_params(cfg, scene, jax.random.PRNGKey(0))
    jparams["pose"]["t"] = jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)
    fresh = jax.device_get(jloop.build_params(cfg, scene,
                                              jax.random.PRNGKey(1))[0])
    scalars = {"epoch_it": 3, "it": 7, "loss_val_best": 21.5,
               "patient_count": 2, "scheduling_start": 40}

    if direction == "port_to_jax":
        pparams = params_from_jax(jax.device_get(jparams))
        pstate = _stepped_port_state(pparams, rng)
        ploop.save_all(pck.CheckpointIO(str(tmp_path)), pstate,
                       psched.ScheduleState.from_dict(scalars, 0), cfg)
        template = jinit(jax.tree.map(jnp.asarray, fresh))[0].opt_state
        got, sc, jopt = jloop.restore(jck.CheckpointIO(str(tmp_path)), cfg,
                                      dict(fresh), opt_template=template)
        want = _leaves(pparams)
        for k, v in _leaves(jax.device_get(got)).items():
            np.testing.assert_array_equal(np.asarray(v), want[k].detach(),
                                          err_msg=k)
        _check_moments(jopt, pstate, pparams)
    else:
        jstate = jinit(jparams)[0]
        jopt = jax.tree.map(
            lambda a: (jnp.asarray(rng.integers(1, 99), jnp.int32)
                       if a.dtype == jnp.int32 else
                       jnp.asarray(rng.normal(size=a.shape), jnp.float32)),
            jstate.opt_state)
        jloop.save_all(jck.CheckpointIO(str(tmp_path)),
                       TrainState(params=jparams, opt_state=jopt),
                       jsched.ScheduleState.from_dict(scalars, 0), cfg)
        got, sc, leaves = ploop.restore(
            pck.CheckpointIO(str(tmp_path)), cfg,
            params_from_jax(fresh), "cpu")
        want = _leaves(jax.device_get(jparams))
        for k, v in _leaves(got).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                          err_msg=k)
        pstate = init_train_state(got)
        adam_state_from_jax_leaves(pstate.optimizer, leaves)
        _check_moments(jopt, pstate, got)
    assert sc == scalars


def test_adam_leaves_shape_mismatch_raises():
    """Moments of a run with another scene size do not load (the caller's
    moments start fresh), and the optimizer is left unchanged."""
    from nope_nerf_tpu_torch.convert import (adam_state_from_jax_leaves,
                                             adam_state_to_jax_leaves)
    from nope_nerf_tpu_torch.models.pose import init_pose_params
    from nope_nerf_tpu_torch.training.trainer import init_train_state

    def params(n):
        return {"nerf": {"trunk0_0": {"w": torch.zeros(3, 2),
                                      "b": torch.zeros(2)}},
                "pose": init_pose_params(n), "focal": {"fx": torch.ones(())},
                "distortion": {"scales": torch.ones(n, 1),
                               "shifts": torch.zeros(n, 1)}}

    leaves = adam_state_to_jax_leaves(init_train_state(params(4)).optimizer)
    assert [np.shape(a) for a in leaves[:3]] == [(), (4, 1), (4, 1)]
    other = init_train_state(params(5)).optimizer
    with pytest.raises(ValueError, match="mismatch"):
        adam_state_from_jax_leaves(other, leaves)
    with pytest.raises(ValueError, match="mismatch"):
        adam_state_from_jax_leaves(other, leaves[:-1])
    assert not other.state


def test_checkpoint_io_format(tmp_path):
    """Lists survive the '/'-joined paths, saves are atomic (no tmp file
    left), a URL is refused, ``backup_model_best`` numbers its copies."""
    from nope_nerf_tpu.training.checkpoints import load_pytree
    from nope_nerf_tpu_torch.training.checkpoints import CheckpointIO

    io = CheckpointIO(str(tmp_path))
    tree = {"a": [np.arange(3.0), np.ones((2, 2))], "b": {"c": np.zeros(1)}}
    io.save("model_best.npz", tree, opt_leaves=[np.int32(5)], x=1.5)
    assert sorted(os.listdir(tmp_path)) == ["model_best.npz"]
    got, sc, leaves = io.load("model_best.npz")
    jtree, jsc = load_pytree(str(tmp_path / "model_best.npz"))
    for t in (got, jtree):
        np.testing.assert_array_equal(t["a"][1], tree["a"][1])
        np.testing.assert_array_equal(t["b"]["c"], tree["b"]["c"])
    assert sc == jsc == {"x": 1.5} and [int(v) for v in leaves] == [5]
    with pytest.raises(ValueError, match="run directory"):
        io.load("https://example.invalid/model.npz")
    with pytest.raises(FileNotFoundError):
        io.load("missing.npz")
    io.backup_model_best()
    io.backup_model_best()
    assert sorted(os.listdir(tmp_path / "backup_model_best")) == [
        "0_model_best.npz", "1_model_best.npz"]


def test_train_resumes_and_scores_poses(tmp_path):
    """A port run writes the four streams, ``eval/ate_trans`` events and
    (``log_scale_shift_per_view``) per-view scale / shift events; a second
    run in the same directory resumes at the saved it / epoch_it with
    identical params and moments, and trains on from there."""
    import json

    from nope_nerf_tpu_torch.convert import params_to_numpy
    from nope_nerf_tpu_torch.training.loop import train

    cfg = _train_cfg(tmp_path)
    cfg["training"].update(log_scale_shift_per_view=True, print_every=4)
    # step by step: the JAX non-scan loop's triggers (the scan path's are
    # tests/test_torch_scan.py's)
    cfg["tpu"]["epoch_scan"] = False
    scene = _Scene()
    s1, sched1, _, h1 = train(cfg, max_epochs=2, scene=scene, device="cpu")
    # the four streams, and their backups at it 0 (backup_every and
    # checkpoint_every divide it 0, as in the JAX non-scan loop)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz")) == [
        f"model{g}{s}.npz" for g in ("", "_distortion", "_focal", "_pose")
        for s in ("", "_0")]
    assert all(np.isfinite(h["ate_trans"]) for h in h1)
    events = [json.loads(line) for line in
              (tmp_path / "logs" / "events.jsonl").read_text().splitlines()]
    tags = {e["tag"] for e in events}
    assert {"eval/ate_trans", "eval/rpe_trans", "eval/rpe_rot"} <= tags
    assert {f"train/{k}view {i:02d}" for k in ("scale", "shift")
            for i in range(4)} <= tags

    s2, sched2, _, h2 = train(cfg, max_epochs=2, scene=scene, device="cpu")
    assert h2 == [] and sched2.state.it == sched1.state.it == 7
    a, b = _leaves(params_to_numpy(s1.params)), _leaves(
        params_to_numpy(s2.params))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for p1, p2 in zip(_leaves(s1.params).values(), _leaves(s2.params).values()):
        st1, st2 = s1.optimizer.state[p1], s2.optimizer.state[p2]
        assert int(st1["step"]) == int(st2["step"]) == 8
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st1[key], st2[key])

    _, sched3, _, h3 = train(cfg, max_epochs=5, scene=scene, device="cpu")
    assert [h["epoch"] for h in h3] == [4] and h3[0]["it"] == 11


def test_reset_mode_and_no_device(tmp_path, monkeypatch):
    """``scheduling_mode: reset`` re-initialises the field in place when the
    plateau fires (here forced after the last epoch): the params are the
    generator's next draw, the optimizer holds the same tensors and keeps
    its moments. Without ``device``, ``train`` and the eval CLI raise on a
    machine without CUDA."""
    from nope_nerf_tpu_torch import eval as peval
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.training import loop as ploop

    cfg = _train_cfg(tmp_path)
    cfg["training"]["scheduling_mode"] = "reset"
    real = ploop.Scheduler.update_plateau

    def fire_at_1(self, epoch, psnr):
        real(self, epoch, psnr)
        if epoch == 1:
            self.state.scheduling_start = epoch
            return True
        return False

    monkeypatch.setattr(ploop.Scheduler, "update_plateau", fire_at_1)
    state, _, _, _ = ploop.train(cfg, max_epochs=2, scene=_Scene(),
                                 device="cpu")
    gen = torch.Generator().manual_seed(cfg["training"]["seed"])
    init_nerf_params(gen, cfg)
    want = init_nerf_params(gen, cfg)
    nerf = state.params["nerf"]
    for name, layer in want.items():
        for k, v in layer.items():
            assert torch.equal(nerf[name][k].detach(), v), (name, k)
    opt_params = {id(p) for g in state.optimizer.param_groups
                  for p in g["params"]}
    for t in _leaves(nerf).values():
        assert id(t) in opt_params
        st = state.optimizer.state[t]
        assert int(st["step"]) == 8 and torch.any(st["exp_avg"] != 0)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ploop.train(cfg, max_epochs=1, scene=_Scene())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.main(cfg, train_scene=_Scene(), eval_scene=_Scene())


# ---------------------------------------------------------------------------
# host metrics
# ---------------------------------------------------------------------------


def test_align_ate_rpe_and_depth_metrics():
    """Alignment, ATE / RPE, the binned relative errors and the depth suite
    equal the JAX package's functions to 1e-9 on random trajectories."""
    from nope_nerf_tpu.evaluation import metrics as jm
    from nope_nerf_tpu.evaluation import trajectory_errors as jte
    from nope_nerf_tpu.geometry import align as ja
    from nope_nerf_tpu_torch.evaluation import metrics as pm
    from nope_nerf_tpu_torch.evaluation import trajectory_errors as pte
    from nope_nerf_tpu_torch.geometry import align as pa

    rng = np.random.default_rng(1)
    a, b, c = (_trajectory(rng, 12) for _ in range(3))

    def close(x, y):
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64), rtol=1e-9,
                                   atol=1e-9)

    for method in ("sim3", "se3", "posyaw", "none"):
        close(pa.align_ate_c2b_use_a2b(a, b, c, method),
              ja.align_ate_c2b_use_a2b(a, b, c, method))
    # (the JAX function scales a float64 traj_c in place: give it a copy)
    for x, y in zip(pa.align_scale_c2b_use_a2b(a, b, c),
                    ja.align_scale_c2b_use_a2b(a, b, c.copy())):
        close(x, y)
    aligned = pa.align_ate_c2b_use_a2b(a, b)
    close(pa.compute_ate(b, aligned), ja.compute_ate(b, aligned))
    close(pa.compute_rpe(b, aligned), ja.compute_rpe(b, aligned))
    pb = pte.compute_relative_errors_binned(b, aligned, [0.3, 1.0])
    jb = jte.compute_relative_errors_binned(b, aligned, [0.3, 1.0])
    assert pb.keys() == jb.keys()
    for k in pb:
        assert pb[k]["num_pairs"] == jb[k]["num_pairs"] > 0
        for stat in ("rel_trans", "rel_rot_deg"):
            for s in pb[k][stat]:
                close(pb[k][stat][s], jb[k][stat][s])
    for x, y in zip(pte.compute_absolute_error(
            aligned[:, :3, 3], aligned[:, :3, :3], b[:, :3, 3], b[:, :3, :3]),
            jte.compute_absolute_error(
            aligned[:, :3, 3], aligned[:, :3, :3], b[:, :3, 3], b[:, :3, :3])):
        close(x, y)
    gts = [rng.uniform(0.5, 5.0, size=50) for _ in range(3)]
    preds = [g * rng.uniform(0.8, 1.3, size=50) for g in gts]
    for x, y in zip(pm.median_scaled_depth_errors(gts, preds),
                    jm.median_scaled_depth_errors(gts, preds)):
        close(x, y)
    close(pm.mse2psnr(0.01), jm.mse2psnr(0.01))


def test_ssim_matches_jax():
    """``ssim`` and ``ssim_loss_map`` within atol 1e-5 of the JAX package's.
    The near-constant pair (0.5 +- 1e-3) is the case reduced precision
    breaks; it is held for ``ssim`` only: in the 3x3 loss map, f32 itself
    errs by ~5e-5 there (both packages, against a float64 evaluation)."""
    from nope_nerf_tpu.ops.ssim import ssim as jssim
    from nope_nerf_tpu.ops.ssim import ssim_loss_map as jmap
    from nope_nerf_tpu_torch.ops import ssim as ps

    rng = np.random.default_rng(2)
    x = rng.uniform(size=(*HW, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, HW[0]), np.linspace(0, 1, HW[1]),
                         indexing="ij")
    smooth = np.stack([np.sin(3 * xx + c) * np.cos(2 * yy) * 0.4 + 0.5
                       for c in range(3)], -1).astype(np.float32)
    flat = np.full_like(x, 0.5) + 1e-3 * rng.normal(size=x.shape).astype(
        np.float32)
    for a, b in ((x, y), (smooth, y), (flat, flat[::-1].copy())):
        np.testing.assert_allclose(float(ps.ssim(_t(a), _t(b))),
                                   float(jssim(jnp.asarray(a),
                                               jnp.asarray(b))), atol=1e-5)
    for a, b in ((x, y), (smooth, y)):
        np.testing.assert_allclose(
            ps.ssim_loss_map(_t(a), _t(b)).numpy(),
            np.asarray(jmap(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)


# ---------------------------------------------------------------------------
# rendering and eval_image
# ---------------------------------------------------------------------------


def _render_cfg(fused):
    return {
        "num_points": S_SMALL, "outside_steps": 0, "depth_range": [0.1, 4.0],
        "sample_option": "uniform", "dist_alpha": False, "use_ray_dir": True,
        "normalise_ray": True, "white_background": False,
        "normal_loss": False, "occ_activation": "softplus",
        "pos_enc_levels": 10, "dir_enc_levels": 4, "hidden_dim": D_SMALL,
        "n_max_network_queries": 2 ** 21, "mlp_bf16": fused,
        "use_pallas_mlp": fused, "fuse_compositing": True,
    }


@pytest.fixture(scope="module")
def nerf():
    from nope_nerf_tpu.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.convert import params_from_jax

    cfg = {"model": {"hidden_dim": D_SMALL, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    tree = jax.device_get(init_nerf_params(jax.random.PRNGKey(4), cfg))
    return tree, params_from_jax({"nerf": tree})["nerf"]


def _view():
    from nope_nerf_tpu.geometry.so3 import make_c2w

    cam = np.array([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                    [0, 0, 0, 1]], np.float32)
    c2w = np.asarray(make_c2w(jnp.asarray([0.05, -0.1, 0.02]),
                              jnp.asarray([0.1, 0.2, -0.3])))
    return cam, np.linalg.inv(c2w).astype(np.float32), np.eye(4,
                                                              dtype=np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_render_image_matches_jax(nerf, fused):
    """Chunks of 128 rays (the last one padded) against the JAX
    ``render_image``. f32 route: rgb atol 1e-5, depth rtol 1e-4. Fused
    route (Kernel A's plain version against the Pallas kernel in interpret
    mode): tests/test_torch_render.py's bars, rgb atol 0.03 and depth rgb's
    bar times the far plane 4."""
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu.ops.rendering import render_image as jrender
    from nope_nerf_tpu_torch.ops.rendering import render_image

    cam, world, scale = _view()
    cfg = _render_cfg(fused)
    res = (16, 20) if not fused else (15, 21)  # distinct JAX jit-cache keys
    rgb, depth = render_image(nerf[1], res, _t(cam), _t(world), _t(scale),
                              cfg, chunk=128)
    jmk.INTERPRET = fused
    try:
        jrgb, jdepth = jrender(jax.tree.map(jnp.asarray, nerf[0]), res,
                               cam, world, scale, cfg, chunk=128)
    finally:
        jmk.INTERPRET = False
    assert rgb.shape == (*res, 3) and depth.shape == res
    if fused:
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=0.03)
        np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth),
                                   atol=0.03 * 4.0)
    else:
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5)
        np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth),
                                   rtol=1e-4)


@pytest.mark.parametrize("src,dst", [((16, 20), (9, 13)), ((16, 20), (37, 41)),
                                     ((15, 21), (15, 21)), ((7, 5), (14, 10))])
def test_resize_like_cv2(src, dst):
    import cv2

    from nope_nerf_tpu_torch.evaluation.eval_images import resize_like_cv2

    rng = np.random.default_rng(sum(src + dst))
    img = rng.uniform(size=(*src, 3)).astype(np.float32)
    dep = rng.uniform(0.5, 4.0, size=src).astype(np.float32)
    size = (dst[1], dst[0])
    np.testing.assert_allclose(resize_like_cv2(img, dst).numpy(),
                               cv2.resize(img, size), atol=1e-6)
    np.testing.assert_allclose(
        resize_like_cv2(dep, dst, "nearest").numpy(),
        cv2.resize(dep, size, interpolation=cv2.INTER_NEAREST), atol=1e-6)


@pytest.fixture(scope="module")
def teacher():
    """The JAX package's synthetic teacher scene (4 views of 16x20) and its
    field carried over to the port."""
    from nope_nerf_tpu.utils.synthetic import SyntheticScene
    from nope_nerf_tpu_torch.convert import params_from_jax

    scene = SyntheticScene(n_frames=4, hw=HW, num_points=S_SMALL)
    port = params_from_jax({"nerf": jax.device_get(scene.teacher)})["nerf"]
    rcfg = dict(scene.teacher_render_cfg, mlp_bf16=False,
                use_pallas_mlp=False, fuse_compositing=True)
    return scene, port, rcfg


def test_eval_image_matches_jax(teacher, tmp_path):
    """PSNR within 1e-3 dB and SSIM within 1e-5 of the JAX ``eval_image``,
    the depth metrics' nearest resize to a gt of another size, and the
    three PNGs."""
    from nope_nerf_tpu.evaluation.eval_images import eval_image as jeval
    from nope_nerf_tpu_torch.evaluation.eval_images import eval_image

    scene, port, rcfg = teacher
    world = np.linalg.inv(scene.c2ws[1]).astype(np.float32)
    rng = np.random.default_rng(6)
    img_gt = np.clip(scene.imgs[1] + 0.02 * rng.normal(size=(*HW, 3)), 0,
                     1).astype(np.float32)
    dgt = (scene.dpt_depth[1][::2, ::2] * 1.1).astype(np.float32)
    out = eval_image(port, rcfg, HW, scene.K, world, scene.scale_mat, img_gt,
                     depth_gt=dgt, render_dir=str(tmp_path), img_idx=3,
                     chunk=96)
    jout = jeval(scene.teacher, rcfg, HW, scene.K, world, scene.scale_mat,
                 img_gt, depth_gt=dgt, chunk=96)
    assert abs(out["psnr"] - jout["psnr"]) < 1e-3
    assert abs(out["ssim"] - jout["ssim"]) < 1e-5
    assert np.isnan(out["lpips"])
    np.testing.assert_allclose(out["depth_pred"], jout["depth_pred"],
                               rtol=1e-4)
    np.testing.assert_array_equal(out["depth_gt"], jout["depth_gt"])
    for sub in ("img_out", "depth_out", "img_gt_out"):
        assert (tmp_path / sub / "0003.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# test-time pose optimisation
# ---------------------------------------------------------------------------


def test_all_poses_matches_jax():
    from nope_nerf_tpu.models.pose import all_poses as jall
    from nope_nerf_tpu_torch.models.pose import all_poses

    rng = np.random.default_rng(7)
    pose = {k: rng.normal(scale=0.1, size=(5, 3)).astype(np.float32)
            for k in ("r", "t")}
    init = _trajectory(rng, 5).astype(np.float32)
    for i in (None, init):
        np.testing.assert_allclose(
            all_poses({k: _t(v) for k, v in pose.items()},
                      None if i is None else _t(i)).numpy(),
            np.asarray(jall(jax.tree.map(jnp.asarray, pose),
                            None if i is None else jnp.asarray(i))),
            rtol=1e-5, atol=1e-6)


def test_init_eval_poses_and_lr_schedule():
    from nope_nerf_tpu.evaluation import pose_opt as jpo
    from nope_nerf_tpu_torch.evaluation import pose_opt as ppo

    rng = np.random.default_rng(8)
    learned, colmap = _trajectory(rng, 14), _trajectory(rng, 14)
    gt_eval = _trajectory(rng, 2)
    for method in ("pre", "scale", "ate", "none"):
        p = ppo.init_eval_poses(method, gt_eval, learned, colmap, 8, 2)
        j = jpo.init_eval_poses(method, gt_eval, learned, colmap, 8, 2)
        if method == "none":
            assert p is None and j is None
        else:
            np.testing.assert_array_equal(p, j)
    for e, lr in ((1000, 1e-3), (7, 5e-4), (2, 1e-3)):
        np.testing.assert_array_equal(ppo.lr_schedule(e, lr),
                                      jpo.lr_schedule(e, lr))


def test_pose_opt_step_matches_jax_grad(nerf):
    """Loss and (r, t) gradient of one pose-opt step at an injected ray
    index against ``jax.grad`` of the same composition of the JAX package's
    public functions (pose_c2w -> rigid_inv -> render_rays): relL2 1e-4."""
    from nope_nerf_tpu.geometry.rays import pixels_from_flat_idx, rigid_inv
    from nope_nerf_tpu.models.pose import pose_c2w
    from nope_nerf_tpu.ops.rendering import render_rays
    from nope_nerf_tpu_torch.evaluation.pose_opt import pose_opt_loss

    rng = np.random.default_rng(9)
    cam, _, scale = _view()
    cfg = _render_cfg(False)
    imgs = rng.uniform(size=(2, *HW, 3)).astype(np.float32)
    init = _trajectory(rng, 2).astype(np.float32)
    pose = {"r": rng.normal(scale=0.05, size=(2, 3)).astype(np.float32),
            "t": rng.normal(scale=0.1, size=(2, 3)).astype(np.float32)}
    ray_idx = rng.integers(0, HW[0] * HW[1], size=64)
    jnerf = jax.tree.map(jnp.asarray, nerf[0])

    def jloss(pp):
        c2w = pose_c2w(pp, 1, jnp.asarray(init))
        p, _, _ = pixels_from_flat_idx(jnp.asarray(ray_idx), HW)
        out = render_rays(jnerf, p, jnp.ones(64), jnp.asarray(cam),
                          rigid_inv(c2w), jnp.asarray(scale), cfg,
                          add_noise=False, eval_mode=True)
        gt = jnp.asarray(imgs[1]).reshape(-1, 3)[jnp.asarray(ray_idx)]
        return jnp.mean((out["rgb"] - gt) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, pose))
    pp = {k: _t(v).requires_grad_() for k, v in pose.items()}
    loss = pose_opt_loss(pp, nerf[1], _t(imgs), _t(cam), _t(scale), 1,
                         torch.tensor(ray_idx), _t(init), cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    for k in ("r", "t"):
        assert _rel_l2(pp[k].grad, jg[k]) < 1e-4, k


def test_pose_opt_recovers_perturbation(teacher):
    """The JAX package's teacher through ``convert.params_from_jax``: the
    port's optimisation from a perturbed pose cuts the photometric error
    as tests/test_data_eval.py asks of the JAX one (MSE ratio < 0.8)."""
    from scipy.spatial.transform import Rotation

    from nope_nerf_tpu_torch.evaluation.pose_opt import optimize_eval_poses
    from nope_nerf_tpu_torch.geometry.rays import arange_pixels
    from nope_nerf_tpu_torch.ops.rendering import render_rays

    scene, port, rcfg = teacher
    init = scene.c2ws[:1].copy()
    init[0, :3, :3] = (Rotation.from_rotvec([0.0, 0.15, 0.0]).as_matrix()
                       @ init[0, :3, :3])
    init[0, :3, 3] += np.array([0.3, 0.1, -0.2])
    imgs = _t(scene.imgs[:1])

    def mse_at(c2w):
        _, p = arange_pixels(HW)
        with torch.no_grad():
            out = render_rays(port, p, torch.ones(HW[0] * HW[1]), _t(scene.K),
                              _t(np.linalg.inv(c2w)), torch.eye(4), rcfg,
                              eval_mode=True)
        return float(torch.mean((out["rgb"] - imgs[0].reshape(-1, 3)) ** 2))

    c2ws, pose = optimize_eval_poses(port, scene.K, {}, rcfg, imgs,
                                     np.eye(4, dtype=np.float32), init,
                                     num_epoch=150, lr=1e-3, n_points=128)
    assert c2ws.shape == (1, 4, 4) and not port["trunk0_0"]["w"].requires_grad
    before, after = mse_at(init[0]), mse_at(c2ws[0])
    assert after < before * 0.8, (before, after)


# ---------------------------------------------------------------------------
# the CLI chain on a scene on disk
# ---------------------------------------------------------------------------


def test_cli_chain_train_eval_eval_poses(tmp_path, capsys):
    """tools/make_synthetic_dataset.py (with gt depths) -> ``python -m
    nope_nerf_tpu_torch.train --device cpu`` (checkpoints and
    ``eval/ate_trans`` events) -> the port's ``eval`` (2 pose epochs, the
    depth table) and ``eval_poses``, whose ATE/RPE line the JAX package's
    ``evaluation/eval_poses.py`` prints alike from the port's checkpoints."""
    import importlib.util
    import sys

    import yaml

    from nope_nerf_tpu.config import load_config as jload
    from nope_nerf_tpu_torch import eval as peval
    from nope_nerf_tpu_torch import eval_poses as peval_poses
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config
    from nope_nerf_tpu_torch.train import main as train_main

    data = tmp_path / "data"
    argv = sys.argv
    sys.argv = ["x", str(data / "synth"), "--frames", "9", "--height", "16",
                "--width", "20", "--gt-depth"]
    try:
        from tools.make_synthetic_dataset import main as gen

        gen()
    finally:
        sys.argv = argv
    out = tmp_path / "out"
    cfg = {
        "dataloading": {"path": str(data), "scene": ["synth"],
                        "resize_factor": None, "spherify": False,
                        "with_depth": True},
        "model": {"hidden_dim": D_SMALL},
        "rendering": {"num_points": S_SMALL},
        "training": {"n_training_points": 64, "out_dir": str(out),
                     "checkpoint_every": 0, "backup_every": 0,
                     "visualize_every": 0, "vis_reprojection_every": 0},
        "eval_pose": {"opt_pose_epoch": 2, "n_points": 64},
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_main([str(path), "--max-epochs", "2", "--device", "cpu"])
    assert (out / "model.npz").exists() and (out / "model_pose.npz").exists()
    assert "eval/ate_trans" in (out / "logs" / "events.jsonl").read_text()

    res = peval.main(load_config(str(path), DEFAULT_CONFIG), eval_depth=True,
                     device="cpu")
    printed = capsys.readouterr().out
    assert "   0 img: PSNR: " in printed and "Mean MSE: " in printed
    assert "abs_rel" in printed
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
    edir = out / "extraction" / "eval" / "pre"
    for sub in ("img_out", "depth_out", "img_gt_out"):
        assert (edir / sub / "0000.png").exists()
    assert (edir / "video_out" / "img.mp4").stat().st_size > 0

    mine = peval_poses.main(load_config(str(path), DEFAULT_CONFIG))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    spec = importlib.util.spec_from_file_location(
        "jax_eval_poses", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "evaluation", "eval_poses.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    theirs = jmod.main(jload(str(path), DEFAULT_CONFIG))
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    for k in ("rpe_trans", "rpe_rot_deg", "ate"):
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-4, atol=1e-6)


def test_ate_of_a_trajectory_that_never_moved():
    """Learned poses all at one place (poses that never left their
    identity start): the JAX package's Sim(3) alignment divides by zero;
    the port's takes the least-squares limit, scale 0, which maps them onto
    the gt trajectory's mean, so the ATE is the RMS spread of the gt
    positions about their mean (1e-12)."""
    from nope_nerf_tpu.geometry import align as ja
    from nope_nerf_tpu_torch.geometry import align as pa

    rng = np.random.default_rng(2)
    gt = _trajectory(rng, 10)
    still = np.tile(np.eye(4), (10, 1, 1))
    with pytest.raises(ZeroDivisionError):
        ja.align_ate_c2b_use_a2b(still, gt)
    aligned = pa.align_ate_c2b_use_a2b(still, gt)
    spread = np.sqrt(np.mean(np.sum(
        (gt[:, :3, 3] - gt[:, :3, 3].mean(0)) ** 2, axis=1)))
    np.testing.assert_allclose(pa.compute_ate(gt, aligned), spread,
                               rtol=1e-12)
    np.testing.assert_allclose(aligned[:, :3, 3],
                               np.tile(gt[:, :3, 3].mean(0), (10, 1)),
                               atol=1e-12)
