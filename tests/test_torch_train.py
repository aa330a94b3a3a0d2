"""The port's training step against the JAX package's, on a small scene
(4 frames of 24x32 images, 48x64 depth priors, hidden 32, 16 samples, 64
rays, 3072-point clouds with the banded Chamfer over 2 of 3 tiles).

Both sides get the same parameters, the same injected ray indices and no
stratified jitter, so every difference is arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_FRAMES, H, W, HD, WD = 4, 24, 32, 48, 64
FRAMES = [(0, 1), (3, 2), (1, 2)]  # (idx, ref_idx); idx 3 takes the swap


class _Scene:
    def __init__(self, rng):
        self.N_imgs, self.H, self.W = N_FRAMES, H, W
        self.K = np.array([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                           [0, 0, 0, 1]], np.float32)
        self.scale_mat = np.eye(4, dtype=np.float32)
        self.c2ws = None
        self.imgs = rng.uniform(size=(N_FRAMES, H, W, 3)).astype(np.float32)
        yy, xx = np.meshgrid(np.linspace(0, 1, HD), np.linspace(0, 1, WD),
                             indexing="ij")
        base = 2.0 + 0.5 * np.sin(3 * xx) * np.cos(2 * yy)
        self.dpt_depth = (base[None] + 0.05 * rng.normal(
            size=(N_FRAMES, HD, WD))).astype(np.float32)


def _cfg(kernel_path):
    from nope_nerf_tpu.config import DEFAULT_CONFIG, load_config

    cfg = load_config(DEFAULT_CONFIG)
    cfg["model"]["hidden_dim"] = 32
    cfg["rendering"]["num_points"] = 16
    cfg["training"].update(n_training_points=64, pc_ratio=1)
    cfg["pose"]["learn_focal"] = True
    cfg["tpu"].update(render_add_noise=False, chamfer_mode="band",
                      use_pallas_mlp=kernel_path, mlp_bf16=kernel_path)
    cfg["_num_cams"] = N_FRAMES
    return cfg


def _scalars():
    w = {"rgb_weight": 1.0, "depth_weight": 0.04, "pc_weight": 1.0,
         "rgb_s_weight": 1.0, "depth_consistency_weight": 0.0,
         "weight_dist_1st_loss": 0.1, "weight_dist_2nd_loss": 0.1}
    lrs = {"nerf": 1e-3, "pose": 5e-4, "focal": 1e-3, "distortion": 5e-4}
    return {"weights": w, "w_l1": 1.0, "w_l2": 0.0, "lrs": lrs}


STATIC = {"render_model": True, "use_ref": True, "use_rgb_s": True}


def _setup(kernel_path):
    from nope_nerf_tpu.training import loop as jloop
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.training import loop as ploop

    rng = np.random.default_rng(11)
    scene = _Scene(rng)
    cfg = _cfg(kernel_path)
    jparams, _ = jloop.build_params(cfg, scene, jax.random.PRNGKey(0))
    # non-trivial poses and distortions so every branch carries gradient
    jparams["pose"] = {"r": jnp.asarray(rng.normal(size=(4, 3)) * 0.02,
                                        jnp.float32),
                       "t": jnp.asarray(rng.normal(size=(4, 3)) * 0.05,
                                        jnp.float32)}
    jparams["distortion"]["shifts"] = jnp.asarray(
        rng.normal(size=(4, 1)) * 0.05, jnp.float32)
    jbatch = jloop.scene_batch_arrays(scene, cfg)
    jbatch["camera_mat_gt"] = jnp.asarray(scene.K)
    jbatch["scale_mat"] = jnp.asarray(scene.scale_mat)
    pbatch = ploop.scene_batch_arrays(scene, cfg, "cpu")
    ray_idx = [rng.integers(0, H * W, size=64) for _ in FRAMES]
    pparams = params_from_jax(jax.device_get(jparams))
    return cfg, jparams, jbatch, pparams, pbatch, ray_idx


def _jbatch(jbatch, i, ray_idx):
    b = dict(jbatch, idx=jnp.int32(FRAMES[i][0]),
             ref_idx=jnp.int32(FRAMES[i][1]))
    b["ray_idx"] = jnp.asarray(ray_idx[i], jnp.int32)
    return b


def _pbatch(pbatch, i, ray_idx):
    return dict(pbatch, idx=FRAMES[i][0], ref_idx=FRAMES[i][1],
                ray_idx=torch.tensor(ray_idx[i]))


def _jloss_and_grad(cfg):
    from nope_nerf_tpu.training.trainer import compute_loss, make_render_cfg

    rc = make_render_cfg(cfg)

    def f(params, batch, scalars):
        return compute_loss(params, batch, scalars, jax.random.PRNGKey(0),
                            cfg=cfg, static=STATIC, render_cfg=rc)

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _pgrads(cfg, pparams, batch, scalars):
    from nope_nerf_tpu_torch.training.trainer import (compute_loss,
                                                      init_train_state,
                                                      make_render_cfg)

    init_train_state(pparams)  # marks every leaf as requiring grad
    loss, aux = compute_loss(pparams, batch, scalars, cfg=cfg, static=STATIC,
                             render_cfg=make_render_cfg(cfg, "cpu"))
    loss.backward()
    return float(loss.detach()), aux


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_slice_trajectory_f32():
    """3 steps, f32 field on both sides (the unfused renderer).

    Losses at rtol 1e-4 and step-1 gradients at relL2 1e-4: the same f32
    arithmetic in another summation order. Parameters after step 3: Adam's
    first steps move each entry by about lr * sign(g), so an entry whose
    gradient is near 0 may move the other way on one side: every entry is
    held to 6 lr (three steps of at most 2 lr each), and entries whose
    step-1 gradient is at least 1e-2 of their leaf's largest to 0.05 lr (a
    1e-4 relative gradient difference grows where a later step's gradient
    is small against the first).
    """
    from nope_nerf_tpu.training.trainer import (init_train_state,
                                                make_render_cfg,
                                                make_train_step)
    from nope_nerf_tpu_torch.training import trainer as pt

    cfg, jparams, jbatch, pparams, pbatch, ray_idx = _setup(False)
    scalars = _scalars()
    jscal = {"weights": {k: np.float32(v) for k, v in
                         scalars["weights"].items()},
             "w_l1": np.float32(1.0), "w_l2": np.float32(0.0),
             "lrs": {k: np.float32(v) for k, v in scalars["lrs"].items()}}

    # step-1 gradients
    (jl, _), jg = _jloss_and_grad(cfg)(jparams, _jbatch(jbatch, 0, ray_idx),
                                       jscal)
    pl, _ = _pgrads(cfg, pparams, _pbatch(pbatch, 0, ray_idx), scalars)
    np.testing.assert_allclose(pl, float(jl), rtol=1e-4)
    jgl = _leaves(jax.device_get(jg))
    pgl = _leaves(pparams)
    assert set(jgl) == set(pgl)
    grad1 = {}
    for k in jgl:
        grad1[k] = np.asarray(jgl[k])
        assert _rel_l2(pgl[k].grad, jgl[k]) < 1e-4, k

    # 3 steps
    for leaf in _leaves(pparams).values():
        leaf.grad = None
    jstate, _ = init_train_state(jparams)
    jstep = make_train_step(cfg, make_render_cfg(cfg))
    pstate = pt.init_train_state(pparams)
    pstep = pt.make_train_step(cfg, pt.make_render_cfg(cfg, "cpu"))
    for i in range(len(FRAMES)):
        jstate, jaux = jstep(jstate, _jbatch(jbatch, i, ray_idx), jscal,
                             jax.random.PRNGKey(i), STATIC)
        pstate, paux = pstep(pstate, _pbatch(pbatch, i, ray_idx), scalars,
                             STATIC)
        for k in ("loss", "loss_rgb", "loss_depth", "loss_pc", "loss_rgb_s",
                  "loss_dist_1st", "loss_dist_2nd"):
            np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                       rtol=1e-4, atol=1e-8, err_msg=k)
    jp = _leaves(jax.device_get(jstate.params))
    pp = _leaves(pstate.params)
    for k, jv in jp.items():
        lr = scalars["lrs"][k.split("/")[0]]
        g = np.abs(grad1[k])
        near_zero = g < 1e-2 * g.max()
        diff = np.abs(pp[k].detach().numpy() - np.asarray(jv))
        assert (diff[~near_zero] <= 0.05 * lr).all(), k
        assert (diff <= 6 * lr).all(), k


def test_slice_step_kernel_path():
    """One step on the bf16 fused-kernel path: the port's Kernel A plain
    version (CPU tensors) against the JAX Pallas kernel in interpret mode.
    The loss agrees to bf16 round-off (rtol 1e-3); the gradients of every
    group at the kernel's relL2 0.02 (tests/test_pallas.py's bar)."""
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk

    cfg, jparams, jbatch, pparams, pbatch, ray_idx = _setup(True)
    scalars = _scalars()
    jscal = {"weights": {k: np.float32(v) for k, v in
                         scalars["weights"].items()},
             "w_l1": np.float32(1.0), "w_l2": np.float32(0.0)}
    jmk.INTERPRET = True
    try:
        (jl, _), jg = _jloss_and_grad(cfg)(
            jparams, _jbatch(jbatch, 0, ray_idx), jscal)
    finally:
        jmk.INTERPRET = False
    pl, _ = _pgrads(cfg, pparams, _pbatch(pbatch, 0, ray_idx), scalars)
    np.testing.assert_allclose(pl, float(jl), rtol=1e-3)
    jgl = _leaves(jax.device_get(jg))
    for k, leaf in _leaves(pparams).items():
        assert _rel_l2(leaf.grad, jgl[k]) < 0.02, k


def test_train_loop_runs_on_cpu(tmp_path):
    """``train`` end to end on the CPU for 2 epochs: finite losses, the
    per-epoch history and the event log."""
    from nope_nerf_tpu_torch.training.loop import train

    cfg = _cfg(False)
    cfg.pop("_num_cams")
    cfg["training"]["out_dir"] = str(tmp_path)
    cfg["tpu"]["render_add_noise"] = True
    scene = _Scene(np.random.default_rng(3))
    scene.sample_ref_idx = lambda i, rng=None: (i - 1 if i == N_FRAMES - 1
                                                else i + 1)
    state, sched, _, hist = train(cfg, max_epochs=2, scene=scene,
                                  device="cpu")
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["step_losses"]).all() and h["steps"] == 4
               for h in hist)
    assert (tmp_path / "logs" / "events.jsonl").stat().st_size > 0
    with pytest.raises(NotImplementedError):
        train(dict(cfg, tpu=dict(cfg["tpu"], rays_per_step_multiplier=2)),
              max_epochs=1, scene=scene, device="cpu")


def test_train_cli_reads_a_scene_from_disk(tmp_path):
    """``python -m nope_nerf_tpu_torch.train <cfg>`` on a synthetic LLFF
    scene written to disk: the CLI loads it with the JAX package's numpy
    loader and trains one epoch on the CPU."""
    import sys

    import yaml

    from nope_nerf_tpu_torch.train import main

    data = tmp_path / "data"
    argv = sys.argv
    sys.argv = ["x", str(data / "synth"), "--frames", "4", "--height", "24",
                "--width", "32"]
    try:
        from tools.make_synthetic_dataset import main as gen

        gen()
    finally:
        sys.argv = argv
    cfg = {
        "dataloading": {"path": str(data), "scene": ["synth"],
                        "resize_factor": None, "spherify": False},
        "model": {"hidden_dim": 32},
        "rendering": {"num_points": 16},
        "training": {"n_training_points": 64, "out_dir": str(tmp_path / "out"),
                     "eval_pose_every": 0, "checkpoint_every": 0,
                     "backup_every": 0, "visualize_every": 0,
                     "vis_reprojection_every": 0},
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main([str(path), "--max-epochs", "1", "--device", "cpu"])
    events = (tmp_path / "out" / "logs" / "events.jsonl").read_text()
    assert "train/psnr" in events
