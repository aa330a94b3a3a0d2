"""The port's scan paths against the JAX package's: ``make_epoch_step``
(``tpu.epoch_scan``, the stock config's loop), the scan branch of the
training loop (pipelined epoch metrics, the triggers that fire when an
epoch crosses a multiple, the eager modes), the block-scanned test-time
pose optimisation and the bench's layout. On the CPU the port runs the
same step body eagerly that the card replays from a CUDA graph
(``tests/test_torch_cuda.py`` holds a captured epoch to an eager one).

Both sides take the same numpy inputs: the same parameters, the same
injected ray indices and no stratified jitter, or every pixel as a ray, so
that every difference is arithmetic.
"""
import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_FRAMES, H, W, HD, WD = 4, 24, 32, 48, 64
N_RAYS = 64
ORDER = np.array([2, 0, 3, 1])   # frame 3 takes the pair's swap
REFS = np.array([3, 1, 2, 0])
STATIC = {"render_model": True, "use_ref": True, "use_rgb_s": True}


class _Scene:
    def __init__(self, rng):
        self.N_imgs = N_FRAMES
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
    cfg["training"].update(n_training_points=N_RAYS, pc_ratio=1)
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


def _jscalars(scalars):
    return {"weights": {k: np.float32(v)
                        for k, v in scalars["weights"].items()},
            "w_l1": np.float32(scalars["w_l1"]),
            "w_l2": np.float32(scalars["w_l2"]),
            "lrs": {k: np.float32(v) for k, v in scalars["lrs"].items()}}


def _setup(kernel_path):
    """(cfg, JAX params, JAX scene arrays, port params, port scene arrays):
    the same parameters (poses and shifts moved off zero, so every branch
    carries gradient) and one injected ray index set in both scene
    arrays."""
    from nope_nerf_tpu.training import loop as jloop
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.training import loop as ploop

    rng = np.random.default_rng(11)
    scene = _Scene(rng)
    cfg = _cfg(kernel_path)
    jparams, _ = jloop.build_params(cfg, scene, jax.random.PRNGKey(0))
    jparams["pose"] = {
        "r": jnp.asarray(rng.normal(size=(4, 3)) * 0.02, jnp.float32),
        "t": jnp.asarray(rng.normal(size=(4, 3)) * 0.05, jnp.float32)}
    jparams["distortion"]["shifts"] = jnp.asarray(
        rng.normal(size=(4, 1)) * 0.05, jnp.float32)
    ray_idx = rng.integers(0, H * W, size=N_RAYS)
    jarrs = jloop.scene_batch_arrays(scene, cfg)
    jarrs["camera_mat_gt"] = jnp.asarray(scene.K)
    jarrs["scale_mat"] = jnp.asarray(scene.scale_mat)
    jarrs["ray_idx"] = jnp.asarray(ray_idx, jnp.int32)
    parrs = ploop.scene_batch_arrays(scene, cfg, "cpu")
    parrs["ray_idx"] = torch.tensor(ray_idx)
    pparams = params_from_jax(jax.device_get(jparams))
    return cfg, jparams, jarrs, pparams, parrs


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# (a) make_epoch_step against the JAX make_epoch_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["f32", "kernel_bf16"])
def test_epoch_step_matches_jax(kernel_path):
    """One epoch of 4 steps (frame order ORDER, references REFS; frame 3
    takes the swap) from the same parameters on both sides. Per-step aux
    values (aux_mean, aux_last, scale_steps / shift_steps) at rtol 1e-4
    (f32, the bar of ``tests/test_torch_train.py``'s trajectory test) or
    1e-3 (the bf16 kernel path against the Pallas kernel in interpret
    mode, that file's kernel-path bar); the parameters after the epoch:
    every entry within 2 lr per step of JAX's (Adam moves an entry by at
    most about 2 lr per step, and one whose gradient is near 0 may move
    the other way on one side); in f32 the entries whose first-step
    gradient is at least 1e-2 of their leaf's largest within 0.05 lr, on
    the bf16 kernel path each leaf's update over the epoch within relL2
    0.05 of JAX's (one step's gradients agree to relL2 0.02 there; over
    the 4 steps the updates measured 0.033 at most)."""
    import nope_nerf_tpu.ops.pallas.mlp_kernel as jmk
    from nope_nerf_tpu.training import trainer as jt
    from nope_nerf_tpu_torch.training import trainer as pt

    cfg, jparams, jarrs, pparams, parrs = _setup(kernel_path)
    scalars = _scalars()
    jscal = _jscalars(scalars)
    jrc = jt.make_render_cfg(cfg)

    def jloss(params):
        batch = dict(jarrs, idx=jnp.int32(ORDER[0]),
                     ref_idx=jnp.int32(REFS[0]))
        return jt.compute_loss(params, batch, jscal, jax.random.PRNGKey(0),
                               cfg=cfg, static=STATIC, render_cfg=jrc)[0]

    jmk.INTERPRET = kernel_path
    try:
        grad1 = _leaves(jax.device_get(jax.jit(jax.grad(jloss))(jparams)))
        jstate, _ = jt.init_train_state(jparams)
        jstate, jmean, jlast = jt.make_epoch_step(cfg, jrc)(
            jstate, jarrs, jnp.asarray(ORDER, jnp.int32),
            jnp.asarray(REFS, jnp.int32), jscal, jax.random.PRNGKey(0),
            STATIC)
        jmean, jlast = jax.device_get((jmean, jlast))
    finally:
        jmk.INTERPRET = False

    pstate = pt.init_train_state(pparams)
    run = pt.make_epoch_step(cfg, pt.make_render_cfg(cfg, "cpu"),
                             device="cpu")
    assert run.route == "eager" and run.why == "CPU tensors"
    pstate, pmean, plast = run(pstate, parrs, ORDER, REFS, scalars, None,
                               STATIC)
    rtol = 1e-3 if kernel_path else 1e-4
    assert set(pmean) == set(jmean)
    assert set(plast) == set(jlast)
    for k in jmean:
        np.testing.assert_allclose(float(pmean[k]), float(jmean[k]),
                                   rtol=rtol, atol=1e-8, err_msg=k)
    for k in jlast:
        np.testing.assert_allclose(np.asarray(plast[k]), np.asarray(jlast[k]),
                                   rtol=rtol, atol=1e-8, err_msg=k)
    assert plast["scale_steps"].shape == (len(ORDER),)
    np.testing.assert_allclose(run.steps["loss"].numpy().mean(),
                               float(pmean["loss"]), rtol=1e-6)
    p0 = _leaves(jax.device_get(jparams))
    jp = _leaves(jax.device_get(jstate.params))
    pp = _leaves(pstate.params)
    for k, jv in jp.items():
        lr = scalars["lrs"][k.split("/")[0]]
        pv = pp[k].detach().numpy()
        diff = np.abs(pv - np.asarray(jv))
        assert (diff <= 2 * len(ORDER) * lr).all(), k
        if kernel_path:
            ju, pu = np.asarray(jv) - p0[k], pv - p0[k]
            assert (np.linalg.norm(pu - ju)
                    <= 0.05 * max(np.linalg.norm(ju), 1e-30)), k
        else:
            g = np.abs(grad1[k])
            near_zero = g < 1e-2 * g.max()
            assert (diff[~near_zero] <= 0.05 * lr).all(), k
    # Adam took one step per frame of the epoch
    for p in pstate.optimizer.param_groups[0]["params"]:
        assert int(pstate.optimizer.state[p]["step"]) == len(ORDER)


# ---------------------------------------------------------------------------
# (b) device indices against host ints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames,ref", [(0, 1), (3, 2), ([2, 3], 3),
                                        ([3, 0], 2)],
                         ids=["k1", "k1_swap", "k2", "k2_swap"])
def test_compute_loss_tensor_indices_bitwise(frames, ref):
    """``compute_loss`` with ``idx`` / ``ref_idx`` as device tensors ((k,)
    or ()) equals the host-int call bit for bit: the loss, every aux value
    and every gradient (a parameter the host-int call leaves without one,
    as the pinned last scale, gets zeros from the tensor call), on both
    branches of the frame-order swap (frame num_cams - 1 = 3)."""
    from nope_nerf_tpu_torch.training import trainer as pt

    cfg, _, _, pparams, parrs = _setup(False)
    scalars = _scalars()
    rc = pt.make_render_cfg(cfg, "cpu")
    pt.init_train_state(pparams)
    results = []
    for as_tensor in (False, True):
        idx = (torch.tensor(frames) if as_tensor else frames)
        r = torch.tensor(ref) if as_tensor else ref
        for leaf in _leaves(pparams).values():
            leaf.grad = None
        loss, aux = pt.compute_loss(pparams, dict(parrs, idx=idx, ref_idx=r),
                                    scalars, cfg=cfg, static=STATIC,
                                    render_cfg=rc)
        loss.backward()
        grads = {k: (v.grad.clone() if v.grad is not None
                     else torch.zeros_like(v))
                 for k, v in _leaves(pparams).items()}
        results.append((loss.detach(), {k: v.detach() for k, v in
                                        aux.items()}, grads))
    (l0, a0, g0), (l1, a1, g1) = results
    assert torch.equal(l0, l1)
    assert set(a0) == set(a1)
    for k in a0:
        assert torch.equal(a0[k], a1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# ---------------------------------------------------------------------------
# (c)-(e) the training loop's scan branch against the JAX loop's
# ---------------------------------------------------------------------------

LH, LW = 16, 20
LOOP_EPOCHS = 10
# triggers that no epoch of 4 steps divides: they fire when an epoch
# crosses a multiple
TRIGGERS = {"checkpoint_every": 3, "backup_every": 5, "visualize_every": 6,
            "vis_reprojection_every": 7}


def _loop_cfg(out_dir, mode):
    """The teacher scene's tiny config on both loops' scan paths, every
    pixel a ray (distinct draws, so both losses average the same rays), no
    jitter, f32. ``mode`` 'pipelined' adds the crossing triggers and a
    plateau detector of window 1 and patience 1 at a learning rate that
    makes the PSNR drop in the run (first at epoch 6); 'eager_metrics' and
    'reset' set the two modes that process each epoch eagerly."""
    from nope_nerf_tpu.utils.synthetic import tiny_config

    cfg = tiny_config(None, str(out_dir), n_training_points=LH * LW,
                      num_points=8)
    cfg["model"]["hidden_dim"] = 32
    cfg["training"].update(print_every=2, eval_pose_every=1,
                           eval_img_every=1, auto_scheduler=True,
                           length_smooth=1, patient=1, learning_rate=2e-2,
                           vis_resolution=[8, 10])
    cfg["tpu"].update(epoch_scan=True, fast_ray_sampling=False,
                      render_add_noise=False, use_pallas_mlp=False,
                      mlp_bf16=False)
    if mode == "pipelined":
        cfg["training"].update(TRIGGERS)
    elif mode == "eager_metrics":
        cfg["tpu"]["eager_metrics"] = True
    else:
        cfg["training"]["scheduling_mode"] = "reset"
    return cfg


def _events(out_dir):
    with open(out_dir / "logs" / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def _files(out_dir):
    """Every file under ``out_dir`` but the logs."""
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, fs in os.walk(out_dir) for f in fs
                  if os.path.relpath(d, out_dir).split(os.sep)[0] != "logs")


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """{mode: {side: (events, files, calls, scheduling_start)}} of both
    loops on one scene from the same parameters; ``calls`` lists the epoch
    dispatches ("D") and the plateau updates ("P", epoch) in order."""
    import nope_nerf_tpu.training.loop as jloop
    import nope_nerf_tpu_torch.training.loop as ploop
    import nope_nerf_tpu_torch.training.trainer as ptrainer
    from nope_nerf_tpu.utils.synthetic import SyntheticScene
    from nope_nerf_tpu_torch.convert import params_from_jax

    base = tmp_path_factory.mktemp("scan_loop")
    scene = SyntheticScene(n_frames=4, hw=(LH, LW), num_points=16, seed=0)
    jcfg = _loop_cfg(base / "init", "pipelined")
    jcfg["_num_cams"] = scene.N_imgs
    params, init_c2w = jloop.build_params(jcfg, scene, jax.random.PRNGKey(1))
    params = jax.device_get(params)
    assert init_c2w is None  # poses from scratch
    out = {}
    for mode, epochs in (("pipelined", LOOP_EPOCHS), ("eager_metrics", 3),
                         ("reset", 3)):
        out[mode] = {}
        for side, mod in (("jax", jloop), ("port", ploop)):
            calls = []
            mp = pytest.MonkeyPatch()
            real_epoch = mod.make_epoch_step
            real_plateau = mod.Scheduler.update_plateau

            def make(*a, real_epoch=real_epoch, **kw):
                run = real_epoch(*a, **kw)

                def dispatch(*args):
                    calls.append("D")
                    return run(*args)
                return dispatch

            def plateau(self, epoch, psnr, real_plateau=real_plateau):
                calls.append(("P", epoch))
                return real_plateau(self, epoch, psnr)

            try:
                if side == "jax":
                    mp.setattr(mod, "make_epoch_step", make)
                else:
                    # the loop reads the port's EpochStep's route and steps
                    real_call = ptrainer.EpochStep.__call__

                    def call(self, *args, real_call=real_call):
                        calls.append("D")
                        return real_call(self, *args)

                    mp.setattr(ptrainer.EpochStep, "__call__", call)
                mp.setattr(mod.Scheduler, "update_plateau", plateau)
                if side == "jax":
                    mp.setattr(mod, "build_params",
                               lambda cfg, scene, key: (params, None))
                    kw = {}
                else:
                    mp.setattr(mod, "build_params",
                               lambda cfg, scene, gen, device: (
                                   params_from_jax(params, device), None))
                    kw = {"device": "cpu"}
                d = base / mode / side
                res = mod.train(_loop_cfg(d, mode), max_epochs=epochs,
                                scene=scene, **kw)
            finally:
                mp.undo()
            out[mode][side] = (_events(d), _files(d), calls,
                               res[1].state.scheduling_start)
            if side == "port":
                out[mode]["port_history"] = res[3]
    return out


def test_scan_loop_logs_the_jax_scan_loops_events(loop_runs):
    """(c) The pipelined scan loop: the same (tag, step) pairs as the JAX
    scan loop, as often; ``train/lr_*`` equal and every other value but the
    rays/s within rtol 1e-3 / atol 1e-5 (the bar of
    ``tests/test_torch_logging.py``)."""
    jev, _, _, _ = loop_runs["pipelined"]["jax"]
    pev, _, _, _ = loop_runs["pipelined"]["port"]
    jkeys = collections.Counter((e["tag"], e["step"]) for e in jev)
    pkeys = collections.Counter((e["tag"], e["step"]) for e in pev)
    assert pkeys == jkeys
    assert {"train/loss", "train/psnr", "train/lr_nerf", "eval/ate_trans",
            "train/loss_pc_epoch", "perf/rays_per_sec"} <= {t for t, _ in pkeys}
    # every epoch end prints (print_every 2 < 4 steps per epoch)
    assert sorted(s for t, s in pkeys if t == "train/loss") == [
        4 * e + 3 for e in range(LOOP_EPOCHS)]
    jval = {(e["tag"], e["step"]): e["value"] for e in jev}
    for e in pev:
        key, got = (e["tag"], e["step"]), e["value"]
        if e["tag"] == "perf/rays_per_sec":
            assert np.isfinite(got) and got >= 0
        elif e["tag"].startswith("train/lr_"):
            assert got == jval[key], key
        else:
            np.testing.assert_allclose(got, jval[key], rtol=1e-3, atol=1e-5,
                                       err_msg=str(key))


def test_scan_loop_plateau_fires_one_epoch_late_as_in_jax(loop_runs):
    """(c) The PSNR drops first at epoch 6 (45.76 -> 43.97 dB): both loops
    switch there (the same ``scheduling_start``), and both process epoch
    e's metrics after epoch e + 1 is dispatched, so the switch reaches the
    schedule from epoch 8; the last epoch's metrics are drained after the
    loop."""
    _, _, jcalls, jstart = loop_runs["pipelined"]["jax"]
    _, _, pcalls, pstart = loop_runs["pipelined"]["port"]
    assert pstart == jstart == 6
    assert pcalls == jcalls
    assert pcalls == ["D"] + [x for e in range(LOOP_EPOCHS - 1)
                              for x in ("D", ("P", e))] + [
        ("P", LOOP_EPOCHS - 1)]


def test_scan_loop_trigger_files_match_jax(loop_runs):
    """(d) ``checkpoint_every`` 3, ``backup_every`` 5, ``visualize_every``
    6 and ``vis_reprojection_every`` 7 with 4 steps per epoch: the port
    writes the same files as the JAX scan loop, named at the epoch end
    that crossed each multiple (and the pair dump from the epoch's last
    frame)."""
    _, jfiles, _, _ = loop_runs["pipelined"]["jax"]
    _, pfiles, _, _ = loop_runs["pipelined"]["port"]
    assert pfiles == jfiles
    assert "model_7.npz" in pfiles and "model_11.npz" in pfiles
    assert any(f.startswith(os.path.join("rendering", "0007_vis"))
               for f in pfiles)
    assert any(f.endswith("_img1.png") and f.startswith(
        os.path.join("rendering", "7_")) for f in pfiles)


@pytest.mark.parametrize("mode", ["eager_metrics", "reset"])
def test_scan_loop_eager_modes_process_each_epoch_at_once(loop_runs, mode):
    """(e) Under ``tpu.eager_metrics`` and ``scheduling_mode: reset`` both
    loops process epoch e's metrics before they dispatch epoch e + 1, the
    same (tag, step) pairs logged."""
    jev, _, jcalls, _ = loop_runs[mode]["jax"]
    pev, _, pcalls, _ = loop_runs[mode]["port"]
    assert pcalls == jcalls == ["D", ("P", 0), "D", ("P", 1), "D", ("P", 2)]
    assert (collections.Counter((e["tag"], e["step"]) for e in pev)
            == collections.Counter((e["tag"], e["step"]) for e in jev))


@pytest.mark.parametrize("mode", ["pipelined", "eager_metrics", "reset"])
def test_scan_loop_history_times_the_wall_clock(loop_runs, mode):
    """The scan loop's epoch records time the host clock as the per-step
    loop's do: ``ms_per_step`` and ``rays_per_sec`` from one wall time,
    and ``device_ms_per_step`` (the epoch's ``tracing`` dispatch span)
    and ``sections_ms`` None on the CPU, where no device time is
    measured."""
    history = loop_runs[mode]["port_history"]
    assert history
    for rec in history:
        assert rec["device_ms_per_step"] is None
        assert rec["sections_ms"] is None
        assert rec["ms_per_step"] > 0
        assert rec["rays_per_sec"] * rec["ms_per_step"] / 1e3 == (
            pytest.approx(LH * LW))


def test_epoch_step_takes_its_device_and_steps_run_eagerly_off_cuda():
    """``make_epoch_step`` without a device (and no mesh) raises rather
    than guess one; a ``StepGraphs`` off CUDA runs only eager steps, each
    call's n steps of the function as it is."""
    from nope_nerf_tpu_torch.training import trainer as pt
    from nope_nerf_tpu_torch.training.capture import StepGraphs

    cfg = _cfg(False)
    with pytest.raises(ValueError, match="device"):
        pt.make_epoch_step(cfg, pt.make_render_cfg(cfg, "cpu"))
    run = pt.make_epoch_step(cfg, pt.make_render_cfg(cfg, "cpu"),
                             device="cpu", eager=True)
    assert (run.route, run.graphs.route) == ("eager", "eager")
    with pytest.raises(ValueError, match="CUDA"):
        StepGraphs("cpu")
    calls = []
    steps = StepGraphs("cpu", eager=True)
    steps.run("key", lambda: calls.append(1), 5)
    assert len(calls) == 5 and steps.graphs == {} and steps.warmups == 0


def test_bound_tensors_lists_the_optimizer_state():
    """``bound_tensors`` (the storage a captured step is tied to) lists the
    tensors of nested containers, and of an Adam its parameters, its tensor
    learning rate and, once it stepped, each parameter's state."""
    from nope_nerf_tpu_torch.training.capture import bound_tensors

    a, b = torch.zeros(3, requires_grad=True), torch.ones(2)
    lr = torch.tensor(0.1)
    opt = torch.optim.Adam([a], lr=lr)
    assert [t.data_ptr() for t in bound_tensors({"x": [b, 1]}, opt)] == [
        b.data_ptr(), a.data_ptr(), lr.data_ptr()]
    a.sum().backward()
    opt.step()
    st = opt.state[a]
    assert [t.data_ptr() for t in bound_tensors(opt)] == [
        t.data_ptr() for t in (a, lr, st["exp_avg"], st["exp_avg_sq"],
                               st["step"])]


# ---------------------------------------------------------------------------
# (f) the block-scanned pose optimisation against the JAX package's
# ---------------------------------------------------------------------------


class _Log:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))


def test_pose_opt_blocks_match_jax():
    """(f) ``optimize_eval_poses`` over 7 epochs in blocks of 3 on both
    sides, from the JAX teacher scene's field and a perturbed pose of each
    of 2 eval frames, every pixel a ray (``n_points`` = H x W, distinct
    draws: both losses average the same rays). ``opt/psnr`` is logged at
    the same epochs (each block's last, 2, 5, 6) within 1e-3 dB; the
    optimised c2w within 2e-4 (14 Adam steps at lr <= 1e-3 move them by
    about 1e-2)."""
    from scipy.spatial.transform import Rotation

    from nope_nerf_tpu.evaluation import pose_opt as jpo
    from nope_nerf_tpu.utils.synthetic import SyntheticScene
    from nope_nerf_tpu_torch.convert import params_from_jax
    from nope_nerf_tpu_torch.evaluation import pose_opt as ppo

    hw = (LH, LW)
    scene = SyntheticScene(n_frames=4, hw=hw, num_points=16)
    port = params_from_jax({"nerf": jax.device_get(scene.teacher)})["nerf"]
    rcfg = dict(scene.teacher_render_cfg, mlp_bf16=False,
                use_pallas_mlp=False, fuse_compositing=True)
    init = scene.c2ws[:2].copy()
    for i, (rv, t) in enumerate((([0.0, 0.1, 0.0], [0.2, 0.1, -0.1]),
                                 ([0.05, 0.0, -0.05], [-0.1, 0.2, 0.1]))):
        init[i, :3, :3] = Rotation.from_rotvec(rv).as_matrix() @ init[i, :3,
                                                                      :3]
        init[i, :3, 3] += np.array(t)
    cfg = {"tpu": {"fast_ray_sampling": False}}
    imgs = np.asarray(scene.imgs[:2], np.float32)
    kw = dict(num_epoch=7, lr=1e-3, n_points=LH * LW, block_epochs=3)
    jlog, plog = _Log(), _Log()
    jc2w, _ = jpo.optimize_eval_poses(
        jax.tree.map(jnp.asarray, scene.teacher), jnp.asarray(scene.K), cfg,
        rcfg, jnp.asarray(imgs), np.eye(4, dtype=np.float32), init,
        logger=jlog, **kw)
    pc2w, _ = ppo.optimize_eval_poses(
        port, scene.K, cfg, rcfg, torch.tensor(imgs),
        np.eye(4, dtype=np.float32), init, logger=plog, **kw)
    assert [(t, s) for t, _, s in plog.rows] == [
        (t, s) for t, _, s in jlog.rows] == [("opt/psnr", e)
                                             for e in (2, 5, 6)]
    for (_, pv, _), (_, jv, _) in zip(plog.rows, jlog.rows):
        assert abs(pv - jv) <= 1e-3
    assert np.abs(np.asarray(jc2w) - init).max() > 1e-3  # the poses moved
    np.testing.assert_allclose(pc2w, np.asarray(jc2w), atol=2e-4, rtol=0)


# ---------------------------------------------------------------------------
# (g) the bench's layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_bench_layout_matches_bench_py(k, monkeypatch):
    """(g) The port bench's dispatch constants and its (steps, k) frame and
    reference indices equal the repository's ``bench.py`` (built at a tiny
    image size: the layout does not depend on it)."""
    import bench as jbench
    from nope_nerf_tpu_torch import bench as pbench

    for name in ("SCAN_STEPS", "WARMUP_DISPATCHES", "MEASURE_DISPATCHES",
                 "N_FRAMES", "H", "W", "BASELINE_RAYS_PER_SEC",
                 "BENCH_ATTEMPTS", "BENCH_RETRY_BACKOFF_S"):
        assert getattr(pbench, name) == getattr(jbench, name), name
    monkeypatch.setenv("BENCH_TPU_OVERRIDES",
                       json.dumps({"rays_per_step_multiplier": k}))
    monkeypatch.setattr(jbench, "H", 8)
    monkeypatch.setattr(jbench, "W", 12)
    _, _, _, jidx, jrefs, _, jstatic = jbench.build()
    pidx, prefs = pbench.bench_indices(k)
    assert pbench.bench_config()["tpu"]["rays_per_step_multiplier"] == k
    np.testing.assert_array_equal(pidx, np.asarray(jidx))
    np.testing.assert_array_equal(prefs, np.asarray(jrefs))
    assert pidx.shape == ((pbench.SCAN_STEPS,) if k == 1
                          else (pbench.SCAN_STEPS, k))
    assert jstatic == {"render_model": True, "use_ref": True,
                       "use_rgb_s": True}
