"""Training orchestration (port of ``nope_nerf_tpu/training/loop.py``):
epoch loop, frame shuffling, reference-frame sampling, the schedule state
machine, the four checkpoint streams with resume, per-epoch metrics and
pose accuracy (ATE/RPE), ``scheduling_mode: reset``, the training
visualisations and reprojection-pair dumps, ``tpu.debug_nans`` and
``tpu.profile_dir``.

Same host-side draws as the JAX loop: ``np.random.permutation`` for the
frame order and ``scene.sample_ref_idx(i, pyrng)`` for the reference
frames, both seeded with ``training.seed``.

``tpu.epoch_scan`` (True in the stock config) picks the JAX loop's scan
branch: each epoch is one call of :func:`.trainer.make_epoch_step` (on the
card, n replays of one captured CUDA graph of the step; eager steps on the
CPU, under ``tpu.debug_nans`` and over gloo, the loop's first lines saying
which and why). Its metrics come back as one device-to-host copy per epoch
and are processed one epoch late, as the JAX loop's
``_process_epoch_metrics`` does: epoch e's means, print line and
``train/*`` scalars at the JAX scan loop's print condition, its pose
accuracy (from epoch e's pose table), ``train/psnr``, the plateau update
and the learning rates are handled while epoch e + 1 runs, so the plateau
detector sees each PSNR one epoch late; under ``scheduling_mode: reset``
or ``tpu.eager_metrics`` each epoch is processed before the next is
queued. After an epoch ending at step ``it`` that began at ``it0``, a
pair dump (of the epoch's last frame and its reference), a checkpoint, a
backup and a visualisation fire when the epoch crossed a multiple of
their period: ``(it0 - 1) // every != it // every``. The last epoch's
metrics are drained after the loop.

``tpu.epoch_scan: False`` runs step by step with the JAX loop's non-scan
triggers: after step ``it``, a pair dump when ``it % vis_reprojection_every
== 0`` (and the step uses rgb_s), a checkpoint when ``it %
checkpoint_every == 0``, a backup when ``it % backup_every == 0`` and a
visualisation into ``rendering/%04d_vis`` when ``it % visualize_every ==
0``.

With ``tpu.rays_per_step_multiplier`` k > 1 every step takes k frames,
drawn in the JAX loop's order: the epoch's permutation (frame 0 of each
step, which owns the reference pair and drives the per-view logging and
the pair dumps), the reference draws, then ``np.random.randint(0,
n_views, (n_views, k - 1))`` for the extra frames; rays/s counts k *
``n_training_points`` rays per step.

With ``tpu.n_devices`` N > 1 the run is one of N processes of
``python -m torch.distributed.run --nproc-per-node N`` (``parallel/mesh.py``):
every rank holds the parameters and the Adam state (broadcast from rank 0
after the build and the restore), draws the same frames, rays and jitter,
renders its rows of each step's rays and reads the same global losses, so
every rank takes the same branches. Rank 0 alone writes the event log,
checkpoints, visualisations and pair dumps and prints; every rank restores
from the same files.
"""
from __future__ import annotations

import os
import random as pyrandom
import time

import numpy as np
import torch
from PIL import Image

from .. import tracing
from ..config import apply_parity_profile, check_supported
from ..convert import (
    adam_state_from_jax_leaves,
    adam_state_to_jax_leaves,
    params_from_jax,
    params_to_numpy,
)
from ..dataloading.scene import get_scene
from ..device import resolve_device
from ..geometry.align import align_ate_c2b_use_a2b, compute_ate, compute_rpe
from ..losses.losses import mse2psnr
from ..models.distortion import init_distortion_params
from ..models.intrinsics import init_focal_params
from ..models.nerf import init_nerf_params
from ..models.pose import all_poses, init_pose_params
from ..ops.interp import resize_bilinear, resize_nearest
from ..parallel.mesh import RAY_AXIS, barrier, make_ray_mesh, replicate
from ..utils.logging import MetricsLogger, Throughput, summary_writer_class
from .checkpoints import CheckpointIO
from .scheduler import Scheduler, ScheduleState
from .trainer import (
    compute_loss,
    describe_routes,
    init_train_state,
    make_epoch_step,
    make_render_cfg,
    make_train_step,
)
from .visualize import render_visdata


def build_params(cfg, scene, generator, device):
    """The 4-group parameter dict and the ``init_c2w`` constant (or None);
    the focal starts from the scene's K as [K00, -K11] when
    ``init_focal_type`` is 'gt'."""
    n_views = scene.N_imgs
    pcfg = cfg["pose"]
    init_focal = None
    if pcfg["init_focal_type"] == "gt":
        init_focal = [float(scene.K[0, 0]), float(-scene.K[1, 1])]
    params = {
        "nerf": init_nerf_params(generator, cfg, device),
        "pose": init_pose_params(n_views, device),
        "focal": init_focal_params(pcfg["fx_only"], pcfg["focal_order"],
                                   init_focal, device),
        "distortion": init_distortion_params(n_views, device),
    }
    init_c2w = None
    if pcfg["learn_pose"] and pcfg["init_pose"]:
        src = {"gt": "c2ws", "colmap": "c2ws_colmap"}[pcfg["init_pose_type"]]
        init_c2w = torch.as_tensor(np.asarray(getattr(scene, src)),
                                   dtype=torch.float32, device=device)
    return params, init_c2w


def scene_batch_arrays(scene, cfg, device):
    """The scene's frames and depth priors on the device, plus the
    ``pc_ratio`` pyramid (nearest-resized depths, bilinear-resized images)
    that the reference branch reads every step."""
    imgs = torch.as_tensor(np.asarray(scene.imgs), dtype=torch.float32,
                           device=device)
    if getattr(scene, "dpt_depth", None) is not None:
        dpts = torch.as_tensor(np.asarray(scene.dpt_depth),
                               dtype=torch.float32, device=device)
    else:
        dpts = torch.ones(imgs.shape[:3], dtype=torch.float32, device=device)
    out = {"imgs": imgs, "dpts": dpts}
    ratio = cfg["training"]["pc_ratio"]
    sres = (int(dpts.shape[1] / ratio), int(dpts.shape[2] / ratio))
    if sres[0] >= 1 and sres[1] >= 1:
        out["dpts_small"] = torch.stack([resize_nearest(d, sres) for d in dpts])
        out["imgs_small"] = torch.stack([resize_bilinear(im, sres)
                                         for im in imgs])
    out["camera_mat_gt"] = torch.as_tensor(np.asarray(scene.K),
                                           dtype=torch.float32, device=device)
    out["scale_mat"] = torch.as_tensor(np.asarray(scene.scale_mat),
                                       dtype=torch.float32, device=device)
    return out


def _n_devices(cfg):
    return int((cfg.get("tpu", {}) or {}).get("n_devices", 1) or 1)


def mesh_for(cfg, device):
    """The ray mesh of ``tpu.n_devices`` on ``device``'s type (None for one
    device, with no ``torch.distributed`` call). Production never shares
    a card between ranks (``allow_shared_device`` stays False)."""
    n = _n_devices(cfg)
    if n <= 1:
        return None
    axis = (cfg.get("tpu", {}) or {}).get("mesh_axis") or RAY_AXIS
    return make_ray_mesh(n, axis, device=torch.device(device).type)


def check_one_device(cfg, entry):
    """Raise for ``tpu.n_devices > 1`` in an entry point that times one
    device (``bench``, ``profile_step``): the JAX bench has no mesh path,
    and a step split over ranks that each keep the whole host work is no
    faster per step."""
    if _n_devices(cfg) > 1:
        raise NotImplementedError(
            f"{entry} runs on one device: tpu.n_devices > 1 trains with "
            "python -m torch.distributed.run (nope_nerf_tpu_torch.train)")


class _NoLogger:
    """The event log of ranks other than 0."""

    def add_scalar(self, tag, value, step):
        pass

    def close(self):
        pass


def replicate_state(state, mesh):
    """Broadcast the parameters and the Adam moments on the mesh's device
    from rank 0 (no-op without a mesh). Adam's host-side step counts come
    from the same files on every rank."""
    if mesh is None:
        return
    tensors = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in tensors[:]:
        tensors += [t for t in state.optimizer.state.get(p, {}).values()
                    if torch.is_tensor(t) and t.device == mesh.device]
    replicate(tensors, mesh)


def dump_pair_images(state, cfg, render_cfg, init_c2w, batch0, idx, ref_idx,
                     scalars, it, render_path, mesh=None):
    """Write the rgb_s pair of frames ``idx`` / ``ref_idx`` (view-1 colours
    and the reprojected view-2 colours) as ``%d_%04d_img1.png`` /
    ``%d_%04d_img2.png`` % (it, idx): the pc and rgb_s branches of
    ``compute_loss`` without the render, so the Chamfer argmins run on
    their kernels on the card (on every rank's query rows under ``mesh``,
    rank 0 writing)."""
    static = {"pair_images": True, "render_model": False, "use_ref": True,
              "use_rgb_s": True}
    with torch.no_grad():
        _, aux = compute_loss(state.params,
                              dict(batch0, idx=int(idx), ref_idx=int(ref_idx)),
                              scalars, cfg=cfg, static=static,
                              init_c2w=init_c2w, render_cfg=render_cfg,
                              mesh=mesh)
    if "rgb_pc1" not in aux or (mesh is not None and mesh.rank != 0):
        return
    os.makedirs(render_path, exist_ok=True)
    for tag, arr in (("img1", aux["rgb_pc1"]), ("img2", aux["rgb_pc1_proj"])):
        a = np.clip(arr.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(a).convert("RGB").save(
            os.path.join(render_path, "%d_%04d_%s.png" % (it, idx, tag)))


def restore(checkpoint_io, cfg, params, device):
    """Load the four streams named by ``training.load_*dir`` into
    ``params`` (each group whose file exists is replaced by new tensors on
    ``device``; a missing file leaves its group fresh). Returns (params, the
    main stream's scalars, its optimizer leaves or None). The leaves are
    None under ``training.load_ckpt_model_only`` or when the file has none;
    :func:`..convert.adam_state_from_jax_leaves` loads them."""
    tcfg = cfg["training"]
    streams = {"nerf": tcfg["load_dir"], "pose": tcfg["load_pose_dir"],
               "focal": tcfg["load_focal_dir"],
               "distortion": tcfg["load_distortion_dir"]}
    scalars, leaves = {}, None
    for group, fname in streams.items():
        try:
            tree, sc, lv = checkpoint_io.load(fname)
        except FileNotFoundError:
            continue
        params[group] = params_from_jax({group: tree["params"]},
                                        device)[group]
        if group == "nerf":
            scalars = sc
            if lv and not tcfg.get("load_ckpt_model_only", False):
                leaves = lv
    return params, scalars, leaves


def save_all(checkpoint_io, state, sched_state, cfg, suffix=""):
    """The four streams; the main one carries the scheduler scalars and the
    Adam moments (as the JAX optax leaves), so a resume keeps both."""
    sc = sched_state.to_dict()
    params = params_to_numpy(state.params)
    checkpoint_io.save(f"model{suffix}.npz", {"params": params["nerf"]},
                       opt_leaves=adam_state_to_jax_leaves(state.optimizer),
                       **sc)
    for group, on in (("pose", cfg["pose"]["learn_pose"]),
                      ("focal", cfg["pose"]["learn_focal"]),
                      ("distortion", cfg["distortion"]["learn_distortion"])):
        if on:
            checkpoint_io.save(f"model_{group}{suffix}.npz",
                               {"params": params[group]},
                               epoch_it=sc["epoch_it"], it=sc["it"])


class HostCopy:
    """Device tensors copied to the host without waiting for the device
    (pinned buffers on CUDA and an event after the copies); :meth:`wait`
    waits for the copies alone, not for work queued after them."""

    def __init__(self, tensors):
        self.host, self.event = {}, None
        for k, t in tensors.items():
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self.host[k] = h.copy_(t, non_blocking=True)
                self.event = self.event or torch.cuda.Event()
            else:
                self.host[k] = t.detach().clone()
        if self.event is not None:
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host


def epoch_record(epoch, it, n, loss, step_losses, psnr, wall, device,
                 n_rays, sections_ms=None):
    """One epoch's history entry: ``ms_per_step`` and ``rays_per_sec`` from
    the host clock's ``wall`` seconds, ``device_ms_per_step`` from the
    device span of ``device`` seconds (the epoch's dispatch, or a
    ``tracing.DeviceTimer``; None when not measured), and ``sections_ms``,
    the device ms of each section of a step (``tracing.section_ms``)."""
    return {"epoch": epoch, "it": it, "steps": n, "loss": loss,
            "step_losses": step_losses, "psnr": psnr,
            "ms_per_step": 1e3 * wall / n, "rays_per_sec": n * n_rays / wall,
            "device_ms_per_step": None if device is None
            else 1e3 * device / n, "sections_ms": sections_ms}


def epoch_line(rec):
    """The print line of one epoch's history entry."""
    dev = rec["device_ms_per_step"]
    return (f"[Epoch {rec['epoch']:02d}] it={rec['it']:03d}, "
            f"loss={rec['loss']:.8f}, psnr={rec['psnr']:.4f}, "
            f"ms/step={rec['ms_per_step']:.3f}"
            + ("" if dev is None else f" (device {dev:.3f})")
            + f", rays/s={rec['rays_per_sec']:.0f}")


def pose_metrics(pose_params, init_c2w, gt_poses, pcfg):
    """(ATE, RPE translation x100, RPE rotation in degrees) of the learned
    poses after their Sim(3) alignment to ``gt_poses``; computed on the
    pose table's device (the host for a :class:`HostCopy` of it)."""
    if init_c2w is not None:
        init_c2w = init_c2w.to(pose_params["r"].device)
    learned = all_poses(pose_params, init_c2w, pcfg["learn_R"],
                        pcfg["learn_t"]).detach().cpu().numpy()
    aligned = align_ate_c2b_use_a2b(learned, gt_poses)
    rpe_t, rpe_r = compute_rpe(gt_poses, aligned)
    return compute_ate(gt_poses, aligned), rpe_t * 100, float(np.rad2deg(rpe_r))


def train(cfg, max_epochs=None, scene=None, device="cuda", mesh=None):
    """Run training; ``max_epochs`` caps the loop.

    ``scene`` is any object with N_imgs, K, scale_mat, imgs (N, H, W, 3),
    dpt_depth (N, H, W) or None, c2ws (N, 4, 4) or None and
    ``sample_ref_idx(i, rng)``; when None it is loaded from ``dataloading``
    with the port's numpy loader (``dataloading.scene``, numpy + PIL). ``device`` is a CUDA device unless "cpu" is asked for
    (:func:`resolve_device`).

    With ``tpu.n_devices`` > 1 the rays are sharded over a ray mesh
    (:func:`mesh_for`, or the ``mesh`` given, whose size must match) and
    the run takes the mesh's device.

    Resumes from the checkpoints in ``training.out_dir`` when there are
    any, saves every ``checkpoint_every`` / ``backup_every`` steps and at
    the end. Returns (state, scheduler, scene, history): history has one
    dict per epoch run (epoch, it, steps, loss, step_losses, psnr,
    ms_per_step and rays_per_sec on the host clock, device_ms_per_step on
    the device's (None off CUDA), sections_ms, and ate_trans, rpe_trans,
    rpe_rot in the epochs that score the poses). On the scan path
    device_ms_per_step is the epoch's ``tracing`` dispatch span, and
    sections_ms the device ms of each section of the last replay of the
    step (``tracing.section_ms("train")``) where that replay has finished
    when the epoch is processed: the last epoch's, and every epoch's under
    ``tpu.eager_metrics`` or ``scheduling_mode: reset``; None before that
    (a later epoch's replays are queued, and reading would wait for them),
    on the per-step path and off CUDA.

    With ``tpu.profile_dir`` the whole run is traced by one
    ``torch.profiler.profile`` (CPU activity, and CUDA activity on the
    card), written at the end as ``<profile_dir>/trace.json`` (Chrome
    trace format). With ``tpu.debug_nans`` a loss or gradient that is not
    finite raises ``FloatingPointError`` naming the step
    (:func:`.trainer.make_train_step`).
    """
    check_supported(cfg)
    apply_parity_profile(cfg)
    device = resolve_device(device)
    if mesh is None:
        mesh = mesh_for(cfg, device)
    elif mesh.size != _n_devices(cfg):
        raise ValueError(f"mesh of {mesh.size} ranks for tpu.n_devices "
                         f"{_n_devices(cfg)}")
    if mesh is not None:
        device = mesh.device
    profile_dir = (cfg.get("tpu", {}) or {}).get("profile_dir")
    if not profile_dir or (mesh is not None and mesh.rank != 0):
        return _train(cfg, max_epochs, scene, device, mesh)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = _train(cfg, max_epochs, scene, device, mesh)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return result


def _train(cfg, max_epochs, scene, device, mesh):
    seed = int(cfg["training"].get("seed", 42) or 42)
    # the tensorboard import may draw from np.random (TensorFlow's first
    # import): take it before the seed
    summary_writer_class()
    np.random.seed(seed)
    pyrng = pyrandom.Random(seed)
    init_gen = torch.Generator().manual_seed(seed)
    step_gen = torch.Generator(device=device).manual_seed(seed)

    out_dir = cfg["training"]["out_dir"]
    lead = mesh is None or mesh.rank == 0
    os.makedirs(out_dir, exist_ok=True)
    logger = (MetricsLogger(os.path.join(out_dir, "logs")) if lead
              else _NoLogger())
    say = print if lead else (lambda *a, **k: None)
    if scene is None:
        scene = get_scene(cfg, mode=cfg["training"]["mode"])
    batch0 = scene_batch_arrays(scene, cfg, device)
    n_views = scene.N_imgs
    cfg = dict(cfg)
    cfg["_num_cams"] = n_views
    render_cfg = make_render_cfg(cfg, device)
    ratio = cfg["training"]["pc_ratio"]
    n_pc = (int(batch0["dpts"].shape[1] / ratio)
            * int(batch0["dpts"].shape[2] / ratio))
    say("nope_nerf_tpu_torch: "
        + describe_routes(cfg, render_cfg, device, n_pc, mesh))
    params, init_c2w = build_params(cfg, scene, init_gen, device)
    tcfg = cfg["training"]
    checkpoint_io = CheckpointIO(out_dir)
    params, ck_scalars, opt_leaves = restore(checkpoint_io, cfg, params,
                                             device)
    tpu = cfg.get("tpu", {}) or {}
    epoch_scan = bool(tpu.get("epoch_scan", True))
    # the scan path's graphs replay a capturable Adam; the eager scan route
    # on the card keeps the same optimiser, so both routes are one step
    state = init_train_state(params, capturable=epoch_scan
                             and device.type == "cuda")
    if opt_leaves is not None:
        try:
            adam_state_from_jax_leaves(state.optimizer, opt_leaves)
        except ValueError as e:
            # e.g. a scene of another size: the params load, the moments
            # start fresh (the JAX loop's semantics)
            say(f"nope_nerf_tpu_torch: Adam moments start fresh ({e})")
    replicate_state(state, mesh)
    sched_state = ScheduleState.from_dict(ck_scalars,
                                          tcfg["scheduling_start"])
    sched = Scheduler(cfg, sched_state)
    if epoch_scan:
        epoch_fn = make_epoch_step(cfg, render_cfg, init_c2w, mesh=mesh,
                                   device=device)
        say("nope_nerf_tpu_torch: epoch_scan: " + (
            "cuda graph (training/capture.py::StepGraphs: one captured step "
            "per static flags, n, k, replayed n times per epoch)"
            if epoch_fn.route == "cuda graph" else
            f"eager ({epoch_fn.why})"))
    else:
        step_fn = make_train_step(cfg, render_cfg, init_c2w, mesh=mesh)
    print_every = tcfg["print_every"]
    checkpoint_every = tcfg["checkpoint_every"] or 0
    backup_every = tcfg["backup_every"] or 0
    eval_pose_every = tcfg["eval_pose_every"] or 0
    eval_img_every = tcfg["eval_img_every"] or 0
    visualize_every = tcfg["visualize_every"] or 0
    vis_reproj_every = tcfg.get("vis_reprojection_every", 0) or 0
    render_path = os.path.join(out_dir, "rendering")
    log_ss_per_view = tcfg.get("log_scale_shift_per_view", False)
    gt_poses = getattr(scene, "c2ws", None)
    mult = max(int(tpu.get("rays_per_step_multiplier", 1) or 1), 1)
    n_rays = tcfg["n_training_points"] * mult  # per step
    scale_dict, shift_dict = {}, {}
    history = []
    # rays/s between two print_every steps, logged at them as
    # perf/rays_per_sec (the JAX loop's counter)
    throughput = Throughput(n_rays)
    pose_eval_on = (eval_pose_every > 0 and gt_poses is not None
                    and cfg["pose"]["learn_pose"])

    def end_of_epoch(epoch, it, psnr, pose_params):
        """The per-epoch metrics that follow the epoch's losses: pose
        accuracy, ``train/psnr``, the plateau update (with the 'reset'
        mode's field re-init) and the learning rates; returns the pose
        metrics, if any."""
        out = {}
        if pose_eval_on and epoch % eval_pose_every == 0:
            ate, rpe_t, rpe_r = pose_metrics(pose_params, init_c2w, gt_poses,
                                             cfg["pose"])
            out = {"ate_trans": ate, "rpe_trans": rpe_t, "rpe_rot": rpe_r}
            for k, v in out.items():
                logger.add_scalar(f"eval/{k}", v, it)
        if eval_img_every > 0 and epoch % eval_img_every == 0:
            logger.add_scalar("train/psnr", psnr, it)
        switched = sched.update_plateau(epoch, psnr)
        if switched and tcfg.get("scheduling_mode") == "reset":
            # a fresh field in the same tensors, so Adam keeps its moments
            # (the JAX loop keeps opt_state across the re-init) and a
            # captured step reads the new values
            fresh = init_nerf_params(init_gen, cfg, device)
            with torch.no_grad():
                for name, layer in state.params["nerf"].items():
                    for k, t in layer.items():
                        t.copy_(fresh[name][k])
            replicate([t for layer in state.params["nerf"].values()
                       for t in layer.values()], mesh)
        for g, v in sched.lrs(epoch).items():
            logger.add_scalar(f"train/lr_{g}", v, it)
        return out

    def process_epoch(pending, t_next=None):
        """The host's share of one scanned epoch (the JAX loop's
        ``_process_epoch_metrics``): its epoch means, the print line and
        the ``train/*`` scalars at the JAX scan loop's print condition,
        the per-view distortion, then :func:`end_of_epoch`. Pipelined, it
        runs one epoch behind the device. The epoch's wall time runs on
        the host clock from its start to ``t_next``, the next epoch's start
        (all of its host work included), or else to the moment its metrics
        reached the host."""
        p_epoch, p_it, keys, copy, p_order, record, t_start = pending
        host = copy.wait()
        aux_mean, steps = host["mean"], host["steps"]
        mean = {k: float(aux_mean[j]) for j, k in enumerate(keys)}
        col = {k: j for j, k in enumerate(keys)}
        logger.add_scalar("train/loss_pc_epoch", mean["loss_pc"], p_it)
        logger.add_scalar("train/loss_rgbs_epoch", mean["loss_rgb_s"], p_it)
        if log_ss_per_view:
            for v_idx, sc, sh in zip(p_order, steps[:, col["scale"]],
                                     steps[:, col["shift"]]):
                scale_dict["view %02d" % v_idx] = float(sc)
                shift_dict["view %02d" % v_idx] = float(sh)
        if print_every > 0 and (p_it // n_views) % max(
                print_every // max(n_views, 1), 1) == 0:
            rate = throughput.rate()
            say(f"[Epoch {p_epoch:02d}] it={p_it:03d}, "
                f"loss={mean['loss']:.8f}, rays/s={rate:.0f}")
            throughput.reset()
            for tag, v in mean.items():
                logger.add_scalar(f"train/{tag}", v, p_it)
            logger.add_scalar("perf/rays_per_sec", rate, p_it)
            for vname, v in scale_dict.items():
                logger.add_scalar(f"train/scale{vname}", v, p_it)
            for vname, v in shift_dict.items():
                logger.add_scalar(f"train/shift{vname}", v, p_it)
        psnr = float(mse2psnr(mean["l2_mean"]))
        wall = (time.perf_counter() if t_next is None else t_next) - t_start
        device_ms = record.device_ms()
        rec = epoch_record(p_epoch, p_it, steps.shape[0], mean["loss"],
                           [float(x) for x in steps[:, col["loss"]]], psnr,
                           wall, None if device_ms is None
                           else device_ms / 1e3, n_rays,
                           tracing.section_ms(
                               "train", eager=epoch_fn.route == "eager",
                               wait=False))
        say(epoch_line(rec))
        pose = {k: host[f"pose_{k}"] for k in ("r", "t")}
        rec.update(end_of_epoch(p_epoch, p_it, psnr, pose))
        history.append(rec)

    # the scan path's epoch metrics lag the device by one epoch unless the
    # JAX loop syncs eagerly: under scheduling_mode reset (a lagged re-init
    # would discard one trained epoch) or tpu.eager_metrics
    eager_metrics = (tcfg.get("scheduling_mode") == "reset"
                     or bool(tpu.get("eager_metrics", False)))
    pending_prev = None

    while sched_state.epoch_it < sched.total_epochs:
        sched_state.epoch_it += 1
        epoch = sched_state.epoch_it
        if max_epochs is not None and epoch >= max_epochs:
            break
        w_l1, w_l2 = sched.rgb_loss_switch(epoch)
        scalars = {"weights": sched.weights(epoch), "w_l1": w_l1,
                   "w_l2": w_l2, "lrs": sched.applied_lrs(epoch)}
        static = sched.static_flags(epoch)
        order = np.random.permutation(n_views)
        ref_order = [scene.sample_ref_idx(int(i), pyrng) for i in order]
        frames = order[:, None]
        if mult > 1:
            # the extra k - 1 frames of each step, drawn uniformly; frame 0
            # keeps the epoch order and owns the reference pair
            frames = np.concatenate([frames, np.random.randint(
                0, n_views, size=(n_views, mult - 1))], axis=1)
        if epoch_scan:
            # the whole epoch queued on the device (on the card: n replays
            # of the captured step); its metrics come back as one copy
            it0 = sched_state.it + 1
            t_start = time.perf_counter()
            try:
                state, aux_mean, _ = epoch_fn(
                    state, batch0, frames if mult > 1 else order,
                    ref_order, scalars, step_gen, static)
            except FloatingPointError as e:
                raise FloatingPointError(
                    f"training epoch {epoch} (steps it={it0}.."
                    f"{it0 + n_views - 1}): {e}") from e
            sched_state.it += n_views
            it = sched_state.it
            throughput.tick(n_views)
            keys = list(epoch_fn.steps)
            # epoch e's pose table, copied before epoch e+1 can move it
            copy = HostCopy({
                "mean": torch.stack([aux_mean[k] for k in keys]),
                "steps": torch.stack([epoch_fn.steps[k] for k in keys], 1),
                "pose_r": state.params["pose"]["r"].detach(),
                "pose_t": state.params["pose"]["t"].detach()})
            pending = (epoch, it, keys, copy, order,
                       epoch_fn.last_dispatch, t_start)
            if eager_metrics:
                process_epoch(pending)
            else:
                if pending_prev is not None:
                    process_epoch(pending_prev, t_next=t_start)
                pending_prev = pending

            def crossed(every):
                return every > 0 and (it0 - 1) // every != it // every

            if crossed(vis_reproj_every) and static.get("use_rgb_s"):
                dump_pair_images(state, cfg, render_cfg, init_c2w, batch0,
                                 int(order[-1]), int(ref_order[-1]), scalars,
                                 it, render_path, mesh)
            if lead and crossed(checkpoint_every):
                save_all(checkpoint_io, state, sched_state, cfg)
            if lead and crossed(backup_every):
                save_all(checkpoint_io, state, sched_state, cfg,
                         suffix=f"_{it}")
            if crossed(visualize_every):
                render_visdata(state, cfg, render_cfg, init_c2w, scene,
                               tcfg["vis_resolution"], it,
                               os.path.join(render_path, "%04d_vis" % it),
                               mesh=mesh)
            continue
        steps = {"loss": [], "l2_mean": [], "loss_pc": [], "loss_rgb_s": []}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        timing = tracing.DeviceTimer(device)
        for step_frames, ref_idx in zip(frames, ref_order):
            sched_state.it += 1
            it = sched_state.it
            idx = int(step_frames[0])
            batch = dict(batch0, idx=step_frames.tolist(),
                         ref_idx=int(ref_idx))
            try:
                state, aux = step_fn(state, batch, scalars, static, step_gen)
            except FloatingPointError as e:
                raise FloatingPointError(
                    f"training step it={it} (epoch {epoch}, frame {idx}): "
                    f"{e}") from e
            for k in steps:
                steps[k].append(float(aux[k]))
            throughput.tick()
            if log_ss_per_view:
                scale_dict["view %02d" % idx] = float(aux["scale"])
                shift_dict["view %02d" % idx] = float(aux["shift"])
            if (vis_reproj_every > 0 and static.get("use_rgb_s")
                    and it % vis_reproj_every == 0):
                dump_pair_images(state, cfg, render_cfg, init_c2w, batch0,
                                 idx, ref_idx, scalars, it, render_path, mesh)
            if print_every > 0 and it % print_every == 0:
                rate = throughput.rate()
                say(f"[Epoch {epoch:02d}] it={it:03d}, "
                    f"loss={steps['loss'][-1]:.8f}, rays/s={rate:.0f}")
                throughput.reset()
                for tag, v in aux.items():
                    logger.add_scalar(f"train/{tag}", float(v), it)
                logger.add_scalar("perf/rays_per_sec", rate, it)
                for vname, v in scale_dict.items():
                    logger.add_scalar(f"train/scale{vname}", v, it)
                for vname, v in shift_dict.items():
                    logger.add_scalar(f"train/shift{vname}", v, it)
            if lead and checkpoint_every > 0 and it % checkpoint_every == 0:
                save_all(checkpoint_io, state, sched_state, cfg)
            if lead and backup_every > 0 and it % backup_every == 0:
                save_all(checkpoint_io, state, sched_state, cfg,
                         suffix=f"_{it}")
            if visualize_every > 0 and it % visualize_every == 0:
                render_visdata(state, cfg, render_cfg, init_c2w, scene,
                               tcfg["vis_resolution"], it,
                               os.path.join(render_path, "%04d_vis" % it),
                               mesh=mesh)
        timing.stop()
        dt = time.perf_counter() - t0
        psnr = float(mse2psnr(float(np.mean(steps["l2_mean"]))))
        rec = epoch_record(epoch, sched_state.it, len(order),
                           float(np.mean(steps["loss"])), steps["loss"], psnr,
                           dt, timing.seconds(), n_rays)
        say(epoch_line(rec))
        logger.add_scalar("train/loss_pc_epoch", np.mean(steps["loss_pc"]),
                          sched_state.it)
        logger.add_scalar("train/loss_rgbs_epoch",
                          np.mean(steps["loss_rgb_s"]), sched_state.it)
        rec.update(end_of_epoch(epoch, sched_state.it, psnr,
                                state.params["pose"]))
        history.append(rec)
    if pending_prev is not None:
        # drain the pipeline: the last epoch's metrics are still pending
        process_epoch(pending_prev)
    if lead:
        save_all(checkpoint_io, state, sched_state, cfg)
    logger.close()
    barrier(mesh)  # no rank leaves before rank 0's files are written
    return state, sched, scene, history
