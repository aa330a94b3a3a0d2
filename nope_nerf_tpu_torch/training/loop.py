"""Training orchestration (port of the per-step path of
``nope_nerf_tpu/training/loop.py``): epoch loop, frame shuffling,
reference-frame sampling, the schedule state machine and per-epoch metrics.

Same host-side draws as the JAX loop: ``np.random.permutation`` for the
frame order and ``scene.sample_ref_idx(i, pyrng)`` for the reference
frames, both seeded with ``training.seed``. The JAX package's ``epoch_scan``
mode exists to amortise TPU dispatch; the port always runs step by step.

Not ported yet (see ROADMAP.md): checkpoints, per-epoch pose metrics,
visualisation and pair dumps are not written (one line says so);
``scheduling_mode: reset``, ``rays_per_step_multiplier > 1`` and
``n_devices > 1`` change results and raise ``NotImplementedError``.
"""
from __future__ import annotations

import json
import os
import random as pyrandom
import time

import numpy as np
import torch

from ..config import apply_parity_profile, check_supported
from ..losses.losses import mse2psnr
from ..models.distortion import init_distortion_params
from ..models.intrinsics import init_focal_params
from ..models.nerf import init_nerf_params
from ..models.pose import init_pose_params
from ..ops.interp import resize_bilinear, resize_nearest
from .scheduler import Scheduler, ScheduleState
from .trainer import init_train_state, make_render_cfg, make_train_step


class MetricsLogger:
    """Appends {tag, value, step, t} lines to ``<log_dir>/events.jsonl``
    (the JAX package's event-log format)."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "events.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "t": time.time()}) + "\n")

    def close(self):
        self._f.close()


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


def _check_ported(cfg):
    tcfg, tpu = cfg["training"], cfg.get("tpu", {}) or {}
    if tcfg.get("scheduling_mode") == "reset":
        raise NotImplementedError("training.scheduling_mode: reset is not "
                                  "ported yet")
    if int(tpu.get("rays_per_step_multiplier", 1) or 1) > 1:
        raise NotImplementedError("tpu.rays_per_step_multiplier > 1 is not "
                                  "ported yet")
    if int(tpu.get("n_devices", 1) or 1) > 1:
        raise NotImplementedError("tpu.n_devices > 1 is not ported yet")
    skipped = [name for name, on in (
        ("checkpoints", (tcfg.get("checkpoint_every") or 0) > 0
         or (tcfg.get("backup_every") or 0) > 0),
        ("per-epoch pose metrics", (tcfg.get("eval_pose_every") or 0) > 0),
        ("visualisation", (tcfg.get("visualize_every") or 0) > 0),
        ("reprojection pair dumps", (tcfg.get("vis_reprojection_every") or 0) > 0),
        ("per-view scale/shift logs", tcfg.get("log_scale_shift_per_view")),
    ) if on]
    if skipped:
        print("nope_nerf_tpu_torch: not honoured yet: " + ", ".join(skipped))


def train(cfg, max_epochs=None, scene=None, device=None):
    """Run training; ``max_epochs`` caps the loop.

    ``scene`` is any object with N_imgs, K, scale_mat, imgs (N, H, W, 3),
    dpt_depth (N, H, W) or None, c2ws and ``sample_ref_idx(i, rng)``; when
    None it is loaded from ``dataloading`` with the JAX package's numpy
    loader (``nope_nerf_tpu.dataloading.scene``, numpy + PIL). ``device``
    defaults to the first CUDA device when there is one.

    Returns (state, scheduler, scene, history): history has one dict per
    epoch (epoch, it, steps, loss, step_losses, psnr, ms_per_step,
    rays_per_sec).
    """
    check_supported(cfg)
    apply_parity_profile(cfg)
    _check_ported(cfg)
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    seed = int(cfg["training"].get("seed", 42) or 42)
    np.random.seed(seed)
    pyrng = pyrandom.Random(seed)
    init_gen = torch.Generator().manual_seed(seed)
    step_gen = torch.Generator(device=device).manual_seed(seed)

    out_dir = cfg["training"]["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, "logs"))
    if scene is None:
        from nope_nerf_tpu.dataloading.scene import get_scene

        scene = get_scene(cfg, mode=cfg["training"]["mode"])
    batch0 = scene_batch_arrays(scene, cfg, device)
    n_views = scene.N_imgs
    cfg = dict(cfg)
    cfg["_num_cams"] = n_views
    render_cfg = make_render_cfg(cfg, device)
    params, init_c2w = build_params(cfg, scene, init_gen, device)
    state = init_train_state(params)
    sched_state = ScheduleState(
        scheduling_start=cfg["training"]["scheduling_start"])
    sched = Scheduler(cfg, sched_state)
    step_fn = make_train_step(cfg, render_cfg, init_c2w)
    print_every = cfg["training"]["print_every"]
    n_rays = cfg["training"]["n_training_points"]
    history = []

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
        steps = {"loss": [], "l2_mean": [], "loss_pc": [], "loss_rgb_s": []}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for idx, ref_idx in zip(order, ref_order):
            sched_state.it += 1
            it = sched_state.it
            batch = dict(batch0, idx=int(idx), ref_idx=int(ref_idx))
            state, aux = step_fn(state, batch, scalars, static, step_gen)
            for k in steps:
                steps[k].append(float(aux[k]))
            if print_every > 0 and it % print_every == 0:
                print(f"[Epoch {epoch:02d}] it={it:03d}, "
                      f"loss={steps['loss'][-1]:.8f}")
                for tag, v in aux.items():
                    logger.add_scalar(f"train/{tag}", float(v), it)
        dt = time.perf_counter() - t0
        n = len(order)
        psnr = float(mse2psnr(float(np.mean(steps["l2_mean"]))))
        rec = {"epoch": epoch, "it": sched_state.it, "steps": n,
               "loss": float(np.mean(steps["loss"])),
               "step_losses": steps["loss"], "psnr": psnr,
               "ms_per_step": 1e3 * dt / n,
               "rays_per_sec": n * n_rays / dt}
        history.append(rec)
        print(f"[Epoch {epoch:02d}] it={sched_state.it:03d}, "
              f"loss={rec['loss']:.8f}, psnr={psnr:.4f}, "
              f"ms/step={rec['ms_per_step']:.3f}, "
              f"rays/s={rec['rays_per_sec']:.0f}")
        logger.add_scalar("train/loss_pc_epoch", np.mean(steps["loss_pc"]),
                          sched_state.it)
        logger.add_scalar("train/loss_rgbs_epoch",
                          np.mean(steps["loss_rgb_s"]), sched_state.it)
        logger.add_scalar("perf/rays_per_sec", rec["rays_per_sec"],
                          sched_state.it)
        if (cfg["training"]["eval_img_every"] or 0) > 0 and (
                epoch % cfg["training"]["eval_img_every"]) == 0:
            logger.add_scalar("train/psnr", psnr, sched_state.it)
        sched.update_plateau(epoch, psnr)
        for g, v in sched.lrs(epoch).items():
            logger.add_scalar(f"train/lr_{g}", v, sched_state.it)
    logger.close()
    return state, sched, scene, history
