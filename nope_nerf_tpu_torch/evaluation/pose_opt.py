"""Test-time pose optimisation (port of
``nope_nerf_tpu/evaluation/pose_opt.py``).

Before the held-out views are rendered, the field is frozen and a fresh
pose table for the eval frames is fitted by photometric MSE for
``opt_pose_epoch`` epochs, with Adam and a MultiStepLR schedule (gamma 0.5
at num_epoch/5 milestones, stepped per epoch). The gradient reaches the
poses through the renderer, so on a fused config each step runs Kernel A's
forward and its backward for d_origins / d_rays / d_dirs only (no weight
needs a gradient). The JAX package scans blocks of steps in one dispatch to
amortise TPU dispatch; the port runs step by step.

Pose initialisation (``eval_pose.init_method``): 'pre' (neighbouring
learned train poses), 'scale' / 'ate' (gt test poses aligned to the learned
trajectory), 'none' (identity).
"""
from __future__ import annotations

import bisect

import numpy as np
import torch

from ..geometry.align import align_ate_c2b_use_a2b, align_scale_c2b_use_a2b
from ..geometry.rays import pixels_from_flat_idx, rigid_inv
from ..models.pose import all_poses, init_pose_params, pose_c2w
from ..ops.rendering import render_rays
from ..training.trainer import sample_ray_idx

# epochs between two ``opt/psnr`` log lines (the JAX package logs once per
# block of this many epochs)
LOG_EVERY = 50


def init_eval_poses(init_method, eval_c2ws_gt, learned_c2ws_train,
                    colmap_c2ws_train, sample_rate, n_eval):
    """-> init_c2w (n_eval, 4, 4) numpy, or None for 'none'."""
    if init_method == "none":
        return None
    if init_method == "pre":
        start = int(sample_rate / 2) - 1
        picked = learned_c2ws_train[start::sample_rate - 1][:n_eval]
        return np.asarray(picked)
    if init_method == "scale":
        init, _ = align_scale_c2b_use_a2b(
            colmap_c2ws_train, learned_c2ws_train, np.array(eval_c2ws_gt))
        return init
    if init_method == "ate":
        return align_ate_c2b_use_a2b(colmap_c2ws_train, learned_c2ws_train,
                                     eval_c2ws_gt)
    raise ValueError(f"unknown init_method {init_method}")


def lr_schedule(num_epoch, lr):
    """Per-epoch LR under MultiStepLR(milestones=range(0, E, E/5),
    gamma=0.5), stepped once per epoch."""
    milestones = list(range(0, int(num_epoch), max(int(num_epoch / 5), 1)))
    return np.array([lr * 0.5 ** bisect.bisect_right(milestones, e)
                     for e in range(num_epoch)], np.float32)


def pose_opt_loss(pose_params, nerf_params, eval_imgs, camera_mat, scale_mat,
                  i, ray_idx, init_c2w, render_cfg):
    """Photometric MSE of eval frame ``i`` at the flat pixel indices
    ``ray_idx``, rendered from the pose table's pose ``i`` with no
    stratified jitter (eval mode)."""
    H, W = eval_imgs.shape[1:3]
    c2w = pose_c2w(pose_params, i, init_c2w)
    p, _, _ = pixels_from_flat_idx(ray_idx, (H, W))
    rgb_gt = eval_imgs[i].reshape(-1, 3)[ray_idx]
    depth = torch.ones(ray_idx.shape[0], dtype=torch.float32,
                       device=ray_idx.device)
    out = render_rays(nerf_params, p, depth, camera_mat, rigid_inv(c2w),
                      scale_mat, render_cfg, add_noise=False, eval_mode=True)
    return torch.mean((out["rgb"] - rgb_gt) ** 2)


def optimize_eval_poses(nerf_params, camera_mat, cfg, render_cfg, eval_imgs,
                        scale_mat, init_c2w, num_epoch, lr, n_points,
                        logger=None, seed=0):
    """Fit one pose per eval frame, frames ``0..n_eval-1`` in every epoch.

    ``eval_imgs`` (n_eval, H, W, 3) and the field's tensors lie on the
    device to run on; ``camera_mat``, ``scale_mat`` (4, 4) and ``init_c2w``
    (n_eval, 4, 4) or None may be numpy. The field is frozen (detached: no
    graph reaches it). Logs ``opt/psnr`` of the last epoch's mean loss every
    :data:`LOG_EVERY` epochs and at the end. Ray indices: ``randint`` with
    ``tpu.fast_ray_sampling``, else ``randperm``, from a generator seeded
    with ``seed``. Returns (eval_c2ws (n_eval, 4, 4) numpy, the pose
    table).
    """
    eval_imgs = torch.as_tensor(eval_imgs)
    dev = eval_imgs.device
    n_eval, H, W = eval_imgs.shape[:3]

    def on_dev(a):
        return None if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=dev)

    camera_mat, scale_mat, init_c2w = (on_dev(a) for a in
                                       (camera_mat, scale_mat, init_c2w))
    frozen = {k: {kk: t.detach() for kk, t in layer.items()}
              for k, layer in nerf_params.items()}
    pose_params = init_pose_params(n_eval, dev)
    for t in pose_params.values():
        t.requires_grad_(True)
    opt = torch.optim.Adam([pose_params["r"], pose_params["t"]],
                           betas=(0.9, 0.999), eps=1e-8)
    fast = (cfg.get("tpu", {}) or {}).get("fast_ray_sampling", True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lrs = lr_schedule(num_epoch, lr)
    for epoch in range(num_epoch):
        for group in opt.param_groups:
            group["lr"] = float(lrs[epoch])
        losses = []
        for i in range(n_eval):
            ray_idx = sample_ray_idx(n_points, (H, W), fast, gen, dev)
            opt.zero_grad(set_to_none=True)
            loss = pose_opt_loss(pose_params, frozen, eval_imgs, camera_mat,
                                 scale_mat, i, ray_idx, init_c2w, render_cfg)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if logger is not None and ((epoch + 1) % LOG_EVERY == 0
                                   or epoch == num_epoch - 1):
            mse = float(torch.stack(losses).mean())
            logger.add_scalar("opt/psnr", -10.0 * np.log10(max(mse, 1e-10)),
                              epoch)
    with torch.no_grad():
        eval_c2ws = all_poses(pose_params, init_c2w).cpu().numpy()
    return eval_c2ws, pose_params
