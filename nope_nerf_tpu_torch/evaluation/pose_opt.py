"""Test-time pose optimisation (port of
``nope_nerf_tpu/evaluation/pose_opt.py``).

Before the held-out views are rendered, the field is frozen and a fresh
pose table for the eval frames is fitted by photometric MSE for
``opt_pose_epoch`` epochs, with Adam and a MultiStepLR schedule (gamma 0.5
at num_epoch/5 milestones, stepped per epoch). The gradient reaches the
poses through the renderer, so on a fused config each step runs Kernel A's
forward and its backward for d_origins / d_rays / d_dirs only (no weight
needs a gradient). As the JAX package scans a block of ``block_epochs``
epochs x n_eval steps per dispatch (``make_pose_opt_block``), the port runs
a block as replays of one captured CUDA graph of the pose step on the card
(:class:`PoseOptBlock`; eagerly on the CPU), with the per-step learning
rate and frame index in device buffers.

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
from ..training.capture import StepGraphs, bound_tensors
from ..training.trainer import frame_rows, sample_ray_idx, upload_ints


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
    """Photometric MSE of eval frame ``i`` (a host int or a 0-d int tensor
    on the device) at the flat pixel indices ``ray_idx``, rendered from the
    pose table's pose ``i`` with no stratified jitter (eval mode)."""
    H, W = eval_imgs.shape[1:3]
    c2w = pose_c2w(pose_params, i, init_c2w)
    p, _, _ = pixels_from_flat_idx(ray_idx, (H, W))
    rgb_gt = frame_rows(eval_imgs, i, ray_idx)
    depth = torch.ones(ray_idx.shape[0], dtype=torch.float32,
                       device=ray_idx.device)
    out = render_rays(nerf_params, p, depth, camera_mat, rigid_inv(c2w),
                      scale_mat, render_cfg, add_noise=False, eval_mode=True)
    return torch.mean((out["rgb"] - rgb_gt) ** 2)


class PoseOptBlock:
    """The twin of the JAX ``make_pose_opt_block``: run(nerf_params,
    pose_params, optimizer, eval_imgs, camera_mat, scale_mat, lrs_steps,
    frame_idx, generator) -> the block's losses (n_steps,) on the device,
    the pose table and ``optimizer`` (Adam over its r and t, with a tensor
    learning rate) stepped in place.

    Each step sets the learning rate of its row of ``lrs_steps``, renders
    eval frame ``frame_idx[i]`` at ``n_points`` rays drawn from
    ``generator`` (Kernel A's forward and its input-only backward on the
    fused route), and takes one Adam step on (r, t). On a CUDA device
    (unless ``eager``, the reference route) every step is a replay of one
    captured graph of the step (:class:`..training.capture.StepGraphs`;
    the first one its eager warm-up), which replays on the tensors and
    generator of its capture (a call with others raises): a device counter
    selects the step's row of the block's buffers, which hold the first
    block's number of steps (no later block is longer). ``route`` names
    the route.
    """

    def __init__(self, cfg, render_cfg, init_c2w, n_points, hw, device,
                 eager=False):
        self.render_cfg, self.init_c2w = render_cfg, init_c2w
        self.n_points, self.hw = n_points, hw
        self.fast = (cfg.get("tpu", {}) or {}).get("fast_ray_sampling", True)
        device = torch.device(device)
        self.graphs = StepGraphs(device,
                                 eager=eager or device.type != "cuda")
        self.route = self.graphs.route
        self.bufs = None

    def __call__(self, nerf_params, pose_params, optimizer, eval_imgs,
                 camera_mat, scale_mat, lrs_steps, frame_idx, generator):
        n = len(lrs_steps)
        dev = eval_imgs.device
        if self.bufs is None:
            self.bufs = {
                "lrs": torch.zeros(n, dtype=torch.float32, device=dev),
                "frames": torch.zeros(n, dtype=torch.long, device=dev),
                "losses": torch.zeros(n, dtype=torch.float32, device=dev),
                "counter": torch.zeros((), dtype=torch.long, device=dev)}
        b = self.bufs
        if n > b["lrs"].shape[0]:
            raise ValueError(f"a block of {n} steps after one of "
                             f"{b['lrs'].shape[0]}")
        lrs = torch.from_numpy(np.asarray(lrs_steps, np.float32))
        b["lrs"][:n].copy_(lrs.pin_memory() if dev.type == "cuda" else lrs,
                           non_blocking=True)
        upload_ints(b["frames"][:n], frame_idx)
        b["counter"].zero_()
        lr = optimizer.param_groups[0]["lr"]

        def one():
            i = b["counter"].reshape(1)
            lr.copy_(b["lrs"].index_select(0, i)[0])
            f = b["frames"].index_select(0, i)[0]
            ray_idx = sample_ray_idx(self.n_points, self.hw, self.fast,
                                     generator, dev)
            optimizer.zero_grad(set_to_none=True)
            loss = pose_opt_loss(pose_params, nerf_params, eval_imgs,
                                 camera_mat, scale_mat, f, ray_idx,
                                 self.init_c2w, self.render_cfg)
            loss.backward()
            optimizer.step()
            b["losses"].index_copy_(0, i, loss.detach().reshape(1))
            b["counter"].add_(1)

        self.graphs.run("pose", one, n, (generator,), lambda: bound_tensors(
            nerf_params, pose_params, optimizer, eval_imgs, camera_mat,
            scale_mat))
        return b["losses"][:n].clone()


def pose_optimizer(pose_params, capturable):
    """Adam over the pose table's r and t (betas 0.9 / 0.999, eps 1e-8) at
    a 0-d tensor learning rate that each step writes; capturable on the
    card."""
    lr = torch.zeros((), dtype=torch.float32, device=pose_params["r"].device)
    extra = {"capturable": True, "foreach": True} if capturable else {}
    return torch.optim.Adam([pose_params["r"], pose_params["t"]], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8, **extra)


def optimize_eval_poses(nerf_params, camera_mat, cfg, render_cfg, eval_imgs,
                        scale_mat, init_c2w, num_epoch, lr, n_points,
                        logger=None, seed=0, block_epochs=50,
                        eager=False):
    """Fit one pose per eval frame, frames ``0..n_eval-1`` in every epoch,
    in blocks of ``block_epochs`` epochs (:class:`PoseOptBlock`).

    ``eval_imgs`` (n_eval, H, W, 3) and the field's tensors lie on the
    device to run on; ``camera_mat``, ``scale_mat`` (4, 4) and ``init_c2w``
    (n_eval, 4, 4) or None may be numpy. The field is frozen (detached: no
    graph reaches it). After each block, ``opt/psnr`` of the mean of the
    block's last n_eval losses at its last epoch ``b1 - 1``, as the JAX
    package logs. Ray indices: ``randint`` with ``tpu.fast_ray_sampling``,
    else ``randperm``, from a generator seeded with ``seed``. ``eager``
    runs the steps eagerly on the card too (the reference route). Returns
    (eval_c2ws (n_eval, 4, 4) numpy, the pose table).
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
    run = PoseOptBlock(cfg, render_cfg, init_c2w, n_points, (H, W), dev,
                       eager=eager)
    # capturable on the card by either route, so both take one step
    opt = pose_optimizer(pose_params, dev.type == "cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    lrs_epoch = lr_schedule(num_epoch, lr)
    frame_order = np.arange(n_eval)
    for b0 in range(0, num_epoch, block_epochs):
        b1 = min(b0 + block_epochs, num_epoch)
        losses = run(frozen, pose_params, opt, eval_imgs, camera_mat,
                     scale_mat, np.repeat(lrs_epoch[b0:b1], n_eval),
                     np.tile(frame_order, b1 - b0), gen)
        if logger is not None:
            mse = float(losses[-n_eval:].mean())
            logger.add_scalar("opt/psnr", -10.0 * np.log10(max(mse, 1e-10)),
                              b1 - 1)
    with torch.no_grad():
        eval_c2ws = all_poses(pose_params, init_c2w).cpu().numpy()
    return eval_c2ws, pose_params
