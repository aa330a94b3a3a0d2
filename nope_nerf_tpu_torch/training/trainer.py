"""Training step: render + all losses + the 4-group Adam update (port of
``nope_nerf_tpu/training/trainer.py``).

The parameters are one dict {'nerf', 'pose', 'focal', 'distortion'} of leaf
tensors, differentiated by one backward pass and updated by one
``torch.optim.Adam`` with a param group per top-level key. Where the JAX
step selected with ``jnp.where`` on traced scalars (the frame-order swap,
the pinned last scale), the port branches on host ints. Random draws (ray
indices, stratified jitter) come from an explicit ``torch.Generator`` on
the tensors' device.
"""
from __future__ import annotations

import torch

from ..geometry.rays import (
    arange_pixels,
    camera_mat_from_fxfy,
    pixels_from_flat_idx,
    project_to_cam,
    rigid_inv,
    transform_to_world,
)
from ..losses.losses import total_loss
from ..models.distortion import distortion_scale_shift
from ..models.intrinsics import focal_fxfy
from ..models.pose import pose_c2w
from ..ops.interp import grid_sample, resize_bilinear, resize_nearest
from ..ops.rendering import render_rays

GROUPS = ("nerf", "pose", "focal", "distortion")


def group_tensors(group_params):
    """The leaf tensors of one parameter group, in a fixed order."""
    if isinstance(group_params, dict):
        return [t for k in sorted(group_params)
                for t in group_tensors(group_params[k])]
    return [group_params]


class TrainState:
    """Parameters and their Adam optimiser (betas 0.9 / 0.999, eps 1e-8,
    one param group per top-level key; learning rates are set every step
    from the schedule)."""

    def __init__(self, params):
        self.params = params
        groups = []
        for g in GROUPS:
            ts = group_tensors(params[g])
            for t in ts:
                t.requires_grad_(True)
            groups.append({"params": ts, "name": g, "lr": 0.0})
        self.optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999),
                                          eps=1e-8)


def init_train_state(params):
    return TrainState(params)


def _apply_distortion(depth, scale, shift, shift_first):
    if shift_first:
        return (depth + shift) * scale
    return depth * scale + shift


def _sample_ray_idx(batch, n_points, H, W, fast_sampling, generator):
    dev = batch["imgs"].device
    if "ray_idx" in batch:
        # injected indices (parity harnesses) replace the random draw
        return batch["ray_idx"].to(dev).long()
    if fast_sampling:
        return torch.randint(0, H * W, (n_points,), generator=generator,
                             device=dev)
    return torch.randperm(H * W, generator=generator, device=dev)[:n_points]


def compute_loss(params, batch, scalars, *, cfg, static, init_c2w=None,
                 render_cfg, generator=None):
    """The loss of one step and its aux dict (the JAX ``compute_loss``).

    batch: imgs (N, H, W, 3), dpts (N, Hd, Wd), optional dpts_small /
    imgs_small, camera_mat_gt, scale_mat (4, 4) on the device; idx and
    ref_idx host ints; optional ray_idx (n,). scalars: weights (7 floats),
    w_l1, w_l2. static: render_model / use_ref / use_rgb_s booleans.
    """
    idx = batch["idx"]
    if not isinstance(idx, int):
        raise NotImplementedError(
            "several frames per step (tpu.rays_per_step_multiplier > 1) are "
            "not ported yet")
    ref_idx = batch["ref_idx"]
    img = batch["imgs"][idx]
    depth_raw = batch["dpts"][idx]
    camera_mat_gt = batch["camera_mat_gt"]
    scale_mat = batch["scale_mat"]
    dev = img.device
    H, W, _ = img.shape
    hd, wd = depth_raw.shape

    tcfg, pcfg, dcfg = cfg["training"], cfg["pose"], cfg["distortion"]
    tpu = cfg.get("tpu", {}) or {}
    n_points = tcfg["n_training_points"]
    nl = tcfg["nearest_limit"]
    num_cams = cfg["_num_cams"]
    learn_dist = dcfg["learn_distortion"]
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    def c2w_of(i):
        return pose_c2w(params["pose"], i, init_c2w, pcfg["learn_R"],
                        pcfg["learn_t"])

    def scale_shift(i):
        if not learn_dist:
            return (torch.ones(1, device=dev), torch.zeros(1, device=dev))
        return distortion_scale_shift(params["distortion"], i, num_cams,
                                      dcfg["fix_scaleN"], dcfg["learn_scale"],
                                      dcfg["learn_shift"])

    # ---- pose / distortion / intrinsics --------------------------------
    if pcfg["learn_pose"]:
        c2w = c2w_of(idx)
        world_mat = rigid_inv(c2w)
    else:
        c2w = world_mat = eye
    scale_input, shift_input = scale_shift(idx)
    aux = {}
    if pcfg["learn_focal"]:
        fxfy = focal_fxfy(params["focal"], fx_only=pcfg["fx_only"],
                          order=pcfg["focal_order"],
                          req_grad=pcfg["update_focal"])
        camera_mat = camera_mat_from_fxfy(fxfy)
        aux["focalx"] = fxfy[0] / camera_mat_gt[0, 0]
        aux["focaly"] = fxfy[1] / camera_mat_gt[1, 1]
    else:
        camera_mat = camera_mat_gt

    # ---- ray sampling + render ------------------------------------------
    out = {}
    rgb_gt = None
    if static["render_model"]:
        r_idx = _sample_ray_idx(batch, n_points, H, W,
                                tpu.get("fast_ray_sampling", True), generator)
        rgb_gt = img.reshape(-1, 3)[r_idx]
        p, rr, rc = pixels_from_flat_idx(r_idx, (H, W))
        if (hd, wd) == (H, W):
            didx = r_idx
        else:
            # resize_nearest's f32 index math, gathered at the sampled rays
            drr = torch.floor(rr.to(torch.float32)
                              * torch.tensor(hd / H, dtype=torch.float32)).long()
            drc = torch.floor(rc.to(torch.float32)
                              * torch.tensor(wd / W, dtype=torch.float32)).long()
            didx = drr * wd + drc
        d_rays = depth_raw.reshape(-1)[didx]
        if learn_dist:
            d_rays = _apply_distortion(d_rays, scale_input, shift_input,
                                       tcfg["shift_first"])
        out = render_rays(params["nerf"], p, d_rays, camera_mat, world_mat,
                          scale_mat, render_cfg, generator=generator,
                          add_noise=tpu.get("render_add_noise", True),
                          eval_mode=False)

    # ---- reference-image branch -------------------------------------------
    loss_kwargs = {}
    if static["use_ref"]:
        c2w_ref = c2w_of(ref_idx)
        scale_ref, shift_ref = scale_shift(ref_idx)
        if tcfg["detach_ref_img"]:
            c2w_ref = c2w_ref.detach()
            scale_ref, shift_ref = scale_ref.detach(), shift_ref.detach()
        ref_Rt = rigid_inv(c2w_ref)
        # frame ordering: the pair is (earlier=1, later=2)
        swap = idx >= num_cams - 1
        Rt_rel_12 = world_mat @ c2w_ref if swap else ref_Rt @ c2w
        R_rel_12 = Rt_rel_12[:3, :3]
        t_rel_12 = Rt_rel_12[:3, 3]
        scale2 = scale_input if swap else scale_ref

        ratio = tcfg["pc_ratio"]
        sres = (int(hd / ratio), int(wd / ratio))
        _, p_pc = arange_pixels(sres, device=dev)
        if "dpts_small" in batch:
            dsm_cur = batch["dpts_small"][idx]
            dsm_ref = batch["dpts_small"][ref_idx]
        else:
            dsm_cur = resize_nearest(depth_raw, sres)
            dsm_ref = resize_nearest(batch["dpts"][ref_idx], sres)
        d1s, d2s = (dsm_ref, dsm_cur) if swap else (dsm_cur, dsm_ref)
        if learn_dist:
            scale1, shift1, shift2 = ((scale_ref, shift_ref, shift_input)
                                      if swap else
                                      (scale_input, shift_input, shift_ref))
            d1s = _apply_distortion(d1s, scale1, shift1, tcfg["shift_first"])
            d2s = _apply_distortion(d2s, scale2, shift2, tcfg["shift_first"])
        d1s = torch.clamp_min(d1s, nl)
        d2s = torch.clamp_min(d2s, nl)
        pc1 = transform_to_world(p_pc, d1s.reshape(-1), camera_mat)
        pc2 = transform_to_world(p_pc, d2s.reshape(-1), camera_mat)

        if static["use_rgb_s"]:
            if "imgs_small" in batch:
                ism_cur = batch["imgs_small"][idx]
                ism_ref = batch["imgs_small"][ref_idx]
            else:
                ism_cur = resize_bilinear(img, sres)
                ism_ref = resize_bilinear(batch["imgs"][ref_idx], sres)
            img1s, img2s = (ism_ref, ism_cur) if swap else (ism_cur, ism_ref)
            pc1_for_rgb = pc1.detach() if tcfg["detach_rgbs_scale"] else pc1
            pc1_rot = pc1_for_rgb @ R_rel_12.t() + t_rel_12
            # clamp points behind the near limit (all 3 coordinates)
            invalid = -pc1_rot[:, 2:] < nl
            pc1_rot = torch.where(invalid, torch.full_like(pc1_rot, nl),
                                  pc1_rot)
            p_reproj, valid = project_to_cam(pc1_rot, camera_mat)
            rgb_pc1_proj = grid_sample(img2s, p_reproj, mode="bilinear",
                                       align_corners=True)
            # img1s sampled at its own pixel grid is the identity
            loss_kwargs["rgb_pc1"] = img1s
            loss_kwargs["rgb_pc1_proj"] = rgb_pc1_proj.reshape(sres[0],
                                                               sres[1], 3)
            loss_kwargs["valid_points"] = valid.to(torch.float32).reshape(
                sres[0], sres[1], 1)
            if tcfg.get("with_auto_mask", False):
                loss_kwargs["rgb_pc1_ori"] = img2s

        pc1 = pc1 @ R_rel_12.t() + t_rel_12
        if tpu.get("chamfer_mode", "exact") in ("band", "auto"):
            from ..ops.kernels.chamfer_band import TILE, rows_to_start_tiles

            band_rows = tpu.get("chamfer_band_rows", 32)
            k_band = tpu.get("chamfer_band_tiles") or max(
                2, round(band_rows * sres[1] / TILE))
            n_pc = sres[0] * sres[1]
            q21 = (pc2 - t_rel_12) @ R_rel_12
            loss_kwargs["chamfer_starts"] = (
                rows_to_start_tiles(pc1, n_pc, sres, camera_mat,
                                    project_to_cam, k_band),
                rows_to_start_tiles(q21, n_pc, sres, camera_mat,
                                    project_to_cam, k_band),
            )
            loss_kwargs["chamfer_band_tiles"] = k_band
        if tcfg["scale_pcs"]:
            pc1 = pc1 / scale2
            pc2 = pc2 / scale2
        loss_kwargs["X"] = pc1
        loss_kwargs["Y"] = pc2

    # ---- assemble -------------------------------------------------------
    depth_gt = out.get("depth_gt")
    if static["render_model"] and tcfg["detach_gt_depth"]:
        depth_gt = depth_gt.detach()
    loss_dict = total_loss(
        scalars["weights"],
        rgb_pred=out.get("rgb"),
        rgb_gt=rgb_gt,
        depth_pred=out.get("depth_pred"),
        depth_gt=depth_gt,
        depth_valid=out.get("valid_mask"),
        t_list=params["pose"]["t"] if pcfg["learn_pose"] else None,
        w_l1=scalars["w_l1"],
        w_l2=scalars["w_l2"],
        with_ssim=tcfg["with_ssim"],
        depth_loss_type=tcfg["depth_loss_type"],
        chamfer_block=tpu.get("chamfer_block", 2048),
        chamfer_mode=tpu.get("chamfer_mode", "exact"),
        with_auto_mask=tcfg.get("with_auto_mask", False),
        **loss_kwargs,
    )
    aux.update(loss_dict)
    aux["scale"] = scale_input[0]
    aux["shift"] = shift_input[0]
    return loss_dict["loss"], aux


def make_train_step(cfg, render_cfg, init_c2w=None):
    """step(state, batch, scalars, static, generator) -> (state, aux): one
    loss + backward + Adam update, in place on ``state``.

    Every parameter gets a gradient (zeros where the loss does not reach
    it), so Adam's moments and step counts advance for all of them as
    optax's do; weight decay is added to the nerf gradient only, before
    Adam, as torch's ``weight_decay`` would.
    """
    wd = cfg["training"].get("weight_decay", 0.0) or 0.0

    def step(state, batch, scalars, static, generator=None):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, aux = compute_loss(state.params, batch, scalars, cfg=cfg,
                                 static=static, init_c2w=init_c2w,
                                 render_cfg=render_cfg, generator=generator)
        loss.backward()
        with torch.no_grad():
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    elif wd > 0.0 and group["name"] == "nerf":
                        p.grad.add_(p, alpha=wd)
                group["lr"] = float(scalars["lrs"][group["name"]])
        opt.step()
        return state, {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in aux.items()}

    return step


def make_render_cfg(cfg, device):
    """Merge the rendering + model groups for ``render_rays``.

    ``tpu.use_pallas_mlp`` (the hand-written CUDA kernel here) and
    ``tpu.mlp_bf16`` default to True for CUDA tensors and False for CPU
    ones; ``tpu.n_max_network_queries`` defaults to 2**21 points.
    """
    tpu = cfg.get("tpu", {}) or {}
    on_cuda = torch.device(device).type == "cuda"
    rc = dict(cfg["rendering"])
    rc.update({
        "occ_activation": cfg["model"]["occ_activation"],
        "pos_enc_levels": cfg["model"]["pos_enc_levels"],
        "dir_enc_levels": cfg["model"]["dir_enc_levels"],
        "hidden_dim": cfg["model"]["hidden_dim"],
        "n_max_network_queries": tpu.get("n_max_network_queries", 2 ** 21),
        "mlp_bf16": tpu.get("mlp_bf16", on_cuda),
        "use_pallas_mlp": tpu.get("use_pallas_mlp", on_cuda),
        "fuse_compositing": tpu.get("fuse_compositing", True),
    })
    return rc
