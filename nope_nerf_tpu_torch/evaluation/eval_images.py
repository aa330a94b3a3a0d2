"""Full-image evaluation (port of
``nope_nerf_tpu/evaluation/eval_images.py``): render one view, score it
with PSNR / SSIM (/ LPIPS when a scorer is given), write its PNGs and
return the masked depths for the depth-error suite.

The JAX package writes PNGs with imageio and resizes with cv2; neither is on
the GPU machine, so the port writes with PIL and resizes with
:func:`resize_like_cv2`, which gives ``cv2.resize``'s results on f32
images.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.rendering import render_image
from ..ops.ssim import ssim as ssim_fn
from .metrics import mse2psnr


def resize_like_cv2(img, hw, mode="linear"):
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`` (``mode``
    "linear": half-pixel bilinear without antialiasing) or ``INTER_NEAREST``
    ("nearest": source index floor(dst * in / out)) of an f32 (H, W[, C])
    array or tensor; returns a tensor on the input's device."""
    x = torch.as_tensor(img, dtype=torch.float32)
    chw = x.permute(2, 0, 1)[None] if x.ndim == 3 else x[None, None]
    if mode == "linear":
        out = F.interpolate(chw, size=tuple(hw), mode="bilinear",
                            align_corners=False)
    elif mode == "nearest":
        out = F.interpolate(chw, size=tuple(hw), mode="nearest")
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return out[0].permute(1, 2, 0) if x.ndim == 3 else out[0, 0]


def _write_png(path, arr_uint8):
    from PIL import Image

    Image.fromarray(arr_uint8).save(path)


def eval_image(nerf_params, render_cfg, resolution, camera_mat, world_mat,
               scale_mat, img_gt, depth_gt=None, lpips_fn=None,
               min_depth=0.1, max_depth=20.0, render_dir=None, img_idx=0,
               chunk=65536):
    """Render one view on the field's device and compute its metrics.

    img_gt: (h, w, 3) f32 numpy in [0, 1] at the eval resolution; depth_gt:
    optional (hg, wg) numpy gt depth; lpips_fn: optional callable
    (img_pred, img_gt in [0, 1] HWC) -> float. Returns a dict: img (uint8),
    depth (pred, gt-sized), mse, psnr, ssim, lpips (nan without a scorer),
    depth_pred / depth_gt (masked flat arrays, may be empty).
    """
    h, w = resolution
    dev = nerf_params["trunk0_0"]["w"].device
    mats = [torch.as_tensor(m, dtype=torch.float32, device=dev)
            for m in (camera_mat, world_mat, scale_mat)]
    rgb_t, depth_t = render_image(nerf_params, (h, w), *mats, render_cfg,
                                  chunk=chunk)
    ssim_val = float(ssim_fn(rgb_t, torch.as_tensor(
        img_gt, dtype=torch.float32, device=dev)))
    rgb = rgb_t.cpu().numpy()
    depth = depth_t.cpu().numpy()

    mse = float(np.mean((rgb - img_gt) ** 2))
    psnr = float(mse2psnr(mse))
    lpips_val = (float(lpips_fn(rgb, img_gt)) if lpips_fn is not None
                 else float("nan"))

    depth_pred_masked = np.zeros(0, np.float32)
    depth_gt_masked = np.zeros(0, np.float32)
    depth_out = depth
    if depth_gt is not None:
        depth_out = resize_like_cv2(depth, depth_gt.shape[:2],
                                    "nearest").numpy()
        mask = (depth_gt > min_depth) & (depth_gt < max_depth)
        depth_pred_masked = depth_out[mask]
        depth_gt_masked = depth_gt[mask]

    img_uint8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    if render_dir is not None:
        for sub in ("img_out", "depth_out", "img_gt_out"):
            os.makedirs(os.path.join(render_dir, sub), exist_ok=True)
        name = str(img_idx).zfill(4) + ".png"
        _write_png(os.path.join(render_dir, "img_out", name), img_uint8)
        d = depth_out
        d_vis = np.clip(255.0 / max(d.max(), 1e-8) * (d - d.min()), 0,
                        255).astype(np.uint8)
        _write_png(os.path.join(render_dir, "depth_out", name), d_vis)
        _write_png(os.path.join(render_dir, "img_gt_out", name),
                   (np.clip(img_gt, 0, 1) * 255).astype(np.uint8))

    return {
        "img": img_uint8,
        "depth": depth_out,
        "mse": mse,
        "psnr": psnr,
        "ssim": ssim_val,
        "lpips": lpips_val,
        "depth_pred": depth_pred_masked,
        "depth_gt": depth_gt_masked,
    }
