"""Evaluation metrics on the host (port of
``nope_nerf_tpu/evaluation/metrics.py``): PSNR, the depth-error suite
(abs_rel, sq_rel, rmse, rmse_log, a1/a2/a3) and its median-ratio scaling.
"""
from __future__ import annotations

import numpy as np


def mse2psnr(mse):
    mse = np.maximum(mse, 1e-10)
    return (-10.0 * np.log10(mse)).astype(np.float32)


def compute_depth_errors(gt, pred):
    """gt/pred: flat numpy arrays (masked)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def median_scaled_depth_errors(depth_gts, depth_preds, min_depth=0.1,
                               max_depth=20.0):
    """Scale every prediction by the ratio of the medians over all frames,
    clip, and average the per-frame errors. Returns (errors (7,), ratio)."""
    ratio = np.median(np.concatenate(depth_gts)) / np.median(
        np.concatenate(depth_preds))
    errors = []
    for gt, pred in zip(depth_gts, depth_preds):
        pred = np.clip(pred * ratio, min_depth, max_depth)
        errors.append(compute_depth_errors(gt, pred))
    return np.array(errors).mean(0), ratio
