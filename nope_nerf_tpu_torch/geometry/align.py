"""Trajectory alignment and pose-accuracy metrics (host numpy).

Port of ``nope_nerf_tpu/geometry/align.py`` l.20-149, which the port cannot
import: that package's ``geometry/__init__`` and ``so3`` import jax. Umeyama
Sim(3)/SE(3) alignment, ``align_ate_c2b_use_a2b`` / ``align_scale_c2b_use_a2b``,
ATE (RMSE of aligned translations) and RPE (mean relative pose errors).
"""
from __future__ import annotations

import numpy as np


def align_umeyama(model, data, known_scale=False, yaw_only=False):
    """Closed-form s, R, t minimising ||model - (s R data + t)||^2
    (Umeyama 1991, with the reflection fix). model/data: (N, 3)."""
    n = model.shape[0]
    model_mean = model.mean(0)
    data_mean = data.mean(0)
    model_c = model - model_mean
    data_c = data - data_mean

    cov = model_c.T @ data_c / n
    data_var = float((data_c * data_c).sum()) / n
    u, sv, vt = np.linalg.svd(cov)
    # flip the smallest singular direction when u vt would be a reflection
    flip = np.ones(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        flip[2] = -1.0

    if yaw_only:
        rot = _rot_z(_best_yaw(data_c.T @ model_c))
    else:
        rot = (u * flip) @ vt

    if known_scale:
        scale = 1.0
    elif data_var > 0.0:
        scale = float((sv * flip).sum()) / data_var
    else:
        # every data point at one place (e.g. poses that never moved from
        # their start): s = 0 is the least-squares optimum, which maps them
        # onto the model's mean; the JAX package divides by zero here
        scale = 0.0
    shift = model_mean - scale * (rot @ data_mean)
    return scale, rot, shift


def _best_yaw(C):
    A = C[0, 1] - C[1, 0]
    B = C[0, 0] + C[1, 1]
    return np.pi / 2 - np.arctan2(B, A)


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def align_trajectory(p_es, p_gt, method="sim3", n_aligned=-1):
    """(s, R, t) such that gt ~ R s est + t; method sim3 | se3 | posyaw |
    none."""
    idx = slice(None) if n_aligned == -1 else slice(0, n_aligned)
    est, gt = p_es[idx], p_gt[idx]
    if method == "sim3":
        return align_umeyama(gt, est)
    if method == "se3":
        _, R, t = align_umeyama(gt, est, known_scale=True)
        return 1.0, R, t
    if method == "posyaw":
        _, R, t = align_umeyama(gt, est, known_scale=True, yaw_only=True)
        return 1.0, R, t
    if method == "none":
        return 1.0, np.eye(3), np.zeros(3)
    raise ValueError(f"unknown alignment method {method}")


def align_ate_c2b_use_a2b(traj_a, traj_b, traj_c=None, method="sim3"):
    """Align trajectory c (default a) to b with the fit from a to b.
    traj_*: (N, 4, 4) c2w; returns the aligned (N, 4, 4) f32."""
    traj_a = np.asarray(traj_a, np.float64)
    traj_b = np.asarray(traj_b, np.float64)
    traj_c = traj_a.copy() if traj_c is None else np.asarray(traj_c, np.float64)

    s, R, t = align_trajectory(traj_a[:, :3, 3], traj_b[:, :3, 3],
                               method=method)
    out = np.tile(np.eye(4), (traj_c.shape[0], 1, 1))
    out[:, :3, :3] = R[None] @ traj_c[:, :3, :3]
    out[:, :3, 3:4] = s * (R[None] @ traj_c[:, :3, 3:4]) + t.reshape(1, 3, 1)
    return out.astype(np.float32)


def align_scale_c2b_use_a2b(traj_a, traj_b, traj_c=None):
    """Scale-only alignment: c's translations times the ratio of b's to a's
    largest distance from their first frame. Returns (traj (N, 4, 4) f32,
    scale); the inputs are not modified."""
    traj_a = np.asarray(traj_a, np.float64)
    traj_b = np.asarray(traj_b, np.float64)
    traj_c = np.array(traj_a if traj_c is None else traj_c, np.float64)

    def pts_dist_max(pts):
        return np.linalg.norm(pts - pts[0], axis=1).max()

    scale = pts_dist_max(traj_b[:, :3, 3]) / pts_dist_max(traj_a[:, :3, 3])
    traj_c[:, :3, 3] *= scale
    return traj_c.astype(np.float32), scale


def rotation_error(pose_error):
    d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
    return np.arccos(max(min(d, 1.0), -1.0))


def translation_error(pose_error):
    return float(np.linalg.norm(pose_error[:3, 3]))


def compute_rpe(gt, pred):
    """Mean relative pose errors between consecutive frames:
    (rpe_trans, rpe_rot in radians)."""
    trans_errors, rot_errors = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        pred_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
        rel_err = np.linalg.inv(gt_rel) @ pred_rel
        trans_errors.append(translation_error(rel_err))
        rot_errors.append(rotation_error(rel_err))
    return float(np.mean(trans_errors)), float(np.mean(rot_errors))


def compute_ate(gt, pred):
    """RMSE of the translation errors."""
    errs = [np.linalg.norm(g[:3, 3] - p[:3, 3]) for g, p in zip(gt, pred)]
    return float(np.sqrt(np.mean(np.square(errs))))
