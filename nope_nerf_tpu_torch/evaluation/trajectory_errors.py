"""Trajectory-error analysis (port of
``nope_nerf_tpu/evaluation/trajectory_errors.py``, host numpy): per-frame
absolute errors, distance-binned relative errors and summary statistics.
"""
from __future__ import annotations

import json

import numpy as np

from ..geometry.align import rotation_error


def get_distance_from_start(gt_translation):
    """Cumulative travelled distance along the trajectory."""
    d = np.diff(gt_translation[:, :3], axis=0)
    d = np.sqrt(np.sum(d * d, axis=1))
    return np.concatenate(([0], np.cumsum(d)))


def compute_comparison_indices_length(distances, dist, max_dist_diff):
    """For each start index, the index about ``dist`` further along (-1
    when none lies within ``max_dist_diff``)."""
    comparisons = []
    for idx, d in enumerate(distances):
        error = max_dist_diff
        best_idx = -1
        for i in range(idx, len(distances)):
            if abs(distances[i] - (d + dist)) < error:
                best_idx = i
                error = abs(distances[i] - (d + dist))
        comparisons.append(best_idx)
    return comparisons


def compute_absolute_error(p_es_aligned, q_es_aligned, p_gt, q_gt):
    """Per-frame translation errors (norms and vectors) and rotation errors
    in degrees; rotations as (N, 3, 3)."""
    e_trans_vec = p_gt - p_es_aligned
    e_trans = np.linalg.norm(e_trans_vec, axis=1)
    e_rot = np.array([
        np.degrees(rotation_error(np.block([
            [q_gt[i] @ q_es_aligned[i].T, np.zeros((3, 1))],
            [np.zeros((1, 3)), np.ones((1, 1))],
        ])))
        for i in range(len(p_gt))
    ])
    return e_trans, e_trans_vec, e_rot


def compute_relative_errors_binned(gt_c2ws, est_c2ws, subtraj_lengths,
                                   max_dist_diff=0.5):
    """Distance-binned relative pose errors: for each sub-trajectory length,
    the error of the relative transform from each frame to the frame that
    far along."""
    distances = get_distance_from_start(gt_c2ws[:, :3, 3])
    results = {}
    for length in subtraj_lengths:
        comparisons = compute_comparison_indices_length(
            distances, length, max_dist_diff)
        t_errs, r_errs = [], []
        for i, j in enumerate(comparisons):
            if j < 0 or j <= i:
                continue
            gt_rel = np.linalg.inv(gt_c2ws[i]) @ gt_c2ws[j]
            est_rel = np.linalg.inv(est_c2ws[i]) @ est_c2ws[j]
            err = np.linalg.inv(gt_rel) @ est_rel
            t_errs.append(float(np.linalg.norm(err[:3, 3])))
            r_errs.append(float(np.degrees(rotation_error(err))))
        results[length] = {
            "rel_trans": compute_statistics(t_errs),
            "rel_rot_deg": compute_statistics(r_errs),
            "num_pairs": len(t_errs),
        }
    return results


def compute_statistics(data):
    if len(data) == 0:
        return {"rmse": 0.0, "mean": 0.0, "median": 0.0, "std": 0.0,
                "min": 0.0, "max": 0.0, "num_samples": 0}
    a = np.asarray(data, np.float64)
    return {
        "rmse": float(np.sqrt(np.mean(a**2))),
        "mean": float(np.mean(a)),
        "median": float(np.median(a)),
        "std": float(np.std(a)),
        "min": float(np.min(a)),
        "max": float(np.max(a)),
        "num_samples": int(a.size),
    }


def write_stats(path, stats: dict):
    """Write the statistics dict as JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(stats, f, indent=2)
    return path
