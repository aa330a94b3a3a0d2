"""Pose-accuracy evaluation CLI of the port, mirroring the repository's
``evaluation/eval_poses.py``:

    python -m nope_nerf_tpu_torch.eval_poses configs/Tanks/Ignatius.yaml [--vis]

Loads the learned poses from ``training.out_dir``, Sim(3)-aligns them to
the scene's COLMAP / gt trajectory and prints ``RPE_t x100 & RPE_r (deg) &
ATE``; ``--vis`` writes both trajectories' camera frustums to
``<out_dir>/pose_vis.ply``. A few 4x4 matrices on the host: no device is
used. The scene is read with the port's numpy loader
(``dataloading.scene``) and the PLY written by its exporter
(``utils.vis``).
"""
import argparse
import os

import numpy as np
import torch

from .config import DEFAULT_CONFIG, apply_parity_profile, load_config
from .convert import load_group
from .dataloading.scene import get_scene
from .geometry.align import align_ate_c2b_use_a2b, compute_ate, compute_rpe
from .models.pose import all_poses
from .training.checkpoints import CheckpointIO
from .utils.vis import export_camera_frustums


def main(cfg, vis=False):
    """Print and return the pose errors of the run in ``training.out_dir``
    against its scene's training views; None when the scene has no
    reference poses."""
    apply_parity_profile(cfg)
    out_dir = cfg["training"]["out_dir"]
    scene = get_scene(cfg, mode="train")

    pose_params = load_group(CheckpointIO(out_dir),
                             cfg["extract_images"]["model_file_pose"], "pose")
    init_c2w = (torch.as_tensor(scene.c2ws, dtype=torch.float32)
                if (cfg["pose"]["init_pose"] and scene.c2ws is not None)
                else None)
    learned = all_poses(pose_params, init_c2w).numpy()
    gt = scene.c2ws
    if gt is None:
        print("No gt/COLMAP poses available for this scene")
        return None

    aligned = align_ate_c2b_use_a2b(learned, gt)
    ate = compute_ate(gt, aligned)
    rpe_t, rpe_r = compute_rpe(gt, aligned)
    print("{0:.3f} & {1:.3f} & {2:.3f}".format(rpe_t * 100,
                                               np.rad2deg(rpe_r), ate))
    if vis:
        ply = os.path.join(out_dir, "pose_vis.ply")
        export_camera_frustums(ply, [aligned, gt],
                               colors=[(0, 0, 255), (255, 0, 0)],
                               fov_deg=50.0, frustum_size=0.1)
        print(f"frustum line set written to {ply}")
    return {"rpe_trans": rpe_t * 100, "rpe_rot_deg": float(np.rad2deg(rpe_r)),
            "ate": ate}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Evaluate poses (nope-nerf on PyTorch + CUDA).")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--vis", action="store_true",
                        help="export frustum PLY")
    args = parser.parse_args()
    main(load_config(args.config, DEFAULT_CONFIG), vis=args.vis)
