"""Estimated-trajectory visualisation CLI of the port, mirroring the
repository's ``vis/vis_poses.py``:

    python -m nope_nerf_tpu_torch.vis_poses configs/Tanks/Ignatius.yaml

Loads the learned poses from ``training.out_dir`` and writes their camera
frustums as a PLY line set to ``<out_dir>/est_poses.ply``, the frustum size
scaled to the trajectory's extent. A few 4x4 matrices on the host: no
device is used.
"""
import argparse
import os

import numpy as np
import torch

from .config import DEFAULT_CONFIG, load_config
from .convert import load_group
from .dataloading.scene import get_scene
from .models.pose import all_poses
from .training.checkpoints import CheckpointIO
from .utils.vis import export_camera_frustums


def main(cfg):
    """Write ``est_poses.ply``; returns its path."""
    out_dir = cfg["training"]["out_dir"]
    scene = get_scene(cfg, mode="train")
    pose_params = load_group(CheckpointIO(out_dir),
                             cfg["extract_images"]["model_file_pose"], "pose")
    init_c2w = (torch.as_tensor(scene.c2ws, dtype=torch.float32)
                if (cfg["pose"]["init_pose"] and scene.c2ws is not None)
                else None)
    learned = all_poses(pose_params, init_c2w).numpy()
    pts = learned[:, :3, 3]
    extent = float(np.linalg.norm(pts[None] - pts[:, None], axis=-1).max())
    ply = os.path.join(out_dir, "est_poses.ply")
    export_camera_frustums(ply, [learned], colors=[(41, 98, 255)],
                           fov_deg=50.0,
                           frustum_size=max(extent * 0.05, 1e-3))
    print(f"estimated trajectory written to {ply}")
    return ply


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Visualise estimated poses (nope-nerf on PyTorch + CUDA).")
    parser.add_argument("config", type=str, help="Path to config file.")
    args = parser.parse_args()
    main(load_config(args.config, DEFAULT_CONFIG))
