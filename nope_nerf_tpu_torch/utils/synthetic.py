"""Synthetic teacher scenes (port of ``nope_nerf_tpu/utils/synthetic.py``).

A tiny scene rendered *from a teacher NeRF* (a random field from a seed) at
known poses, so that training on it is exactly realisable: the convergence
tests and the card's synthetic phase fit it from scratch and assert PSNR
gains without any dataset on disk. ``SyntheticScene`` has the attribute
surface of ``dataloading.scene.SceneData`` that the training loop reads;
``make_synthetic_dataset`` writes it in the LLFF layout.
"""
from __future__ import annotations

import random as pyrandom

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, load_config, update_recursive
from ..convert import params_from_jax
from ..device import resolve_device
from ..models.nerf import init_nerf_params
from ..ops.rendering import render_image


def lookat_c2w(eye, target, up=(0.0, 1.0, 0.0)):
    """c2w for a camera at ``eye`` looking at ``target``.

    Convention: camera looks down -z (K = diag(fx, -fy, -1, 1) backprojects
    pixel depth d to z_cam = -d).
    """
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    z = -fwd
    up = np.asarray(up, np.float64)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


TEACHER_CFG = {
    "model": {"hidden_dim": 64, "pos_enc_levels": 4, "dir_enc_levels": 2,
              "occ_activation": "softplus"},
    "rendering": {"white_background": False},
}


class SyntheticScene:
    """Duck-typed SceneData of an in-memory synthetic scene.

    The teacher is the port's ``init_nerf_params`` (width 64, 4 / 2
    encoding levels) from a ``torch.Generator`` seeded ``seed + 100``, with
    its first layer's weights scaled by 4 for structure; ``teacher`` (a
    numpy tree of the nerf group, e.g. the JAX package's teacher) replaces
    it. Its render config has no ``use_pallas_mlp`` and no ``mlp_bf16``,
    so the frames come from the plain f32 field on ``device``. Arrays are
    host numpy, as in the JAX package.
    """

    def __init__(self, n_frames=6, hw=(32, 40), seed=0, radius=2.5,
                 depth_range=(0.5, 6.0), random_ref=1, num_points=32,
                 teacher=None, device="cuda"):
        dev = resolve_device(device)
        H, W = hw
        self.H, self.W = H, W
        fx = fy = 0.8 * W
        self.K = np.array(
            [
                [2 * fx / W, 0, 0, 0],
                [0, -2 * fy / H, 0, 0],
                [0, 0, -1, 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        self.scale_mat = np.eye(4, dtype=np.float32)
        self.random_ref = random_ref
        self.N_imgs = n_frames

        # poses on an arc around the origin
        c2ws = []
        for i in range(n_frames):
            th = 0.25 * np.pi * (i / max(n_frames - 1, 1) - 0.5)
            eye = radius * np.array([np.sin(th), 0.1, np.cos(th)])
            c2ws.append(lookat_c2w(eye, [0.0, 0.0, 0.0]))
        self.c2ws = np.stack(c2ws)

        if teacher is None:
            gen = torch.Generator().manual_seed(seed + 100)
            teacher = init_nerf_params(gen, TEACHER_CFG, dev)
            # give the teacher some structure: scale up first-layer weights
            teacher["trunk0_0"]["w"] = teacher["trunk0_0"]["w"] * 4.0
        else:
            teacher = params_from_jax({"nerf": teacher}, dev)["nerf"]
        model = TEACHER_CFG["model"]
        render_cfg = {
            "num_points": num_points,
            "depth_range": list(depth_range),
            "sample_option": "uniform",
            "dist_alpha": False,
            "use_ray_dir": True,
            "normalise_ray": True,
            "white_background": TEACHER_CFG["rendering"]["white_background"],
            "normal_loss": False,
            "outside_steps": 0,
            "occ_activation": model["occ_activation"],
            "pos_enc_levels": model["pos_enc_levels"],
            "dir_enc_levels": model["dir_enc_levels"],
        }
        self.teacher = teacher
        self.teacher_render_cfg = render_cfg

        imgs, depths = [], []
        K = torch.as_tensor(self.K, device=dev)
        eye4 = torch.eye(4, device=dev)
        for c2w in self.c2ws:
            world_mat = torch.as_tensor(np.linalg.inv(c2w), device=dev)
            rgb, depth = render_image(teacher, (H, W), K, world_mat, eye4,
                                      render_cfg, chunk=H * W)
            imgs.append(rgb.cpu().numpy())
            depths.append(depth.cpu().numpy())
        self.imgs = np.stack(imgs).astype(np.float32)
        self.dpt_depth = np.stack(depths).astype(np.float32)
        self.i_train = np.arange(n_frames)
        self.i_test = np.array([], dtype=int)
        self.N_imgs_train = n_frames
        self.N_imgs_test = 0
        self.img_list = [f"{i:03d}.png" for i in range(n_frames)]
        self.depth = None
        self.bds = np.array([[depth_range[0], depth_range[1]]] * n_frames).T
        self.hwf = None
        self.c2ws_colmap = self.c2ws.copy()
        self.focal = fx

    def sample_ref_idx(self, idx, rng: pyrandom.Random | None = None):
        rnd = rng or pyrandom
        if idx == self.N_imgs - 1:
            return idx - 1
        ran = rnd.randint(1, min(self.random_ref, self.N_imgs - idx - 1))
        return idx + ran


def tiny_config(scene, out_dir, n_training_points=128, num_points=32,
                depth_range=(0.5, 6.0)):
    """A minimal full config dict for the synthetic scene (the JAX
    package's ``tiny_config``, over the port's ``load_config``)."""
    cfg = load_config(DEFAULT_CONFIG, default_path=None)
    update_recursive(
        cfg,
        {
            "model": {"hidden_dim": 64, "pos_enc_levels": 4,
                      "dir_enc_levels": 2},
            "rendering": {
                "num_points": num_points,
                "depth_range": list(depth_range),
            },
            "training": {
                "out_dir": out_dir,
                "n_training_points": n_training_points,
                "print_every": 0,
                "checkpoint_every": 0,
                "backup_every": 0,
                "visualize_every": 0,
                "eval_pose_every": 1,
                "eval_img_every": 1,
                "scheduling_start": 10000,
                "auto_scheduler": False,
                "pc_ratio": 4,
            },
            "tpu": {"chamfer_block": 256, "epoch_scan": True},
        },
    )
    return cfg
