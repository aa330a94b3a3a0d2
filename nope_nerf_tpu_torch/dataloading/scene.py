"""Scene container of the port: every frame and the camera metadata of one
scene as host numpy arrays.

The port's copy of ``nope_nerf_tpu/dataloading/scene.py`` (``SceneData``,
``get_scene``: same fields, same values), kept here so that the port imports
nothing of the JAX package. It applies the reference's DataField
preprocessing:

* LLFF pose column permutation, bd rescale (0.75 factor), recentering,
  optional spherification,
* K = [[2fx/w,0,0,0],[0,-2fy/h,0,0],[0,0,-1,0],[0,0,0,1]],
* test split: every ``sample_rate``-th frame offset by sample_rate//2,
* DPT depth loading from ``<scene>/dpt/depth_*.npz``,
* reference-frame sampling for the pair losses.
"""
from __future__ import annotations

import os
import random as _pyrandom

import numpy as np

from .llff import (
    load_depths_npz,
    load_gt_depths,
    load_llff_data,
    recenter_poses,
    spherify_poses,
)


class SceneData:
    """All frames + camera metadata for one scene, host-side numpy."""

    def __init__(
        self,
        path,
        scene_name,
        mode="train",
        spherify=False,
        customized_poses=False,
        customized_focal=False,
        resize_factor=2,
        depth_net="dpt",
        crop_size=0,
        random_ref=1,
        norm_depth=False,
        load_colmap_poses=True,
        sample_rate=8,
        with_depth=False,
        use_DPT=False,
        **_,
    ):
        self.mode = mode
        self.random_ref = random_ref
        self.sample_rate = sample_rate
        load_dir = os.path.join(
            path, scene_name[0] if isinstance(scene_name, (list, tuple))
            else scene_name)
        if crop_size != 0:
            depth_net = depth_net + "_" + str(crop_size)

        raw = load_llff_data(load_dir, factor=resize_factor,
                             crop_size=crop_size,
                             load_colmap_poses=load_colmap_poses)
        poses, bds = raw["poses"], raw["bds"]
        imgs, img_names = raw["imgs"], raw["img_names"]
        focal_crop_factor = raw["focal_crop_factor"]

        c2ws_colmap = None
        focal = None
        self.hwf = None
        self.bds = bds
        if load_colmap_poses:
            # LLFF [down right back] -> [right up back] column shuffle
            poses = np.concatenate(
                [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
            poses = np.moveaxis(poses, -1, 0).astype(np.float32)
            bds = np.moveaxis(bds, -1, 0).astype(np.float32)
            bd_factor = 0.75
            sc = 1.0 / (bds.min() * bd_factor)
            poses[:, :3, 3] *= sc
            bds *= sc
            self.bds = bds
            poses = recenter_poses(poses)
            if spherify:
                poses, _, bds = spherify_poses(poses, bds)
                self.bds = bds
            input_poses = poses.astype(np.float32)
            hwf = input_poses[0, :3, -1]
            self.hwf = input_poses[:, :3, :]
            input_poses = input_poses[:, :3, :4]
            focal = hwf[2]
            bottom = np.tile(np.array([[0, 0, 0, 1]], np.float32),
                             (input_poses.shape[0], 1, 1))
            c2ws_colmap = np.concatenate([input_poses, bottom], 1)

        N, h, w, _ = imgs.shape

        if customized_focal:
            focal_gt = np.load(os.path.join(load_dir, "intrinsics.npz"))[
                "K"].astype(np.float32)
            rf = 1 if resize_factor is None else resize_factor
            fx = focal_gt[0, 0] / rf
            fy = focal_gt[1, 1] / rf
        elif load_colmap_poses:
            fx, fy = focal, focal
        else:
            fx, fy = w, h
        fx = fx / focal_crop_factor
        fy = fy / focal_crop_factor

        self.H, self.W, self.focal = h, w, fx
        self.K = np.array(
            [
                [2 * fx / w, 0, 0, 0],
                [0, -2 * fy / h, 0, 0],
                [0, 0, -1, 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )

        ids = np.arange(N)
        i_test = ids[int(sample_rate / 2):: sample_rate]
        i_train = np.array([i for i in ids if i not in i_test])
        self.i_train, self.i_test = i_train, i_test

        image_list_train = [img_names[i] for i in i_train]
        image_list_test = [img_names[i] for i in i_test]

        if customized_poses:
            c2ws_gt = np.load(os.path.join(load_dir, "gt_poses.npz"))[
                "poses"].astype(np.float32)
            T = np.array(
                [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
                np.float32,
            )
            c2ws = c2ws_gt @ T
        else:
            c2ws = c2ws_colmap if load_colmap_poses else None

        self.N_imgs_train = len(i_train)
        self.N_imgs_test = len(i_test)

        if mode in ("train", "eval_trained", "render"):
            idx_list = i_train
            self.img_list = image_list_train
        elif mode == "eval":
            idx_list = i_test
            self.img_list = image_list_test
        else:  # 'all'
            idx_list = ids
            self.img_list = list(img_names)

        self.imgs = imgs[idx_list]  # (N_mode, H, W, 3)
        self.N_imgs = len(idx_list)
        self.c2ws = c2ws[idx_list] if c2ws is not None else None
        self.c2ws_colmap = (c2ws_colmap[i_train] if load_colmap_poses
                            else None)
        self.scale_mat = np.eye(4, dtype=np.float32)

        self.dpt_depth = None
        if not use_DPT:
            pred_depth_path = os.path.join(load_dir, depth_net)
            if os.path.isdir(pred_depth_path):
                self.dpt_depth = load_depths_npz(
                    image_list_train, pred_depth_path, norm=norm_depth)
        self.depth = None
        if with_depth:
            self.depth = load_gt_depths(image_list_train, load_dir,
                                        crop_ratio=raw["crop_ratio"])

    def sample_ref_idx(self, idx, rng: _pyrandom.Random | None = None):
        """Reference-frame index for the pair losses: uniform among the
        next ``random_ref`` frames; the last frame pairs backwards."""
        rnd = rng or _pyrandom
        if idx == self.N_imgs - 1:
            return idx - 1
        ran = rnd.randint(1, min(self.random_ref, self.N_imgs - idx - 1))
        return idx + ran


def get_scene(cfg, mode="train") -> SceneData:
    """The scene of ``cfg["dataloading"]`` in ``mode`` (train / eval /
    eval_trained / render / all)."""
    dcfg = cfg["dataloading"]
    return SceneData(
        path=dcfg["path"],
        scene_name=dcfg["scene"],
        mode=mode,
        spherify=dcfg["spherify"],
        customized_poses=dcfg["customized_poses"],
        customized_focal=dcfg["customized_focal"],
        resize_factor=dcfg["resize_factor"],
        depth_net=dcfg["depth_net"],
        crop_size=dcfg["crop_size"],
        random_ref=dcfg["random_ref"],
        norm_depth=dcfg["norm_depth"],
        load_colmap_poses=dcfg["load_colmap_poses"],
        sample_rate=dcfg["sample_rate"],
        with_depth=dcfg["with_depth"],
        use_DPT=cfg["depth"]["type"] == "DPT",
    )
