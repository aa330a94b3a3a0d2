"""An in-memory scene of random frames and depth priors on a smooth camera
trajectory, made from a seed: the layout ``bench.py`` times (8 training
frames of 540x960), for smoke runs and profiles that need no dataset on
disk."""
from __future__ import annotations

import numpy as np


class MemoryScene:
    """What ``training.loop.train`` and the eval CLIs read from a scene:
    N_imgs, H, W, K, scale_mat, c2ws (N, 4, 4), sample_rate, imgs
    (N, H, W, 3), dpt_depth (N, H, W) and ``sample_ref_idx``.

    The sequence is split as the dataset loader splits it at the stock
    ``dataloading.sample_rate`` 8: every 8th frame from frame 4 on is held
    out. ``mode`` "train" gives ``n_frames`` training views, "eval" the
    held-out views of the same sequence (one for 8 training frames).
    """

    sample_rate = 8

    def __init__(self, n_frames=8, h=540, w=960, seed=0, mode="train"):
        sample_rate = self.sample_rate
        rng = np.random.default_rng(seed)
        n_total = n_frames
        while n_total - len(range(sample_rate // 2, n_total,
                                  sample_rate)) < n_frames:
            n_total += 1
        ids = np.arange(n_total)
        i_test = ids[sample_rate // 2::sample_rate]
        keep = i_test if mode == "eval" else np.setdiff1d(ids, i_test)
        self.N_imgs, self.H, self.W = len(keep), h, w
        self.K = np.array([[2 * 0.8, 0, 0, 0], [0, -2 * 0.9, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)
        self.scale_mat = np.eye(4, dtype=np.float32)
        # a camera panning along a gentle arc, with a seeded phase
        t = np.linspace(0.0, 1.0, n_total)
        yaw = 0.3 * t + rng.uniform(-0.1, 0.1)
        c2ws = np.tile(np.eye(4), (n_total, 1, 1))
        c2ws[:, 0, 0] = c2ws[:, 2, 2] = np.cos(yaw)
        c2ws[:, 0, 2] = np.sin(yaw)
        c2ws[:, 2, 0] = -np.sin(yaw)
        c2ws[:, :3, 3] = np.stack([0.5 * t, 0.05 * np.sin(np.pi * t),
                                   0.2 * t * t], axis=1)
        self.c2ws = c2ws[keep].astype(np.float32)
        imgs = rng.uniform(size=(n_total, h, w, 3)).astype(np.float32)
        dpts = (1.0 + rng.uniform(size=(n_total, h, w))).astype(np.float32)
        self.imgs, self.dpt_depth = imgs[keep], dpts[keep]

    def sample_ref_idx(self, idx, rng=None):
        """random_ref 1: the next frame; the last frame pairs backwards."""
        return idx - 1 if idx == self.N_imgs - 1 else idx + 1
