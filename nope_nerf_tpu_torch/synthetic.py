"""An in-memory scene of random frames and depth priors, made from a seed:
the layout ``bench.py`` times (8 frames of 540x960), for smoke runs and
profiles that need no dataset on disk."""
from __future__ import annotations

import numpy as np


class MemoryScene:
    """What ``training.loop.train`` reads from a scene: N_imgs, H, W, K,
    scale_mat, c2ws, imgs (N, H, W, 3), dpt_depth (N, H, W) and
    ``sample_ref_idx``."""

    def __init__(self, n_frames=8, h=540, w=960, seed=0):
        rng = np.random.default_rng(seed)
        self.N_imgs, self.H, self.W = n_frames, h, w
        self.K = np.array([[2 * 0.8, 0, 0, 0], [0, -2 * 0.9, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)
        self.scale_mat = np.eye(4, dtype=np.float32)
        self.c2ws = None
        self.imgs = rng.uniform(size=(n_frames, h, w, 3)).astype(np.float32)
        self.dpt_depth = (1.0 + rng.uniform(size=(n_frames, h, w))).astype(
            np.float32)

    def sample_ref_idx(self, idx, rng=None):
        """random_ref 1: the next frame; the last frame pairs backwards."""
        return idx - 1 if idx == self.N_imgs - 1 else idx + 1
