"""Learnable per-frame SE(3) camera poses (port of
``nope_nerf_tpu/models/pose.py``): a table {'r': (N, 3), 't': (N, 3)} of
axis-angle + translation, composed on an optional ``init_c2w``."""
from __future__ import annotations

import torch

from ..geometry.so3 import make_c2w


def init_pose_params(num_cams: int, device=None) -> dict:
    """Zero-init axis-angle + translation."""
    return {
        "r": torch.zeros((num_cams, 3), dtype=torch.float32, device=device),
        "t": torch.zeros((num_cams, 3), dtype=torch.float32, device=device),
    }


def _maybe_stop(x, learn: bool):
    return x if learn else x.detach()


def take_rows(table, idx):
    """``table[idx]`` for a host int or an int tensor of any shape on the
    table's device (a 0-d one gives one row): a gather that reads no index
    on the host, so a captured step can select its frame on the device."""
    if not torch.is_tensor(idx):
        return table[idx]
    rows = torch.index_select(table, 0, idx.reshape(-1))
    return rows.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def pose_c2w(params, idx, init_c2w=None, learn_R=True, learn_t=True):
    """c2w (4, 4) for camera ``idx`` (an int or a 0-d int tensor, or (B,)
    -> (B, 4, 4)): ``make_c2w(r, t) @ init_c2w[idx]`` in delta-pose mode;
    ``learn_R`` / ``learn_t`` False stop the gradient."""
    r = take_rows(_maybe_stop(params["r"], learn_R), idx)
    t = take_rows(_maybe_stop(params["t"], learn_t), idx)
    c2w = make_c2w(r, t)
    if init_c2w is not None:
        c2w = c2w @ take_rows(init_c2w, idx)
    return c2w


def all_poses(params, init_c2w=None, learn_R=True, learn_t=True):
    """All N c2w matrices (N, 4, 4) in one batched op."""
    c2w = make_c2w(_maybe_stop(params["r"], learn_R),
                   _maybe_stop(params["t"], learn_t))
    if init_c2w is not None:
        c2w = c2w @ init_c2w
    return c2w
