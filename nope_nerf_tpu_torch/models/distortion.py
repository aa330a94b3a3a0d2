"""Learnable per-frame depth distortion, scale & shift (port of
``nope_nerf_tpu/models/distortion.py``): depth priors are rectified as
d * scale + shift, with a scale floor of 0.01 and, with ``fix_scaleN``, the
last frame's scale pinned to 1."""
from __future__ import annotations

import torch


def init_distortion_params(num_cams: int, device=None) -> dict:
    """scales init 1, shifts init 0."""
    return {
        "scales": torch.ones((num_cams, 1), dtype=torch.float32, device=device),
        "shifts": torch.zeros((num_cams, 1), dtype=torch.float32, device=device),
    }


def distortion_scale_shift(params, idx: int, num_cams: int,
                           fix_scaleN: bool = True, learn_scale: bool = True,
                           learn_shift: bool = True):
    """-> (scale (1,), shift (1,)) for camera ``idx`` (a host int). The
    floor has zero gradient where it clamps; a pinned scale is the
    constant 1."""
    scales = params["scales"] if learn_scale else params["scales"].detach()
    shifts = params["shifts"] if learn_shift else params["shifts"].detach()
    scale = torch.clamp_min(scales[idx], 0.01)
    if fix_scaleN and idx == num_cams - 1:
        scale = torch.ones_like(scale)
    return scale, shifts[idx]
