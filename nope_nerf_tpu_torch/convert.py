"""Parameters between the JAX package and the port.

Both packages hold the four groups as nested dicts with the same keys and
layouts -- nerf ``{layer: {"w": (fan_in, fan_out), "b": (fan_out,)}}`` for
the 12 layers of ``W_NAMES``, pose ``{"r", "t"}`` (N, 3), focal ``{"fx"[,
"fy"]}`` scalars, distortion ``{"scales", "shifts"}`` (N, 1) -- so the
conversion is a leaf-wise copy between numpy arrays and f32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.kernels.mlp_kernel import W_NAMES

GROUP_KEYS = {
    "nerf": set(W_NAMES),
    "pose": {"r", "t"},
    "focal": {"fx", "fy"},
    "distortion": {"scales", "shifts"},
}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree, device=None):
    """Tree of numpy arrays (e.g. ``jax.device_get`` of the JAX params)
    -> the port's parameter dict of f32 tensors on ``device``."""
    for g, sub in tree.items():
        if g not in GROUP_KEYS or not set(sub) <= GROUP_KEYS[g]:
            raise ValueError(f"unknown parameter group or key: {g} "
                             f"{sorted(sub)}")
    return _map(tree, lambda a: torch.tensor(np.asarray(a, np.float32),
                                             device=device))


def params_to_numpy(params):
    """The port's parameter dict -> the same tree of numpy f32 arrays."""
    return _map(params, lambda t: t.detach().cpu().numpy().astype(np.float32))
