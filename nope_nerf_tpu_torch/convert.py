"""Parameters and Adam moments between the JAX package and the port.

Both packages hold the four groups as nested dicts with the same keys and
layouts -- nerf ``{layer: {"w": (fan_in, fan_out), "b": (fan_out,)}}`` for
the 12 layers of ``W_NAMES``, pose ``{"r", "t"}`` (N, 3), focal ``{"fx"[,
"fy"]}`` scalars, distortion ``{"scales", "shifts"}`` (N, 1) -- so the
conversion is a leaf-wise copy between numpy arrays and f32 tensors. The
Adam moments map between the port's ``torch.optim.Adam`` and the leaves of
the JAX ``optax`` state (:func:`adam_state_to_jax_leaves`,
:func:`adam_state_from_jax_leaves`).

The frozen networks of preprocessing and evaluation (DPT, LPIPS) keep the
JAX package's tree, which is also their npz format, with PyTorch's
layouts: :func:`dpt_params_from_jax` and :func:`lpips_params_from_jax`
turn HWIO conv weights into OIHW and (in, out) linear weights into
(out, in).
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
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def tree_to(tree, to):
    """Every tensor of a nested dict / list through ``t.to(to)``: a device
    or a dtype."""
    return _map(tree, lambda t: t.to(to))


def _torch_layout(a, device):
    """A JAX weight as the port keeps it: 4-D HWIO -> OIHW, 2-D (in, out)
    -> (out, in); other leaves as they are. f32 tensor on ``device``."""
    a = np.asarray(a, np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:
        a = a.T
    return torch.tensor(np.ascontiguousarray(a), device=device)


def dpt_params_from_jax(tree, device=None):
    """The JAX DPT parameter tree (numpy leaves, as ``convert_dpt`` writes
    it) -> the port's (:mod:`.models.dpt`). Its only 2-D leaves are
    linear weights and its only 4-D leaves conv weights."""
    return _map(tree, lambda a: _torch_layout(a, device))


def _as_list(node, n):
    """The npz round trip restores digit-keyed dicts as lists; accept
    either."""
    return node if isinstance(node, list) else [node[str(i)] for i in range(n)]


def lpips_params_from_jax(tree, device=None):
    """The JAX LPIPS tree ``{"convs": 13 x {w, b}, "lins": 5 x {w}}``, lists
    or digit-keyed dicts -> the port's (:mod:`.models.lpips`): OIHW convs,
    heads (1, C)."""
    tree = {"convs": _as_list(tree["convs"], 13),
            "lins": _as_list(tree["lins"], 5)}
    return _map(tree, lambda a: _torch_layout(a, device))


def params_from_jax(tree, device=None):
    """Tree of numpy arrays (e.g. ``jax.device_get`` of the JAX params)
    -> the port's parameter dict of f32 tensors on ``device``."""
    for g, sub in tree.items():
        if g not in GROUP_KEYS or not set(sub) <= GROUP_KEYS[g]:
            raise ValueError(f"unknown parameter group or key: {g} "
                             f"{sorted(sub)}")
    return _map(tree, lambda a: torch.tensor(np.asarray(a, np.float32),
                                             device=device))


def load_group(checkpoint_io, filename, group, device=None):
    """One parameter group from a checkpoint stream of a run directory
    (``training.checkpoints.CheckpointIO``), as the port's tensors on
    ``device``."""
    tree, _, _ = checkpoint_io.load(filename)
    return params_from_jax({group: tree["params"]}, device)[group]


def params_to_numpy(params):
    """The port's parameter dict -> the same tree of numpy f32 arrays."""
    return _map(params, lambda t: t.detach().cpu().numpy().astype(np.float32))


# The JAX trainer's optimizer is ``optax.multi_transform`` of one
# ``scale_by_adam`` per group; ``jax.tree.leaves`` of its state lists, per
# group in sorted name order (distortion, focal, nerf, pose): the step
# ``count`` (int32), then ``mu`` and then ``nu``, each over the group's
# parameters in sorted key order. The port's Adam keeps one param group per
# name with the same sorted order (``training.trainer.group_tensors``), and
# per parameter ``step``, ``exp_avg`` (mu) and ``exp_avg_sq`` (nu).


def _groups_in_jax_order(optimizer):
    return sorted(optimizer.param_groups, key=lambda g: g["name"])


def adam_state_to_jax_leaves(optimizer):
    """The port's Adam state -> the JAX optax state's leaves (numpy), in
    ``jax.tree.leaves`` order. A parameter not stepped yet has zero
    moments and count 0, as ``optax`` initialises them."""
    leaves = []
    for group in _groups_in_jax_order(optimizer):
        states = [optimizer.state.get(p, {}) for p in group["params"]]
        step = states[0].get("step", 0) if states else 0
        leaves.append(np.asarray(int(step), np.int32))
        for key in ("exp_avg", "exp_avg_sq"):
            for p, st in zip(group["params"], states):
                m = st.get(key)
                leaves.append(np.zeros(tuple(p.shape), np.float32) if m is None
                              else m.detach().cpu().numpy().astype(np.float32))
    return leaves


def adam_state_from_jax_leaves(optimizer, leaves):
    """Load the JAX optax state's leaves into the port's Adam, in place.
    Raises ValueError, and changes nothing, when their number or shapes do
    not fit the optimizer's parameters (the JAX ``restore_leaves`` check)."""
    plan, i = [], 0
    for group in _groups_in_jax_order(optimizer):
        ps = group["params"]
        if i + 1 + 2 * len(ps) > len(leaves):
            raise ValueError(f"optimizer-state mismatch: {len(leaves)} leaves "
                             "are too few for the optimizer's parameters")
        count = leaves[i]
        mus = leaves[i + 1:i + 1 + len(ps)]
        nus = leaves[i + 1 + len(ps):i + 1 + 2 * len(ps)]
        i += 1 + 2 * len(ps)
        if np.shape(count) != ():
            raise ValueError(f"optimizer-state mismatch: count of shape "
                             f"{np.shape(count)}")
        for p, mu, nu in zip(ps, mus, nus):
            for a in (mu, nu):
                if np.shape(a) != tuple(p.shape):
                    raise ValueError(f"optimizer-state shape mismatch "
                                     f"{np.shape(a)} vs {tuple(p.shape)}")
            plan.append((p, int(count), mu, nu))
    if i != len(leaves):
        raise ValueError(f"optimizer-state mismatch: {len(leaves)} leaves for "
                         f"{i} expected")
    for p, count, mu, nu in plan:
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu, np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu, np.float32),
                                       device=p.device),
        }
