"""Checkpoint IO (port of ``nope_nerf_tpu/training/checkpoints.py``): the
same ``.npz`` format, so a checkpoint moves between the two packages in
both directions.

One file per stream (model / model_pose / model_focal / model_distortion):
'/'-joined paths of a nested dict of arrays, a JSON ``__scalars__`` entry
(epoch_it, it, the plateau state) and, in the main stream, the optimizer
leaves ``__leaf_<i>`` in the JAX package's ``jax.tree.leaves`` order of its
optax state (:func:`..convert.adam_state_to_jax_leaves` maps the port's
Adam to it). Saves are atomic (tmp + rename). numpy only: callers convert
tensors with :func:`..convert.params_to_numpy`.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return _listify(tree)


def _listify(node):
    """Dicts whose keys are exactly 0..n-1 were lists before flattening."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(out, key=int)
        if [int(k) for k in idx] == list(range(len(idx))):
            return [out[k] for k in idx]
    return out


def save_pytree(path, tree, opt_leaves=None, **scalars):
    """Save a nested dict of arrays, the optimizer leaves (a list of
    arrays, or None) and scalar kwargs to ``path``, atomically."""
    flat = _flatten(tree)
    if opt_leaves is not None:
        flat.update({f"__leaf_{i}": np.asarray(x)
                     for i, x in enumerate(opt_leaves)})
    flat["__scalars__"] = np.frombuffer(json.dumps(scalars).encode(),
                                        dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_pytree(path):
    """-> (tree dict of numpy arrays, scalars dict, optimizer leaves (a list
    in saved order, empty when the file has none))."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    scalars, flat, leaves = {}, {}, {}
    with np.load(path) as data:
        for k in data.files:
            if k == "__scalars__":
                scalars = json.loads(bytes(data[k]).decode())
            elif k.startswith("__leaf_"):
                leaves[int(k[len("__leaf_"):])] = data[k]
            else:
                flat[k] = data[k]
    return _unflatten(flat), scalars, [leaves[i] for i in sorted(leaves)]


class CheckpointIO:
    """The four streams of one run directory."""

    def __init__(self, checkpoint_dir):
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    def save(self, filename, tree, opt_leaves=None, **scalars):
        save_pytree(os.path.join(self.checkpoint_dir, filename), tree,
                    opt_leaves=opt_leaves, **scalars)

    def load(self, filename):
        """:func:`load_pytree` of a file in the run directory;
        FileNotFoundError lets callers start fresh. There is no download:
        a URL raises ValueError."""
        if filename.startswith(("http://", "https://")):
            raise ValueError(f"{filename}: checkpoints are read from the run "
                             "directory only; download it there first")
        return load_pytree(os.path.join(self.checkpoint_dir, filename))

    def backup_model_best(self, filename="model_best.npz"):
        """Copy ``filename`` into ``backup_model_best/<n>_<filename>``."""
        src = os.path.join(self.checkpoint_dir, filename)
        if os.path.exists(src):
            backup_dir = os.path.join(self.checkpoint_dir, "backup_model_best")
            os.makedirs(backup_dir, exist_ok=True)
            ts = len(os.listdir(backup_dir))
            shutil.copy(src, os.path.join(backup_dir, f"{ts}_{filename}"))
