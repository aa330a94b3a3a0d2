"""Convert the reference nope-nerf PyTorch checkpoints into the four npz
streams (the port's twin of ``tools/convert_reference_ckpt.py``):

    python -m nope_nerf_tpu_torch.convert_reference <ckpt_dir_or_model.pt> <out_dir> [--step N] [--strict]

The reference saves four torch module checkpoints, each a pickled dict
``{'model': state_dict, 'optimizer': state_dict, **scalars}``:

* ``model.pt`` -- the NeRF MLP under ``renderer.model.*`` (torch Linear
  (out, in) weights) and the resume scalars;
* ``model_pose.pt`` -- ``r`` / ``t`` (N, 3) and the optional ``init_c2w``;
* ``model_focal.pt`` -- ``fx`` (and ``fy`` unless fx_only);
* ``model_distortion.pt`` -- ``global_scales`` / ``global_shifts`` (N, 1).

Each becomes the stream of the same name that ``training.loop.restore``,
``eval`` and ``eval_poses`` read, written with the port's
``training.checkpoints.save_pytree``: the same trees, leaves and scalars as
the JAX tool writes. Adam moments are not converted (a stream without them
starts fresh moments); resume scalars are carried. A directory is scanned
for the live ``<stream>.pt`` files, else the highest numbered backup
``<stream>_<it>.pt``, or with ``--step`` that backup.
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np

from .training.checkpoints import save_pytree

# reference module state_dict key -> the nerf layer name, the torch Linear
# (out, in) weight transposed to (in, out) "w"
NERF_LAYER_MAP = {
    "layers0.0": "trunk0_0",
    "layers0.2": "trunk0_1",
    "layers0.4": "trunk0_2",
    "layers0.6": "trunk0_3",
    "layers1.0": "trunk1_0",
    "layers1.2": "trunk1_1",
    "layers1.4": "trunk1_2",
    "layers1.6": "trunk1_3",
    "fc_density": "fc_density",
    "fc_feature": "fc_feature",
    "rgb_layers.0": "rgb_layer",
    "fc_rgb": "fc_rgb",
}

STREAMS = ("model", "model_pose", "model_focal", "model_distortion")


def _to_np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def _load_torch(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def _split(ckpt):
    """-> (module state_dict, resume scalars); the optimizer is dropped."""
    scalars = {k: v for k, v in ckpt.items()
               if k not in ("model", "optimizer") and np.isscalar(v)}
    return ckpt.get("model", {}), scalars


def _unrecognised(what, keys, strict):
    if not keys:
        return
    if strict:
        raise ValueError(f"--strict: unrecognised {what} keys in checkpoint: "
                         f"{keys[:8]}{'...' if len(keys) > 8 else ''}")
    print(f"  WARNING: unrecognised {what} keys ignored: {keys[:8]}")


def _strip_prefix(state, strict):
    """The NeRF MLP's keys without their prefix (``renderer.model.`` in the
    ``nope_nerf`` wrapper, none in a bare field); a frozen
    ``depth_estimator.*`` subtree is dropped (the priors are a preprocessing
    output here)."""
    anchor = "layers0.0.weight"
    prefix = next((k[:-len(anchor)] for k in state if k.endswith(anchor)),
                  None)
    if prefix is None:
        raise ValueError(
            "no NeRF MLP found in checkpoint (missing *layers0.0.weight)")
    out = {k[len(prefix):]: v for k, v in state.items()
           if k.startswith(prefix)}
    dropped = [k for k in state if not k.startswith(prefix)]
    dpt = [k for k in dropped if "depth_estimator" in k]
    if dpt:
        print(f"  dropped {len(dpt)} frozen depth_estimator.* entries "
              "(preprocessing net; convert with "
              "python -m nope_nerf_tpu_torch.convert_dpt)")
    _unrecognised("non-DPT", [k for k in dropped
                              if "depth_estimator" not in k], strict)
    return out


def convert_nerf(ckpt, strict=False):
    state, scalars = _split(ckpt)
    state = _strip_prefix(state, strict)
    params, used = {}, set()
    for ref_key, our_key in NERF_LAYER_MAP.items():
        w = state.get(f"{ref_key}.weight")
        b = state.get(f"{ref_key}.bias")
        if w is None or b is None:
            raise ValueError(f"checkpoint missing {ref_key}.weight/.bias")
        params[our_key] = {"w": _to_np(w).T.copy(), "b": _to_np(b)}
        used.update((f"{ref_key}.weight", f"{ref_key}.bias"))
    _unrecognised("NeRF", sorted(set(state) - used), strict)
    return {"params": params}, scalars


def convert_pose(ckpt, strict=False):
    state, scalars = _split(ckpt)
    tree = {"params": {"r": _to_np(state["r"]), "t": _to_np(state["t"])}}
    if "init_c2w" in state:
        # a frozen buffer of the reference; the pipeline rebuilds it from the
        # dataset's poses, but it keeps a converted stream self-describing
        tree["init_c2w"] = _to_np(state["init_c2w"])
    return tree, scalars


def _as_scalar(v, name):
    a = _to_np(v)
    if a.size != 1:
        raise ValueError(
            f"focal param {name!r} has {a.size} elements (shape {a.shape}); "
            "the reference's LearnFocal stores scalars: this is not a "
            "reference focal checkpoint")
    return a.reshape(())


def convert_focal(ckpt, strict=False):
    state, scalars = _split(ckpt)
    params = {"fx": _as_scalar(state["fx"], "fx")}
    if "fy" in state:
        params["fy"] = _as_scalar(state["fy"], "fy")
    return {"params": params}, scalars


def convert_distortion(ckpt, strict=False):
    state, scalars = _split(ckpt)
    return {"params": {"scales": _to_np(state["global_scales"]),
                       "shifts": _to_np(state["global_shifts"])}}, scalars


CONVERTERS = {
    "model": convert_nerf,
    "model_pose": convert_pose,
    "model_focal": convert_focal,
    "model_distortion": convert_distortion,
}


def stream_of(filename):
    """model_pose_50000.pt -> model_pose; model.pt -> model."""
    base = os.path.splitext(os.path.basename(filename))[0]
    for s in sorted(STREAMS, key=len, reverse=True):
        if base == s or base.startswith(s + "_"):
            tail = base[len(s):].lstrip("_")
            if tail == "" or tail.isdigit():
                return s
    raise ValueError(
        f"cannot infer stream from {filename!r}; expected one of {STREAMS}")


def convert_file(pt_path, out_dir, strict=False):
    """One reference ``.pt`` -> ``<out_dir>/<stream>.npz``; returns its
    path."""
    stream = stream_of(pt_path)
    tree, scalars = CONVERTERS[stream](_load_torch(pt_path), strict)
    out_path = os.path.join(out_dir, f"{stream}.npz")
    save_pytree(out_path, tree, **scalars)
    n = sum(np.asarray(x).size for x in _flat_leaves(tree))
    print(f"{os.path.basename(pt_path)} -> {out_path} "
          f"({n} values, scalars={scalars})")
    return out_path


def _flat_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat_leaves(v)
    else:
        yield tree


def scan_dir(src, step=None):
    """One ``.pt`` per stream found in ``src``: the ``--step`` backup when
    ``step`` is given, else the live file, else the highest numbered
    backup."""
    found = []
    for s in STREAMS:
        if step is not None:
            p = os.path.join(src, f"{s}_{step}.pt")
            if os.path.exists(p):
                found.append(p)
            continue
        live = os.path.join(src, f"{s}.pt")
        if os.path.exists(live):
            found.append(live)
            continue
        pat = re.compile(re.escape(s) + r"_(\d+)\.pt$")
        backups = [(int(m.group(1)), f) for f in os.listdir(src)
                   if (m := pat.match(f))]
        if backups:
            _, f = max(backups)
            print(f"using numbered backup {f} for stream {s}")
            found.append(os.path.join(src, f))
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", help=".pt file or directory holding the streams")
    ap.add_argument("out_dir", help="output directory for npz streams")
    ap.add_argument("--step", type=int, default=None,
                    help="pick the numbered backup model_<step>.pt instead "
                         "of the live files")
    ap.add_argument("--strict", action="store_true",
                    help="error on unrecognised non-DPT checkpoint keys "
                         "instead of warning")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if os.path.isdir(args.src):
        found = scan_dir(args.src, args.step)
        if not found:
            what = (f"step-{args.step} backups" if args.step is not None
                    else f"{'/'.join(STREAMS)}.pt or numbered backups")
            raise SystemExit(f"no {what} found in {args.src}")
    else:
        found = [args.src]
    return [convert_file(f, args.out_dir, args.strict) for f in found]


if __name__ == "__main__":
    main()
