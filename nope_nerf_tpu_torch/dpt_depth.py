"""DPT depth-prior preprocessing CLI of the port (twin of
``preprocess/dpt_depth.py``):

    python -m nope_nerf_tpu_torch.dpt_depth configs/preprocess.yaml [--device cpu]

Runs the frozen DPT-hybrid network (``models.dpt``) over every frame of the
scene (``training.mode``, default ``all``) in batches of 4 and writes
``<scene>/<depth_net>[_<crop_size>]/depth_<name>.npz`` (``pred``, (1, H',
W') f32, at the ``dpt_input_transform`` size) and a ``<name>.png``
preview: the priors training reads. ``depth.type`` must be ``DPT`` and
``depth.path`` the npz of ``python -m nope_nerf_tpu_torch.convert_dpt``.

Runs on ``--device`` (default ``cuda``; with no CUDA device it raises
unless ``--device cpu`` is given), in full f32 (TF32 off around the
forward). ``tpu.n_devices > 1`` raises: multiple GPUs are not ported.
"""
import argparse
import os

import numpy as np
import torch
from PIL import Image

from .config import (
    DEFAULT_CONFIG,
    apply_parity_profile,
    check_supported,
    load_config,
)
from .dataloading.scene import get_scene
from .device import resolve_device
from .models.dpt import apply_dpt_batched, dpt_input_transform, load_dpt

BATCH = 4


def main(cfg, device="cuda"):
    """Write the priors; returns the output directory."""
    apply_parity_profile(cfg)
    if cfg["depth"]["type"] != "DPT":
        raise AssertionError("set depth.type: DPT for preprocessing")
    if int((cfg.get("tpu", {}) or {}).get("n_devices", 1) or 1) > 1:
        raise NotImplementedError("tpu.n_devices > 1 is not ported yet")
    dev = resolve_device(device)
    weights_path = cfg["depth"]["path"]
    if not os.path.exists(weights_path):
        raise FileNotFoundError(
            f"DPT weights not found at {weights_path}; convert the published "
            "checkpoint with python -m nope_nerf_tpu_torch.convert_dpt first")
    params = load_dpt(weights_path, dev)

    scene = get_scene(cfg, mode=cfg["training"].get("mode", "all"))
    dcfg, depth = cfg["dataloading"], cfg["depth"]
    depth_net = dcfg["depth_net"]
    if dcfg["crop_size"] != 0:
        depth_net = f"{depth_net}_{dcfg['crop_size']}"
    out_dir = os.path.join(dcfg["path"], dcfg["scene"][0], depth_net)
    os.makedirs(out_dir, exist_ok=True)

    names = [n.split(".")[0] for n in scene.img_list]
    for start in range(0, scene.N_imgs, BATCH):
        batch = np.stack([dpt_input_transform(scene.imgs[i]) for i in
                          range(start, min(start + BATCH, scene.N_imgs))])
        depths = apply_dpt_batched(
            params, torch.as_tensor(batch, device=dev), scale=depth["scale"],
            shift=depth["shift"], invert=depth["invert"],
            non_negative=depth["non_negative"]).cpu().numpy()
        for d, name in zip(depths, names[start:]):
            np.savez(os.path.join(out_dir, f"depth_{name}.npz"),
                     pred=d.astype(np.float32)[None])
            # the reference's preview: scaled by max AFTER subtracting min,
            # so the brightest pixel is < 255 whenever min > 0
            vis = np.clip(255.0 / max(d.max(), 1e-8) * (d - d.min()), 0, 255)
            Image.fromarray(vis.astype(np.uint8)).save(
                os.path.join(out_dir, f"{name}.png"))
            print(f"depth_{name}.npz written")
    return out_dir


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="DPT depth preprocessing (nope-nerf on PyTorch + CUDA).")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda).")
    args = parser.parse_args()
    cfg = load_config(args.config, DEFAULT_CONFIG)
    check_supported(cfg)
    main(cfg, device=args.device)
