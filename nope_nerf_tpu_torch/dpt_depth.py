"""Depth-prior preprocessing CLI of the port (twin of
``preprocess/dpt_depth.py``):

    python -m nope_nerf_tpu_torch.dpt_depth configs/preprocess.yaml [--device cpu]

Runs a frozen monocular depth network over every frame of the scene
(``training.mode``, default ``all``) in batches of 4 and writes
``<scene>/<depth_net>[_<crop_size>]/depth_<name>.npz`` (``pred``, (1, H',
W') f32, at the network input's size) and a ``<name>.png`` preview: the
priors training reads. ``depth.type`` picks the network:

* ``DPT``: DPT-Hybrid (``models.dpt``), ``depth.path`` the npz of
  ``python -m nope_nerf_tpu_torch.convert_dpt``; 540x960 frames give
  384x672 priors;
* ``DepthAnythingV2``: Depth Anything V2-Large (``models.depth_anything``),
  ``depth.path`` the npz of ``python -m
  nope_nerf_tpu_torch.convert_depth_anything``; 540x960 frames give 518x924
  priors; ``depth.input_size`` (default 518) is the published
  ``infer_image``'s ``input_size``.

Each batch of frames is uploaded once and goes through
:func:`depth_batch` (the input transform on the device in float64, the
network, the depth tail), the function the benchmark's depth-prior cells
time. Runs on ``--device`` (default ``cuda``; with no CUDA device it
raises unless ``--device cpu`` is given), in full f32 (TF32 off around the
forward). With ``tpu.n_devices`` N > 1 it is one of N processes of
``python -m torch.distributed.run --nproc-per-node N -m
nope_nerf_tpu_torch.dpt_depth <cfg>``: each batch's frames are sharded
over the ranks (batches of 4 * max(N // 4, 1), at least N, the last one
padded) and rank 0 writes the files, as the JAX CLI does.
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
from . import tracing
from .dataloading.scene import get_scene
from .device import resolve_device
from .models import depth_anything as da
from .models.dpt import (
    apply_dpt_batched,
    dpt_input_transform_batched,
    load_dpt,
)
from .parallel.mesh import barrier
from .training.loop import mesh_for

BATCH = 4
# the eager tracing phase of depth_batch's sections
PHASE = "depth_priors"


# depth.type -> (the weights' converter, their loader)
NETWORKS = {"DPT": ("convert_dpt", load_dpt),
            "DepthAnythingV2": ("convert_depth_anything",
                                da.load_depth_anything)}


def depth_batch(params, frames, depth_cfg, mesh=None, pre_relu=False):
    """(B, H, W, 3) frames in [0, 1] on the parameters' device -> (B, h',
    w') f32 depth on that device (the inverse depth with ``invert`` False,
    and the head's output before its ReLU with ``non_negative`` False too):
    the network of ``depth_cfg["type"]`` (``DPT`` where it has none), its
    input transform, then the network with ``depth_cfg``'s ``scale``,
    ``shift``, ``invert`` and ``non_negative``, sharded over ``mesh``. With
    ``pre_relu``, (depth, the head's output before its ReLU) from the same
    kernels.

    Traced as the host span ``dpt.batch`` around one eager step of the
    phase ``depth_priors`` (``tracing.py``), whose sections tile the
    batch: ``dpt.transform``, then DPT-Hybrid's ``dpt.resnet``,
    ``dpt.vit`` and ``dpt.decoder``, or Depth Anything's ``dpt.dinov2``
    (with ``dpt.dinov2.attn`` around each block's attention cores) and
    ``dpt.decoder``. Counts ``dpt.frames``, ``dpt.batches`` and
    ``dpt.tokens`` (the encoder's tokens, class token included, of all
    the frames). Nothing in it waits for the device."""
    kind = depth_cfg.get("type", "DPT")
    if kind not in NETWORKS:
        raise ValueError(f"depth.type {kind!r}: one of {sorted(NETWORKS)}")
    tail = {k: depth_cfg[k] for k in ("scale", "shift", "invert",
                                      "non_negative")}
    with tracing.span("dpt.batch"), \
            tracing.eager_step(PHASE, frames.device):
        tracing.section("dpt.transform")
        if kind == "DPT":
            x = dpt_input_transform_batched(frames)
            depth = apply_dpt_batched(params, x, mesh=mesh,
                                      pre_relu=pre_relu, **tail)
            patch = 16
        else:
            x = da.depth_anything_input_transform_batched(
                frames, depth_cfg.get("input_size", da.INPUT_SIZE))
            depth = da.apply_depth_anything_batched(
                params, x, mesh=mesh, pre_relu=pre_relu, **tail)
            patch = da.PATCH
    n = frames.shape[0]
    tracing.count("dpt.frames", n)
    tracing.count("dpt.batches")
    tracing.count("dpt.tokens",
                  n * ((x.shape[1] // patch) * (x.shape[2] // patch) + 1))
    return depth


def main(cfg, device="cuda", mesh=None):
    """Write the priors; returns the output directory. ``mesh`` (of
    ``tpu.n_devices`` ranks) defaults to :func:`..training.loop.mesh_for`'s."""
    apply_parity_profile(cfg)
    kind = cfg["depth"]["type"]
    if kind not in NETWORKS:
        raise AssertionError("set depth.type: DPT or DepthAnythingV2 for "
                             "preprocessing")
    dev = resolve_device(device)
    if mesh is None:
        mesh = mesh_for(cfg, dev)
    if mesh is not None:
        dev = mesh.device
    lead = mesh is None or mesh.rank == 0
    n_dev = mesh.size if mesh is not None else 1
    batch_size = max(BATCH * max(n_dev // 4, 1), n_dev)
    weights_path = cfg["depth"]["path"]
    converter, load = NETWORKS[kind]
    if not os.path.exists(weights_path):
        raise FileNotFoundError(
            f"{kind} weights not found at {weights_path}; convert the "
            f"published checkpoint with python -m nope_nerf_tpu_torch."
            f"{converter} first")
    params = load(weights_path, dev)

    scene = get_scene(cfg, mode=cfg["training"].get("mode", "all"))
    dcfg, depth = cfg["dataloading"], cfg["depth"]
    depth_net = dcfg["depth_net"]
    if dcfg["crop_size"] != 0:
        depth_net = f"{depth_net}_{dcfg['crop_size']}"
    out_dir = os.path.join(dcfg["path"], dcfg["scene"][0], depth_net)
    os.makedirs(out_dir, exist_ok=True)

    names = [n.split(".")[0] for n in scene.img_list]
    for start in range(0, scene.N_imgs, batch_size):
        frames = torch.as_tensor(scene.imgs[start:start + batch_size],
                                 device=dev)
        depths = depth_batch(params, frames, depth, mesh).cpu().numpy()
        if not lead:
            continue
        for d, name in zip(depths, names[start:]):
            np.savez(os.path.join(out_dir, f"depth_{name}.npz"),
                     pred=d.astype(np.float32)[None])
            # the reference's preview: scaled by max AFTER subtracting min,
            # so the brightest pixel is < 255 whenever min > 0
            vis = np.clip(255.0 / max(d.max(), 1e-8) * (d - d.min()), 0, 255)
            Image.fromarray(vis.astype(np.uint8)).save(
                os.path.join(out_dir, f"{name}.png"))
            print(f"depth_{name}.npz written")
    barrier(mesh)  # no rank leaves before rank 0's files are written
    return out_dir


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Depth-prior preprocessing (nope-nerf on PyTorch + CUDA).")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda).")
    args = parser.parse_args()
    cfg = load_config(args.config, DEFAULT_CONFIG)
    check_supported(cfg)
    main(cfg, device=args.device)
