"""Novel-view render CLI of the port, mirroring the repository's
``vis/render.py``:

    python -m nope_nerf_tpu_torch.render configs/Tanks/Ignatius.yaml [--device cpu]

Restores the field (and the poses and the learned focal) from
``training.out_dir``, builds a novel trajectory from the learned poses
(``extract_images.traj_option``: ``interp`` slerp, ``bspline``, or
``sprial``, the reference's spelling, for the LLFF spiral), renders each
view with ``render_image`` (Kernel A's forward under the stock config on
the card) and writes, under ``<out_dir>/<extraction_dir>/extracted_images/
<traj_option>/``: ``img_out/NNNN.png``, ``depth_out/NNNN.png`` (per-frame
normalised) and ``depth_out/N.npy`` (raw depth), ``geo_out/NNNN.png`` (the
Phong preview) with ``extract_images.output_geo``, and then
``video_out/{img,depth[,geo]}.mp4``.

Runs on ``--device`` (default ``cuda``; with no CUDA device it raises
unless ``--device cpu`` is given). Images are written with PIL and the
videos by the port's MJPEG muxer (``utils.video``).
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
from .convert import load_group
from .dataloading.scene import get_scene
from .device import resolve_device
from .geometry.rays import camera_mat_from_fxfy
from .geometry.trajectory import (
    generate_spiral_nerf,
    interp_poses,
    interp_poses_bspline,
)
from .models.intrinsics import focal_fxfy
from .models.pose import all_poses
from .ops.rendering import render_image
from .training.checkpoints import CheckpointIO
from .training.trainer import make_render_cfg
from .training.visualize import view_images
from .utils.video import write_video


def render_novel_views(nerf_params, camera_mat, c2ws, render_cfg, resolution,
                       render_dir, *, output_geo=False, rad=4.0):
    """Render each novel c2w (numpy (N, 4, 4)) on the field's device and
    write the per-frame artifact tree under ``render_dir``. Returns (imgs,
    depths, geos) as lists of uint8 arrays for the videos."""
    dev = nerf_params["trunk0_0"]["w"].device
    img_out_dir = os.path.join(render_dir, "img_out")
    depth_out_dir = os.path.join(render_dir, "depth_out")
    geo_out_dir = os.path.join(render_dir, "geo_out")
    os.makedirs(img_out_dir, exist_ok=True)
    os.makedirs(depth_out_dir, exist_ok=True)
    if output_geo:
        os.makedirs(geo_out_dir, exist_ok=True)
    cam = torch.as_tensor(np.asarray(camera_mat), dtype=torch.float32,
                          device=dev)
    eye = torch.eye(4, device=dev)
    resolution = tuple(resolution)
    imgs, depths, geos = [], [], []
    for i, c2w in enumerate(np.asarray(c2ws)):
        world_mat = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                                    device=dev)
        view = (cam, world_mat, eye)
        rgb, depth = render_image(nerf_params, resolution, *view, render_cfg)
        np.save(os.path.join(depth_out_dir, f"{i}.npy"), depth.cpu().numpy())
        img, d_vis, geo = view_images(rgb, depth, nerf_params, view,
                                      render_cfg,
                                      geo_rad=rad if output_geo else None)
        name = str(i).zfill(4) + ".png"
        for out_dir, image, images in ((img_out_dir, img, imgs),
                                       (depth_out_dir, d_vis, depths),
                                       (geo_out_dir, geo, geos)):
            if image is not None:
                images.append(image)
                Image.fromarray(image).save(os.path.join(out_dir, name))
        print(f"rendered novel view {i + 1}/{len(c2ws)}")
    return imgs, depths, geos


def main(cfg, device="cuda"):
    """Render the novel views of the run in ``training.out_dir``; returns
    the render directory."""
    apply_parity_profile(cfg)
    np.random.seed(0)
    dev = resolve_device(device)
    out_dir = cfg["training"]["out_dir"]
    xcfg, pcfg = cfg["extract_images"], cfg["pose"]
    generation_dir = os.path.join(out_dir, xcfg["extraction_dir"])
    op = xcfg["traj_option"]
    n_novel = xcfg["N_novel_imgs"]

    scene = get_scene(cfg, mode="render")
    io = CheckpointIO(out_dir)
    nerf_params = load_group(io, xcfg["model_file"], "nerf", dev)
    render_cfg = make_render_cfg(cfg, dev)

    if pcfg["learn_pose"]:
        pose_params = load_group(io, xcfg["model_file_pose"], "pose")
        init_c2w = (torch.as_tensor(scene.c2ws, dtype=torch.float32)
                    if (pcfg["init_pose"] and scene.c2ws is not None)
                    else None)
        learned = all_poses(pose_params, init_c2w).numpy()
    else:
        learned = scene.c2ws

    if op == "sprial":  # the reference's spelling
        bds = np.array([2.0, 4.0])
        c2ws = generate_spiral_nerf(learned, bds, n_novel, scene.hwf)
        pad = np.tile(np.eye(4, dtype=np.float32), (c2ws.shape[0], 1, 1))
        pad[:, :3, :4] = c2ws
        c2ws = pad
    elif op == "interp":
        c2ws = interp_poses(learned, n_novel)
    elif op == "bspline":
        c2ws = interp_poses_bspline(learned, n_novel, scene.i_train,
                                    xcfg["bspline_degree"])
    else:
        raise ValueError(f"unknown traj_option {op}")

    if pcfg["learn_focal"]:
        fparams = load_group(io, xcfg["model_file_focal"], "focal")
        fxfy = focal_fxfy(fparams, pcfg["fx_only"], pcfg["focal_order"])
        camera_mat = camera_mat_from_fxfy(fxfy).numpy()
        print(f"learned fx: {float(fxfy[0]):.2f}, fy: {float(fxfy[1]):.2f}")
    else:
        camera_mat = scene.K

    resolution = xcfg["resolution"] or (scene.H, scene.W)
    render_dir = os.path.join(generation_dir, "extracted_images", op)
    os.makedirs(render_dir, exist_ok=True)
    imgs, depths, geos = render_novel_views(
        nerf_params, camera_mat, np.asarray(c2ws), render_cfg,
        tuple(resolution), render_dir,
        output_geo=bool(xcfg.get("output_geo", False)),
        rad=cfg["rendering"]["radius"])

    video_dir = os.path.join(render_dir, "video_out")
    os.makedirs(video_dir, exist_ok=True)
    write_video(os.path.join(video_dir, "img.mp4"), np.stack(imgs))
    write_video(os.path.join(video_dir, "depth.mp4"),
                np.stack(depths)[..., None].repeat(3, -1))
    if geos:
        write_video(os.path.join(video_dir, "geo.mp4"), np.stack(geos))
    print(f"videos written to {video_dir}")
    return render_dir


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Render novel views (nope-nerf on PyTorch + CUDA).")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda).")
    args = parser.parse_args()
    cfg = load_config(args.config, DEFAULT_CONFIG)
    check_supported(cfg)
    main(cfg, device=args.device)
