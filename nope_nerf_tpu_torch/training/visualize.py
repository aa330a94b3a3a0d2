"""Periodic training visualisations (port of
``nope_nerf_tpu/training/visualize.py``): a low-resolution rgb + depth
render of a monitor frame, and the Phong geometry preview with
``training.vis_geo``. Images are written with PIL."""
from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..geometry.rays import arange_pixels, camera_mat_from_fxfy
from ..models.intrinsics import focal_fxfy
from ..models.pose import pose_c2w
from ..ops.phong import phong_render
from ..ops.rendering import render_image


def visdata_view(params, cfg, init_c2w, scene, img_idx=0):
    """(camera_mat, world_mat, scale_mat) of frame ``img_idx`` at the
    learned pose and focal, on the parameters' device."""
    dev = params["nerf"]["trunk0_0"]["w"].device
    if cfg["pose"]["learn_pose"]:
        world_mat = torch.linalg.inv(pose_c2w(params["pose"], img_idx,
                                              init_c2w))
    else:
        world_mat = torch.eye(4, device=dev)
    if cfg["pose"]["learn_focal"]:
        camera_mat = camera_mat_from_fxfy(focal_fxfy(
            params["focal"], cfg["pose"]["fx_only"],
            cfg["pose"]["focal_order"]))
    else:
        camera_mat = torch.as_tensor(np.asarray(scene.K), dtype=torch.float32,
                                     device=dev)
    scale_mat = torch.as_tensor(np.asarray(scene.scale_mat),
                                dtype=torch.float32, device=dev)
    return camera_mat, world_mat, scale_mat


def view_images(rgb, depth, nerf_params, view, render_cfg, *, geo_rad=None):
    """The uint8 images of one rendered (h, w) view: the rgb (h, w, 3)
    clipped to [0, 1], the depth (h, w) normalised by its min and max, and
    with ``geo_rad`` the Phong preview (h, w, 3) of the field from ``view``
    = (camera_mat, world_mat, scale_mat) inside that sphere radius, else
    None."""
    h, w = depth.shape
    rgb = np.clip(rgb.cpu().numpy(), 0, 1)
    depth = depth.cpu().numpy()
    img = (rgb * 255).astype(np.uint8)
    d_vis = np.clip(255.0 / max(depth.max(), 1e-8) * (depth - depth.min()),
                    0, 255).astype(np.uint8)
    geo = None
    if geo_rad is not None:
        _, pixels = arange_pixels((h, w), device=view[0].device)
        out = phong_render(nerf_params, pixels, *view, render_cfg,
                           rad=geo_rad)
        geo = (np.clip(out["rgb"].cpu().numpy().reshape(h, w, 3), 0, 1)
               * 255).astype(np.uint8)
    return img, d_vis, geo


def render_visdata(state, cfg, render_cfg, init_c2w, scene, resolution, it,
                   out_render_path, img_idx=0, mesh=None):
    """Write ``%04d_img.png`` and ``%04d_depth.png`` (and ``%04d_geo.png``
    with ``vis_geo``) of frame ``img_idx`` into ``out_render_path``. The rgb
    and depth come from ``render_image`` (Kernel A's forward under the stock
    config on the card), the geometry from ``phong_render``. ``it`` is
    unused, as in the JAX package. Returns the rgb (h, w, 3) in [0, 1].

    With ``mesh`` every rank renders its rows of each chunk (the chunk
    rounded down to a multiple of the mesh size); rank 0 alone draws the
    Phong preview and writes the files."""
    h, w = resolution
    params = state.params
    chunk = min(h * w, 16384)
    if mesh is not None:
        chunk = max(chunk // mesh.size * mesh.size, mesh.size)
    with torch.no_grad():
        view = visdata_view(params, cfg, init_c2w, scene, img_idx)
        rgb, depth = render_image(params["nerf"], (h, w), *view, render_cfg,
                                  chunk=chunk, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return np.clip(rgb.cpu().numpy(), 0, 1)
    os.makedirs(out_render_path, exist_ok=True)
    geo_rad = (cfg["rendering"]["radius"]
               if cfg["training"].get("vis_geo", False) else None)
    images = view_images(rgb, depth, params["nerf"], view, render_cfg,
                         geo_rad=geo_rad)
    for kind, image in zip(("img", "depth", "geo"), images):
        if image is not None:
            Image.fromarray(image).save(os.path.join(
                out_render_path, "%04d_%s.png" % (img_idx, kind)))
    return np.clip(rgb.cpu().numpy(), 0, 1)
