"""Sphere-traced Phong preview renderer (port of
``nope_nerf_tpu/ops/phong.py``), for the ``vis_geo`` images and the render
CLI's ``output_geo``.

Sphere-intersection bounded ray marching (512 proposal steps), secant root
refinement (8 steps) and Lambertian shading from the field-gradient normals,
with the JAX package's semantics: ``+inf`` where no surface is found, ``0``
where the first sample is already occupied, the first negative-to-positive
sign change picked through ``cost = sign * arange(n, 0, -1)`` and its
min / argmin, 1e-12 in the secant and the same clamps. The occupancy
queries run the plain MLP (``apply_nerf(only_occupancy=True)`` bypasses
Kernel C); everything runs without autograd but the normals.
"""
from __future__ import annotations

import torch

from ..geometry.rays import (
    image_points_to_world,
    origin_to_world,
    to_world_transform,
)
from ..models.nerf import apply_nerf, nerf_gradient


def get_sphere_intersection(cam_loc, ray_dirs, r=1.0):
    """Ray-sphere intersection depths (near, far), clamped at 0.

    cam_loc (3,), ray_dirs (N, 3). Returns (intersections (N, 2), mask (N,)
    bool)."""
    ray_cam_dot = ray_dirs @ cam_loc
    under_sqrt = ray_cam_dot ** 2 - (torch.sum(cam_loc ** 2) - r ** 2)
    mask = under_sqrt > 0
    sq = torch.sqrt(torch.clamp_min(under_sqrt, 0.0))
    inter = torch.stack([-sq - ray_cam_dot, sq - ray_cam_dot], dim=-1)
    inter = torch.where(mask[:, None], inter, 0.0)
    return torch.clamp_min(inter, 0.0), mask


def _occupancy(nerf_params, pts, cfg, n_max):
    """Occupancy (M,) of points (M, 3), ``n_max`` points per field call."""
    return torch.cat([
        apply_nerf(nerf_params, pts[i:i + n_max], None, cfg,
                   only_occupancy=True)[:, 0]
        for i in range(0, pts.shape[0], n_max)])


def ray_marching(nerf_params, ray0, ray_dirs, cfg, *, tau=0.5, n_steps=512,
                 n_secant_steps=8, rad=1.0):
    """Surface depths d (N,) along rays from ``ray0`` (3,) in unit
    directions ``ray_dirs`` (N, 3): ``+inf`` where no surface is found, 0
    where the first sample is already occupied.

    The (N * n_steps) proposal points are evaluated in chunks of whole rays,
    at most ``cfg["n_max_network_queries"]`` points each (all at once
    without that key); the field is per point, so chunking changes no
    value."""
    with torch.no_grad():
        N = ray_dirs.shape[0]
        d_far = get_sphere_intersection(ray0, ray_dirs, r=rad)[0][:, 1]
        t = torch.linspace(0.0, 1.0, n_steps, dtype=d_far.dtype,
                           device=d_far.device)
        d_prop = d_far[:, None] * t[None, :]
        n_max = cfg.get("n_max_network_queries") or N * n_steps
        rays_chunk = max(n_max // n_steps, 1)
        occ = []
        for i in range(0, N, rays_chunk):
            pts = (ray0[None, None, :] + ray_dirs[i:i + rays_chunk, None, :]
                   * d_prop[i:i + rays_chunk, :, None])
            occ.append(_occupancy(nerf_params, pts.reshape(-1, 3), cfg,
                                  n_max).reshape(-1, n_steps))
        val = torch.cat(occ) - tau

        mask_0_not_occupied = val[:, 0] < 0
        # the first sign change from negative to positive
        sign = torch.sign(val[:, :-1] * val[:, 1:])
        sign = torch.cat([sign, torch.ones_like(sign[:, :1])], dim=-1)
        cost = sign * torch.arange(n_steps, 0, -1, dtype=val.dtype,
                                   device=val.device)[None, :]
        values = torch.min(cost, dim=-1).values
        indices = torch.argmin(cost, dim=-1)
        mask_sign_change = values < 0
        mask_neg_to_pos = val.gather(1, indices[:, None])[:, 0] < 0
        mask = mask_sign_change & mask_neg_to_pos & mask_0_not_occupied

        idx_hi = torch.clamp_max(indices + 1, n_steps - 1)
        d_low = d_prop.gather(1, indices[:, None])[:, 0]
        f_low = val.gather(1, indices[:, None])[:, 0]
        d_high = d_prop.gather(1, idx_hi[:, None])[:, 0]
        f_high = val.gather(1, idx_hi[:, None])[:, 0]

        d_pred = -f_low * (d_high - d_low) / (f_high - f_low + 1e-12) + d_low
        for _ in range(n_secant_steps):
            p_mid = ray0[None] + d_pred[:, None] * ray_dirs
            f_mid = _occupancy(nerf_params, p_mid, cfg, n_max) - tau
            low = f_mid < 0
            d_low = torch.where(low, d_pred, d_low)
            f_low = torch.where(low, f_mid, f_low)
            d_high = torch.where(low, d_high, d_pred)
            f_high = torch.where(low, f_high, f_mid)
            d_pred = (-f_low * (d_high - d_low) / (f_high - f_low + 1e-12)
                      + d_low)

        d_out = torch.where(mask, d_pred, torch.inf)
        return torch.where(mask_0_not_occupied, d_out, 0.0)


def phong_render(nerf_params, pixels, camera_mat, world_mat, scale_mat, cfg,
                 *, rad=4.0):
    """Lambertian-shaded surface preview of pixels (N, 2) in scaled
    coordinates. Returns {"rgb": (N, 3), "rgb_surf": (N, 3)}: the shading
    (white where no surface is found) and the field's colour at the
    surface (0 there)."""
    with torch.no_grad():
        transform = to_world_transform(camera_mat, world_mat, scale_mat)
        cam = origin_to_world(camera_mat, world_mat, scale_mat,
                              transform=transform)
        pw = image_points_to_world(pixels, camera_mat, world_mat, scale_mat,
                                   transform=transform)
        rays = pw - cam[None]
        rays = rays / torch.sqrt(torch.clamp_min(
            torch.sum(rays * rays, -1, keepdim=True), 1e-24))
        d_i = ray_marching(nerf_params, cam, rays, cfg, rad=rad)
        mask = torch.isfinite(d_i) & (d_i != 0.0)
        dists = torch.where(mask, d_i, 0.0)
        points = cam[None] + rays * dists[:, None]
        light = cam / torch.sqrt(torch.clamp_min(torch.sum(cam ** 2), 1e-24))

    grad = nerf_gradient(nerf_params, points, cfg)

    with torch.no_grad():
        normals = grad / torch.sqrt(torch.clamp_min(
            torch.sum(grad * grad, -1, keepdim=True), 1e-24))
        diffuse = torch.clamp_min(normals @ light, 0.0)[:, None] * 0.7
        shaded = torch.clamp(0.3 + diffuse, 0.0, 1.0)
        rgb = torch.where(mask[:, None], shaded.expand(pixels.shape[0], 3),
                          1.0)
        # the field's colour at the surface
        rgb_surf_raw, _ = apply_nerf(nerf_params, points, -rays, cfg)
        rgb_surf = torch.where(mask[:, None], rgb_surf_raw, 0.0)
    return {"rgb": rgb, "rgb_surf": rgb_surf}
