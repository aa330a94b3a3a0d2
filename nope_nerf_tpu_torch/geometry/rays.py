"""Camera / ray math: pixel grids, world transforms, NDC rays (port of
``nope_nerf_tpu/geometry/rays.py``).

Pixel convention: coordinates scaled to [-1, 1], x along the width, y along
the height; K = [[fx,0,0,0],[0,-fy,0,0],[0,0,-1,0],[0,0,0,1]] in normalised
units (an OpenGL-style camera looking down -z with a flipped y). Functions
are unbatched: pixels (N, 2), matrices (4, 4). Matmuls here are tiny and
must run in full f32 (no TF32).
"""
from __future__ import annotations

import torch


def arange_pixels(resolution, image_range=(-1.0, 1.0), device=None):
    """(pixel_locations (h*w, 2) int32 [x, y], pixel_scaled (h*w, 2) f32),
    rows in row-major order."""
    h, w = resolution
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    loc = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    scale = image_range[1] - image_range[0]
    shift = (image_range[1] - image_range[0]) / 2.0
    scaled = torch.stack(
        [
            scale * loc[:, 0].to(torch.float32) / (w - 1) - shift,
            scale * loc[:, 1].to(torch.float32) / (h - 1) - shift,
        ],
        dim=-1,
    )
    return loc.to(torch.int32), scaled


def pixels_from_flat_idx(idx, hw):
    """Scaled pixel coordinates of flat row-major indices, the O(n) form of
    ``arange_pixels(hw)[1][idx]``. Returns (pixels (n, 2), rows, cols)."""
    H, W = hw
    rr = torch.div(idx, W, rounding_mode="floor")
    rc = idx % W
    px = 2.0 * rc.to(torch.float32) / (W - 1) - 1.0
    py = 2.0 * rr.to(torch.float32) / (H - 1) - 1.0
    return torch.stack([px, py], dim=-1), rr, rc


def rigid_inv(M):
    """Inverse of a rigid 4x4 [[R, t], [0, 1]]: [[R^T, -R^T t], [0, 1]]."""
    R = M[:3, :3]
    t = M[:3, 3]
    top = torch.cat([R.t(), -(R.t() @ t[:, None])], dim=1)
    bottom = torch.eye(4, dtype=M.dtype, device=M.device)[3:]
    return torch.cat([top, bottom], dim=0)


def to_world_transform(camera_mat, world_mat, scale_mat):
    """Pixel -> world homogeneous transform scale^-1 . world^-1 . camera^-1.
    ``inv_ex`` skips the singularity check, which would synchronise with
    the device on every call."""
    def inv(m):
        return torch.linalg.inv_ex(m).inverse

    return (inv(scale_mat) @ inv(world_mat)) @ inv(camera_mat)


def transform_to_world(pixels, depth, camera_mat, world_mat=None,
                       scale_mat=None, transform=None):
    """Pixels (N, 2) at depth (N,) -> world points (N, 3); homogeneous
    coordinates [x*d, y*d, d, 1]."""
    if transform is None:
        eye = torch.eye(4, dtype=pixels.dtype, device=pixels.device)
        world_mat = eye if world_mat is None else world_mat
        scale_mat = eye if scale_mat is None else scale_mat
        transform = to_world_transform(camera_mat, world_mat, scale_mat)
    depth = depth.reshape(-1)
    p_hom = torch.stack(
        [pixels[:, 0] * depth, pixels[:, 1] * depth, depth,
         torch.ones_like(depth)], dim=-1)
    return (p_hom @ transform.t())[:, :3]


def origin_to_world(camera_mat, world_mat, scale_mat, transform=None):
    """Camera origin in world coordinates, (3,)."""
    if transform is None:
        transform = to_world_transform(camera_mat, world_mat, scale_mat)
    return transform[:3, 3]


def image_points_to_world(pixels, camera_mat, world_mat, scale_mat,
                          transform=None):
    """Pixels on the image plane (depth 1) -> world points (N, 3)."""
    depth = torch.ones(pixels.shape[0], dtype=pixels.dtype, device=pixels.device)
    return transform_to_world(pixels, depth, camera_mat, world_mat, scale_mat,
                              transform=transform)


def project_to_cam(points, camera_mat):
    """Camera-frame points (N, 3) -> (xy (N, 2) in [-1, 1] scale, valid (N,)
    bool for |xy| <= 1)."""
    ones = torch.ones((points.shape[0], 1), dtype=points.dtype,
                      device=points.device)
    xy = torch.cat([points, ones], dim=-1) @ camera_mat.t()
    xy = xy[:, :2] / xy[:, 2:3]
    valid = torch.amax(torch.abs(xy), dim=-1) <= 1.0
    return xy, valid


def camera_mat_from_fxfy(fxfy):
    """[[fx,0,0,0],[0,-fy,0,0],[0,0,-1,0],[0,0,0,1]] from (2,) [fx, fy]."""
    fx, fy = fxfy[0], fxfy[1]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, z, z, z]),
        torch.stack([z, -fy, z, z]),
        torch.stack([z, z, -o, z]),
        torch.stack([z, z, z, o]),
    ])


def get_ndc_rays_fxfy(fxfy, near, rays_o, rays_d):
    """World rays (N, 3) -> NDC rays (origins, directions), for LLFF
    forward-facing scenes."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -fxfy[0] * ox_oz
    o1 = -fxfy[1] * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -fxfy[0] * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -fxfy[1] * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
