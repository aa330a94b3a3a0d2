"""Differentiable volume renderer (port of ``nope_nerf_tpu/ops/rendering.py``).

Two field paths, chosen by the render config:

* fused (``use_pallas_mlp`` and ``fuse_compositing``): point expansion,
  encodings, MLP, head activations and compositing in Kernel A
  (:func:`..ops.kernels.mlp_kernel.fused_mlp_composite`), per-ray tensors
  in and out;
* unfused: :func:`..models.nerf.apply_nerf` on the (N*S, 3) points, then
  :func:`composite` -- the oracle of the fused path.

Semantics kept from the JAX package: eps 1e-6 in the transmittance cumprod,
delta_far 1e10 and alpha[:, -1] = 1 in dist_alpha mode, white-background
compositing, the NDC ``1 - 1/d`` prior-depth conversion and the eval-time
dist -> depth division. Invalid rays (zero or non-finite prior depth) stay in
the batch and are masked by ``valid_mask``.
"""
from __future__ import annotations

import torch

from ..geometry.rays import (
    get_ndc_rays_fxfy,
    image_points_to_world,
    origin_to_world,
    to_world_transform,
    transform_to_world,
)

EPS = 1e-6


def stratified_zvals(z_val, noise):
    """Jitter z values within their bins by ``noise`` ~ U[0, 1) of z's
    shape (drawn by the caller from its generator)."""
    mid = 0.5 * (z_val[..., 1:] + z_val[..., :-1])
    hi = torch.cat([mid, z_val[..., -1:]], dim=-1)
    lo = torch.cat([z_val[..., :1], mid], dim=-1)
    return lo + (hi - lo) * noise


def composite(rgb, alpha, z_val, white_background=False):
    """rgb (N, S, 3), alpha (N, S), z (N, S) -> (rgb_values (N, 3),
    dist_pred (N,), weights (N, S)); weights = alpha * exclusive cumprod of
    (1 - alpha + 1e-6)."""
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + EPS], -1),
        dim=-1)[..., :-1]
    weights = alpha * trans
    rgb_values = torch.sum(weights[..., None] * rgb, dim=-2)
    dist_pred = torch.sum(weights * z_val, dim=-1)
    if white_background:
        rgb_values = rgb_values + (1.0 - torch.sum(weights, dim=-1))[..., None]
    return rgb_values, dist_pred, weights


def _deltas(z_val):
    return torch.cat([z_val[..., 1:] - z_val[..., :-1],
                      torch.full_like(z_val[..., :1], 1e10)], dim=-1)


def dist_to_alpha(density, z_val):
    """dist_alpha mode: alpha = 1 - exp(-sigma * delta) with delta_far 1e10
    and alpha[:, -1] forced to 1."""
    alpha = 1.0 - torch.exp(-density * _deltas(z_val))
    return torch.cat([alpha[..., :-1], torch.ones_like(alpha[..., -1:])], -1)


def render_rays(nerf_params, pixels, depth_prior, camera_mat, world_mat,
                scale_mat, cfg, *, generator=None, add_noise=False,
                eval_mode=False):
    """Render a batch of rays.

    pixels (N, 2) in [-1, 1]; depth_prior (N,); camera/world/scale (4, 4);
    ``cfg`` is the merged render config (:func:`..training.trainer.
    make_render_cfg`). ``generator`` (on the tensors' device) draws the
    stratified jitter when ``add_noise``. Returns a dict with rgb (N, 3),
    depth_pred, depth_gt, valid_mask (N,), z_vals, alpha (N, S),
    normal_diff (None) and points_surface (N, 3).
    """
    if cfg.get("normal_loss", False) and not eval_mode:
        raise NotImplementedError("rendering.normal_loss is not ported yet")
    S = cfg["num_points"] - cfg.get("outside_steps", 0)
    N = pixels.shape[0]
    dev = pixels.device
    near, far = cfg["depth_range"]
    sample_option = cfg["sample_option"]

    transform = to_world_transform(camera_mat, world_mat, scale_mat)
    camera_world = origin_to_world(camera_mat, world_mat, scale_mat,
                                   transform=transform)
    points_world = transform_to_world(pixels, depth_prior, camera_mat,
                                      transform=transform)
    diff = points_world - camera_world[None]
    d_sq = torch.sum(diff * diff, dim=-1)
    # safe sqrt: a zero prior depth would make every gradient nan
    d_i_gt = torch.sqrt(torch.clamp_min(d_sq, 1e-24))
    pixels_world = image_points_to_world(pixels, camera_mat, world_mat,
                                         scale_mat, transform=transform)
    ray_vector = pixels_world - camera_world[None]
    ray_norm = torch.sqrt(torch.clamp_min(
        torch.sum(ray_vector * ray_vector, dim=-1), 1e-24))
    if cfg["normalise_ray"]:
        ray_vector = ray_vector / ray_norm[..., None]
    else:
        d_i_gt = d_i_gt / ray_norm

    valid_mask = (torch.isfinite(d_i_gt) & (d_sq > 0.0)).to(torch.float32)
    dists = torch.where(valid_mask > 0, d_i_gt, torch.zeros_like(d_i_gt))

    z_val = torch.linspace(0.0, 1.0, S, dtype=torch.float32,
                           device=dev).expand(N, S)
    if sample_option == "ndc":
        focal = torch.stack([camera_mat[0, 0], camera_mat[1, 1]])
        ndc_o, ndc_d = get_ndc_rays_fxfy(focal, 1.0,
                                         camera_world[None].expand(N, 3),
                                         ray_vector)
        origins, rays_in = ndc_o, ndc_d
    else:
        z_val = near * (1.0 - z_val) + far * z_val
        if add_noise:
            noise = torch.rand(z_val.shape, generator=generator,
                               dtype=torch.float32, device=dev)
            z_val = stratified_zvals(z_val, noise)
        origins, rays_in = camera_world[None].expand(N, 3), ray_vector

    dir_per_ray = -ray_vector
    if not cfg["use_ray_dir"]:
        dir_per_ray = torch.ones_like(dir_per_ray)

    n_max = cfg.get("n_max_network_queries") or N * S
    if cfg.get("use_pallas_mlp", False) and cfg.get("fuse_compositing", False):
        # fused path, chunked over RAYS to honour n_max_network_queries
        rays_chunk = max(n_max // S, 1)
        outs = [
            _render_fused_composite(
                nerf_params, origins[i:i + rays_chunk],
                rays_in[i:i + rays_chunk], dir_per_ray[i:i + rays_chunk],
                z_val[i:i + rays_chunk], cfg, S)
            for i in range(0, N, rays_chunk)
        ]
        rgb_values, dist_pred, alpha = (torch.cat(o, 0) for o in zip(*outs))
    else:
        from ..models.nerf import apply_nerf

        pts = (origins[:, None, :] + rays_in[:, None, :] * z_val[..., None])
        pts = pts.reshape(-1, 3)
        dirs = dir_per_ray[:, None, :].expand(N, S, 3).reshape(-1, 3)
        chunks = [apply_nerf(nerf_params, pts[i:i + n_max], dirs[i:i + n_max],
                             cfg)
                  for i in range(0, N * S, n_max)]
        rgb = torch.cat([c[0] for c in chunks]).reshape(N, S, 3)
        alpha = torch.cat([c[1] for c in chunks]).reshape(N, S)
        if cfg["dist_alpha"]:
            alpha = dist_to_alpha(alpha, z_val)
        rgb_values, dist_pred, _ = composite(rgb, alpha, z_val,
                                             cfg["white_background"])
    return _render_outputs(cfg, eval_mode, valid_mask, dists, z_val, alpha,
                           rgb_values, dist_pred, camera_world, ray_vector,
                           ray_norm, d_i_gt, sample_option)


def _render_fused_composite(nerf_params, origins, rays_in, dir_per_ray,
                            z_val, cfg, S):
    """Kernel A on one ray batch: pads N to the JAX kernel's rays-per-block
    quantum (z and deltas padded with 1.0, so both packages see the same
    batch) and precomputes the deltas."""
    from .kernels.mlp_kernel import (_rays_per_block, collect_weights,
                                     fused_mlp_composite)

    N = origins.shape[0]
    deltas = _deltas(z_val)
    pad = (-N) % _rays_per_block(S)
    if pad:
        def zpad(a, value):
            return torch.cat([a, torch.full((pad, a.shape[1]), value,
                                            dtype=a.dtype, device=a.device)])

        origins, rays_in, dir_per_ray = (zpad(a, 0.0) for a in
                                         (origins, rays_in, dir_per_ray))
        z_val, deltas = zpad(z_val, 1.0), zpad(deltas, 1.0)
    rgb_values, dist_pred, alpha = fused_mlp_composite(
        collect_weights(nerf_params), origins, rays_in, dir_per_ray, z_val,
        deltas, cfg["pos_enc_levels"], cfg["dir_enc_levels"],
        cfg["occ_activation"], not cfg["dist_alpha"], cfg["dist_alpha"],
        cfg["white_background"], S)
    return rgb_values[:N], dist_pred[:N, 0], alpha[:N]


def _render_outputs(cfg, eval_mode, valid_mask, dists, z_val, alpha,
                    rgb_values, dist_pred, camera_world, ray_vector, ray_norm,
                    d_i_gt, sample_option):
    """Shared tail: eval-time dist -> depth, NDC prior depth, output dict."""
    points_surface = camera_world[None] + ray_vector * dists[..., None]
    if eval_mode and cfg["normalise_ray"]:
        dist_pred = dist_pred / ray_norm
        d_i_gt = d_i_gt / ray_norm
    depth_gt = d_i_gt
    if sample_option == "ndc":
        depth_gt = 1.0 - 1.0 / torch.where(depth_gt == 0,
                                           torch.ones_like(depth_gt), depth_gt)
        depth_gt = torch.where(valid_mask > 0, depth_gt,
                               torch.zeros_like(depth_gt))
    return {
        "rgb": rgb_values,
        "depth_pred": dist_pred,
        "depth_gt": depth_gt,
        "valid_mask": valid_mask,
        "z_vals": z_val,
        "alpha": alpha,
        "normal_diff": None,
        "points_surface": points_surface,
    }
