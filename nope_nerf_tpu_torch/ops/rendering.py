"""Differentiable volume renderer (port of ``nope_nerf_tpu/ops/rendering.py``).

Two field paths, chosen by the render config:

* fused (``use_pallas_mlp`` and ``fuse_compositing``): point expansion,
  encodings, MLP, head activations and compositing in Kernel A
  (:func:`..ops.kernels.mlp_kernel.fused_mlp_composite`), per-ray tensors
  in and out;
* unfused: :func:`..models.nerf.apply_nerf` on the (N*S, 3) points (in
  Kernel C with ``use_pallas_mlp``, else plain ``torch.matmul``), then
  :func:`composite` -- the oracle of the fused path.

Semantics kept from the JAX package: eps 1e-6 in the transmittance cumprod,
delta_far 1e10 and alpha[:, -1] = 1 in dist_alpha mode, white-background
compositing, the NDC ``1 - 1/d`` prior-depth conversion and the eval-time
dist -> depth division. Invalid rays (zero or non-finite prior depth) stay in
the batch and are masked by ``valid_mask``.

Under a ray mesh (``cfg["mesh"]``, ``parallel/mesh.py``) a ray batch is
whole on every rank and each rank renders its contiguous block of it through
the same kernels; :func:`render_image` gathers the ranks' blocks into the
whole image.
"""
from __future__ import annotations

import torch

from .. import tracing
from ..geometry.rays import (
    arange_pixels,
    get_ndc_rays_fxfy,
    image_points_to_world,
    origin_to_world,
    to_world_transform,
    transform_to_world,
)
from ..parallel.mesh import gather_rays, shard_rays

EPS = 1e-6


def stratified_zvals(z_val, noise):
    """Jitter z values within their bins by ``noise`` ~ U[0, 1) of z's
    shape (drawn by the caller from its generator)."""
    mid = 0.5 * (z_val[..., 1:] + z_val[..., :-1])
    hi = torch.cat([mid, z_val[..., -1:]], dim=-1)
    lo = torch.cat([z_val[..., :1], mid], dim=-1)
    return lo + (hi - lo) * noise


class _CumprodNonzero(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of a tensor with no zero entry.
    torch's backward first asks the host whether the input holds a zero, a
    synchronisation that a CUDA graph of the step cannot capture; this one
    runs torch's formula for that case (the reversed cumulative sum of
    output * grad over the input) without asking."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return (y * g).flip(-1).cumsum(-1).flip(-1) / x


def composite(rgb, alpha, z_val, white_background=False):
    """rgb (N, S, 3), alpha (N, S), z (N, S) -> (rgb_values (N, 3),
    dist_pred (N,), weights (N, S)); weights = alpha * exclusive cumprod of
    (1 - alpha + 1e-6), whose factors are at least 1e-6 for alpha in
    [0, 1]."""
    trans = _CumprodNonzero.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + EPS],
                  -1))[..., :-1]
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


def ray_setup(pixels, depth_prior, camera_mat, world_mat, scale_mat, cfg, *,
              generator=None, add_noise=False):
    """The per-frame half of :func:`render_rays`: one frame's rays in world
    space, their prior depths and their z values.

    pixels (N, 2) in [-1, 1]; depth_prior (N,); camera/world/scale (4, 4).
    ``generator`` draws the stratified jitter when ``add_noise``. Returns a
    dict of per-ray tensors, each with N rows: origins, rays_in, dirs (the
    field's inputs), z_vals (N, S), valid_mask, dists, camera_world,
    ray_vector, ray_norm, d_i_gt. Several frames' dicts concatenate row by
    row (:func:`concat_rays`) into one batch for :func:`render_ray_batch`.
    """
    S = cfg["num_points"] - cfg.get("outside_steps", 0)
    N = pixels.shape[0]
    dev = pixels.device
    near, far = cfg["depth_range"]

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

    camera_world = camera_world[None].expand(N, 3)
    z_val = torch.linspace(0.0, 1.0, S, dtype=torch.float32,
                           device=dev).expand(N, S)
    if cfg["sample_option"] == "ndc":
        focal = torch.stack([camera_mat[0, 0], camera_mat[1, 1]])
        origins, rays_in = get_ndc_rays_fxfy(focal, 1.0, camera_world,
                                             ray_vector)
    else:
        z_val = near * (1.0 - z_val) + far * z_val
        if add_noise:
            noise = torch.rand(z_val.shape, generator=generator,
                               dtype=torch.float32, device=dev)
            z_val = stratified_zvals(z_val, noise)
        origins, rays_in = camera_world, ray_vector

    dirs = -ray_vector
    if not cfg["use_ray_dir"]:
        dirs = torch.ones_like(dirs)
    return {"origins": origins, "rays_in": rays_in, "dirs": dirs,
            "z_vals": z_val, "valid_mask": valid_mask, "dists": dists,
            "camera_world": camera_world, "ray_vector": ray_vector,
            "ray_norm": ray_norm, "d_i_gt": d_i_gt}


def concat_rays(setups):
    """Several :func:`ray_setup` dicts as one ray batch, row by row."""
    return {k: torch.cat([s[k] for s in setups]) for k in setups[0]}


def render_rays(nerf_params, pixels, depth_prior, camera_mat, world_mat,
                scale_mat, cfg, *, generator=None, add_noise=False,
                eval_mode=False):
    """Render a batch of rays of one frame: :func:`ray_setup`, then
    :func:`render_ray_batch`.

    pixels (N, 2) in [-1, 1]; depth_prior (N,); camera/world/scale (4, 4);
    ``cfg`` is the merged render config (:func:`..training.trainer.
    make_render_cfg`). ``generator`` (on the tensors' device) draws the
    stratified jitter when ``add_noise`` and the normal term's neighbours.
    Returns a dict with rgb (N, 3), depth_pred, depth_gt, valid_mask (N,),
    z_vals, alpha (N, S), normal_diff ((N,) with ``normal_loss`` outside
    eval, else None) and points_surface (N, 3).
    """
    rays = ray_setup(pixels, depth_prior, camera_mat, world_mat, scale_mat,
                     cfg, generator=generator, add_noise=add_noise)
    tracing.section("step.field")
    return render_ray_batch(nerf_params, rays, cfg, generator=generator,
                            eval_mode=eval_mode)


def render_ray_batch(nerf_params, rays, cfg, *, generator=None,
                     eval_mode=False):
    """Render a ray batch of :func:`ray_setup` or :func:`concat_rays`. Each
    ray carries its own origin, so the rays of several frames go through
    one field evaluation: one Kernel A launch on the fused path, up to
    ``n_max_network_queries`` points. Under ``cfg["mesh"]`` each rank
    renders its block of the rays (:func:`..parallel.mesh.shard_rays`), and
    every output holds those rows."""
    S = cfg["num_points"] - cfg.get("outside_steps", 0)
    mesh, jitter = cfg.get("mesh"), None
    if mesh is not None:
        if cfg.get("normal_loss", False) and not eval_mode:
            # drawn for the whole batch, so every rank's generator stays in
            # step
            jitter = shard_rays(normal_jitter(
                (rays["origins"].shape[0], 3), generator,
                rays["origins"].device), mesh)
        rays = {k: shard_rays(v, mesh) for k, v in rays.items()}
    origins, rays_in, dirs = rays["origins"], rays["rays_in"], rays["dirs"]
    z_val = rays["z_vals"]
    N = origins.shape[0]
    n_max = cfg.get("n_max_network_queries") or N * S
    if cfg.get("use_pallas_mlp", False) and cfg.get("fuse_compositing", False):
        # fused path, chunked over RAYS to honour n_max_network_queries
        rays_chunk = max(n_max // S, 1)
        outs = [
            _render_fused_composite(
                nerf_params, origins[i:i + rays_chunk],
                rays_in[i:i + rays_chunk], dirs[i:i + rays_chunk],
                z_val[i:i + rays_chunk], cfg, S)
            for i in range(0, N, rays_chunk)
        ]
        rgb_values, dist_pred, alpha = (torch.cat(o, 0) for o in zip(*outs))
    else:
        from ..models.nerf import apply_nerf

        pts = (origins[:, None, :] + rays_in[:, None, :] * z_val[..., None])
        pts = pts.reshape(-1, 3)
        dirs = dirs[:, None, :].expand(N, S, 3).reshape(-1, 3)
        if cfg.get("use_pallas_mlp", False):
            # Kernel C pads each chunk to a multiple of BM points: chunks
            # of whole BMs keep the padded batch within the bound (or at
            # one BM when the bound is smaller)
            from .kernels.mlp_kernel import BM

            n_max = max(n_max // BM, 1) * BM
        chunks = [apply_nerf(nerf_params, pts[i:i + n_max], dirs[i:i + n_max],
                             cfg)
                  for i in range(0, N * S, n_max)]
        rgb = torch.cat([c[0] for c in chunks]).reshape(N, S, 3)
        alpha = torch.cat([c[1] for c in chunks]).reshape(N, S)
        if cfg["dist_alpha"]:
            alpha = dist_to_alpha(alpha, z_val)
        rgb_values, dist_pred, _ = composite(rgb, alpha, z_val,
                                             cfg["white_background"])
    return _render_outputs(nerf_params, cfg, eval_mode, rays, alpha,
                           rgb_values, dist_pred, generator, jitter)


def render_image(nerf_params, resolution, camera_mat, world_mat, scale_mat,
                 cfg, chunk: int = 16384, mesh=None):
    """Full-image eval render: the (h * w) pixels in chunks of ``chunk``
    rays (the last one padded), each through ``render_rays(eval_mode=True,
    add_noise=False)`` without autograd. Returns (rgb (h, w, 3), depth
    (h, w)) on the matrices' device.

    Routing as in the JAX package: a fused config renders through Kernel A's
    forward; ``use_pallas_mlp`` without ``fuse_compositing`` drops to the
    plain MLP, since Kernel C pays off only in the backward.

    With ``mesh`` (``chunk`` a multiple of its size) each rank renders its
    block of every chunk, and the blocks are gathered, so every rank
    returns the whole image.
    """
    h, w = resolution
    n = h * w
    chunk = min(chunk, n)
    if mesh is not None:
        if chunk % mesh.size:
            raise ValueError("chunk must divide evenly over mesh devices")
        cfg = dict(cfg, mesh=mesh)
    if cfg.get("use_pallas_mlp", False) and not cfg.get("fuse_compositing",
                                                        False):
        cfg = dict(cfg, use_pallas_mlp=False)
    dev = camera_mat.device
    _, pixels = arange_pixels((h, w), device=dev)
    pixels = torch.cat([pixels, pixels.new_zeros(((-n) % chunk, 2))])
    depth = torch.ones(pixels.shape[0], dtype=torch.float32, device=dev)
    rgbs, depths = [], []
    with torch.no_grad():
        for i in range(0, pixels.shape[0], chunk):
            out = render_rays(nerf_params, pixels[i:i + chunk],
                              depth[i:i + chunk], camera_mat, world_mat,
                              scale_mat, cfg, add_noise=False, eval_mode=True)
            rgbs.append(gather_rays(out["rgb"], chunk, mesh))
            depths.append(gather_rays(out["depth_pred"], chunk, mesh))
    rgb = torch.cat(rgbs)[:n].reshape(h, w, 3)
    return rgb, torch.cat(depths)[:n].reshape(h, w)


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


def normal_jitter(shape, generator, device):
    """U[0, 1) draws of the normal term's neighbour offsets."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


def normal_diff(nerf_params, points_surface, jitter, cfg):
    """||n(p) - n(p + (jitter - 0.5) * 0.01)|| per point, n the density
    gradient of :func:`..models.nerf.density_gradient` normalised with
    + 1e-5. Both point sets go through one gradient call, which keeps the
    graph to the weights and to ``points_surface`` under grad mode."""
    from ..models.nerf import density_gradient

    N = points_surface.shape[0]
    neigh = points_surface + (jitter - 0.5) * 0.01
    g = density_gradient(nerf_params,
                         torch.cat([points_surface, neigh], dim=0),
                         cfg["pos_enc_levels"])
    normals = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-5)
    return torch.linalg.vector_norm(normals[:N] - normals[N:], dim=-1)


def _render_outputs(nerf_params, cfg, eval_mode, rays, alpha, rgb_values,
                    dist_pred, generator, jitter=None):
    """Shared tail: the normal term (its neighbour ``jitter`` drawn here
    unless given), eval-time dist -> depth, NDC prior depth, output
    dict."""
    valid_mask, ray_norm = rays["valid_mask"], rays["ray_norm"]
    d_i_gt = rays["d_i_gt"]
    points_surface = (rays["camera_world"]
                      + rays["ray_vector"] * rays["dists"][..., None])
    n_diff = None
    if cfg.get("normal_loss", False) and not eval_mode:
        # surface-normal smoothness at the prior-depth surface points and
        # neighbours jittered in a 0.01 cube; invalid rays are the caller's
        # to mask with valid_mask
        if jitter is None:
            jitter = normal_jitter(points_surface.shape, generator,
                                   points_surface.device)
        n_diff = normal_diff(nerf_params, points_surface, jitter, cfg)
    if eval_mode and cfg["normalise_ray"]:
        dist_pred = dist_pred / ray_norm
        d_i_gt = d_i_gt / ray_norm
    depth_gt = d_i_gt
    if cfg["sample_option"] == "ndc":
        depth_gt = 1.0 - 1.0 / torch.where(depth_gt == 0,
                                           torch.ones_like(depth_gt), depth_gt)
        depth_gt = torch.where(valid_mask > 0, depth_gt,
                               torch.zeros_like(depth_gt))
    return {
        "rgb": rgb_values,
        "depth_pred": dist_pred,
        "depth_gt": depth_gt,
        "valid_mask": valid_mask,
        "z_vals": rays["z_vals"],
        "alpha": alpha,
        "normal_diff": n_diff,
        "points_surface": points_surface,
    }
