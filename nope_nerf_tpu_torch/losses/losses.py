"""Training losses (port of ``nope_nerf_tpu/losses/losses.py``): pure,
mask-weighted terms and their weighted sum. The l1 / l2 rgb switch is the
(w_l1, w_l2) pair, both terms computed, as in the JAX package.

Under a ray mesh (``parallel/mesh.py``) the per-ray inputs are this rank's
rows and every term is global: sums and masked means all-reduce their
numerators and denominators, the invariant depth loss gathers the whole ray
set for its medians, and the Chamfer term runs the sharded Kernels B / D.
With one rank each term is bitwise the unsharded one."""
from __future__ import annotations

import torch

from ..ops.chamfer import (
    chamfer_loss,
    chamfer_loss_window,
    resolve_chamfer_mode,
)
from ..ops.ssim import ssim_loss_map
from ..parallel.mesh import gather_rays, mesh_mean, mesh_sums


def mse2psnr(mse):
    """-10 log10(max(mse, 1e-10)) for a float or tensor."""
    mse = torch.clamp_min(torch.as_tensor(mse, dtype=torch.float32), 1e-10)
    return -10.0 * torch.log10(mse)


def rgb_full_loss(rgb_pred, rgb_gt, w_l1, w_l2, mesh=None, n=None):
    """w_l1 * sum|d|/N + w_l2 * sum d^2/N over the (N, 3) block (``n``
    global rays under ``mesh``)."""
    n = rgb_pred.shape[0] if n is None else n
    d = rgb_pred - rgb_gt
    l1, l2 = mesh_sums((torch.sum(torch.abs(d)), torch.sum(d * d)), mesh)
    return w_l1 * (l1 / n) + w_l2 * (l2 / n)


def depth_loss_l1(depth_pred, depth_gt, valid_mask, mesh=None):
    """sum(|d| m) / max(sum(m), 1)."""
    num, den = mesh_sums((torch.sum(torch.abs(depth_pred - depth_gt)
                                    * valid_mask), torch.sum(valid_mask)),
                         mesh)
    return num / torch.clamp_min(den, 1.0)


def _torch_median(x):
    """The lower of the two middle values for even lengths (the reference's
    torch.median, which the JAX package emulates)."""
    return torch.median(x.reshape(-1))


def depth_loss_dpt(pred_depth, gt_depth, weight=None):
    """Scale/shift-invariant depth loss: median-centred, mean-abs-scaled
    maps, then (weighted) MSE."""
    t_pred = _torch_median(pred_depth)
    s_pred = torch.mean(torch.abs(pred_depth - t_pred))
    t_gt = _torch_median(gt_depth)
    s_gt = torch.mean(torch.abs(gt_depth - t_gt))
    sq = ((pred_depth - t_pred) / s_pred - (gt_depth - t_gt) / s_gt) ** 2
    if weight is not None:
        return torch.sum(sq * weight) / (torch.sum(weight) + 1e-8)
    return torch.mean(sq)


def dist_losses(t_list):
    """Pose-translation smoothness: (mean step length, mean squared change
    of the step length) over the (N, 3) translations."""
    dist = (t_list - torch.roll(t_list, shifts=1, dims=0))[1:]
    dist = torch.sqrt(torch.clamp_min(torch.sum(dist * dist, dim=1), 1e-24))
    dist_diff = (dist - torch.roll(dist, shifts=1))[1:]
    return torch.mean(dist), torch.mean(dist_diff ** 2)


def mean_on_mask(diff, valid_mask):
    """sum over masked elements / count; diff (..., C), mask (..., 1)."""
    mask = valid_mask.expand(diff.shape)
    return torch.sum(diff * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def rgb_s_loss(rgb1, rgb2, valid_points, with_ssim=False, rgb2_ori=None):
    """Surface photometric loss on (h, w, 3) colours with an (h, w, 1) mask;
    ``rgb2_ori`` turns on the reference's auto-mask, which reads the raw
    diff before ``with_ssim`` blends it with the 3x3 SSIM loss map
    (0.15 diff + 0.85 map)."""
    diff = torch.clamp(torch.abs(rgb1 - rgb2), 0.0, 1.0)
    if rgb2_ori is not None:
        auto = (torch.mean(diff, dim=-1, keepdim=True)
                < torch.mean(torch.abs(rgb1 - rgb2_ori), dim=-1, keepdim=True))
        valid_points = auto.to(valid_points.dtype) * valid_points
    if with_ssim:
        diff = 0.15 * diff + 0.85 * ssim_loss_map(rgb1, rgb2)
    return mean_on_mask(diff, valid_points)


def chamfer_pc_loss(X, Y, *, use_kernel, mode="exact", starts=None,
                    band_tiles=8, window=512, auto_costs=(None, None),
                    mesh=None):
    """The pc term: Chamfer between X and Y in ``mode`` ('auto' resolved by
    the cloud sizes, whether band ``starts`` exist and, as in the JAX
    package, the mesh size when the kernels run sharded). Exact and band
    run Kernels D and B when ``use_kernel``, else their plain versions,
    under a ``mesh`` on the rank's query rows; grid is plain PyTorch (the
    JAX package runs it in XLA), whole on every rank."""
    mode = resolve_chamfer_mode(
        mode, X.shape[0], Y.shape[0],
        n_devices=mesh.size if mesh is not None else 1,
        sharded_exact=use_kernel and mesh is not None,
        hints_available=starts is not None, exact_ms_per_pair=auto_costs[0],
        grid_ms_per_point=auto_costs[1])
    if mode == "band":
        if starts is None:
            raise ValueError("chamfer_mode 'band' needs projection hints "
                             "(chamfer_starts)")
        from ..ops.kernels.chamfer_band import (chamfer_loss_banded,
                                                chamfer_loss_banded_sharded)

        if mesh is not None:
            return chamfer_loss_banded_sharded(
                X, Y, starts[0], starts[1], mesh, k_tiles=band_tiles,
                use_kernel=use_kernel)
        return chamfer_loss_banded(X, Y, starts[0], starts[1],
                                   k_tiles=band_tiles, use_kernel=use_kernel)
    if mode == "grid":
        return chamfer_loss_window(X, Y, window=window)
    if mesh is not None:
        from ..ops.kernels.chamfer_kernel import chamfer_loss_exact_sharded

        return chamfer_loss_exact_sharded(X, Y, mesh, use_kernel=use_kernel)
    if use_kernel:
        from ..ops.kernels.chamfer_kernel import chamfer_loss_exact

        return chamfer_loss_exact(X, Y)
    return chamfer_loss(X, Y)


def total_loss(weights, *, rgb_pred=None, rgb_gt=None, depth_pred=None,
               depth_gt=None, depth_valid=None, t_list=None, X=None, Y=None,
               rgb_pc1=None, rgb_pc1_proj=None, rgb_pc1_ori=None,
               valid_points=None, w_l1=1.0, w_l2=0.0, with_ssim=False,
               with_auto_mask=False, depth_loss_type="l1",
               use_pallas_chamfer=True, chamfer_mode="exact",
               chamfer_window=512, chamfer_starts=None, chamfer_band_tiles=8,
               chamfer_auto_costs=(None, None), mesh=None, n_rays=None):
    """Weighted sum of the seven terms; returns the JAX package's dict of
    scalars (loss, loss_rgb, loss_depth, l2_mean, loss_dist_1st,
    loss_dist_2nd, loss_pc, loss_rgb_s, loss_depth_consistency). The
    Chamfer arguments go to :func:`chamfer_pc_loss` (``use_pallas_chamfer``
    selects the kernels).

    Under ``mesh`` the per-ray arguments are this rank's block
    (:func:`..parallel.mesh.shard_rays`) of ``n_rays`` rays and every
    returned value is global."""
    ref = next(v for v in (rgb_pred, X, t_list, rgb_pc1) if v is not None)
    zero = torch.zeros((), dtype=torch.float32, device=ref.device)
    rgb_loss = (rgb_full_loss(rgb_pred, rgb_gt, w_l1, w_l2, mesh, n_rays)
                if rgb_pred is not None else zero)
    if depth_pred is None:
        depth_loss = zero
    elif depth_loss_type == "invariant":
        # the medians need the whole ray set
        depth_pred, depth_gt, depth_valid = (
            None if t is None else gather_rays(t, n_rays, mesh)
            for t in (depth_pred, depth_gt, depth_valid))
        depth_loss = depth_loss_dpt(depth_pred, depth_gt, depth_valid)
    else:
        depth_loss = depth_loss_l1(depth_pred, depth_gt, depth_valid, mesh)
    if t_list is not None:
        loss_dist_1st, loss_dist_2nd = dist_losses(t_list)
    else:
        loss_dist_1st = loss_dist_2nd = zero
    pc = zero
    if X is not None:
        pc = chamfer_pc_loss(X, Y, use_kernel=use_pallas_chamfer,
                             mode=chamfer_mode, starts=chamfer_starts,
                             band_tiles=chamfer_band_tiles,
                             window=chamfer_window,
                             auto_costs=chamfer_auto_costs, mesh=mesh)
    rgb_s = (rgb_s_loss(rgb_pc1, rgb_pc1_proj, valid_points, with_ssim,
                        rgb2_ori=rgb_pc1_ori if with_auto_mask else None)
             if rgb_pc1 is not None else zero)
    l2_mean = (mesh_mean((rgb_pred - rgb_gt) ** 2, mesh,
                         3 * (n_rays or rgb_pred.shape[0]))
               if rgb_pred is not None else zero)
    dc = zero  # depth consistency: rejected by config.check_supported
    loss = (weights["rgb_weight"] * rgb_loss
            + weights["depth_weight"] * depth_loss
            + weights["weight_dist_1st_loss"] * loss_dist_1st
            + weights["weight_dist_2nd_loss"] * loss_dist_2nd
            + weights["pc_weight"] * pc
            + weights["rgb_s_weight"] * rgb_s
            + weights["depth_consistency_weight"] * dc)
    return {
        "loss": loss,
        "loss_rgb": rgb_loss,
        "loss_depth": depth_loss,
        "l2_mean": l2_mean,
        "loss_dist_1st": loss_dist_1st,
        "loss_dist_2nd": loss_dist_2nd,
        "loss_pc": pc,
        "loss_rgb_s": rgb_s,
        "loss_depth_consistency": dc,
    }
