"""SSIM, both variants of the reference (port of ``nope_nerf_tpu/ops/ssim.py``).

* :func:`ssim` -- the evaluation SSIM: 11x11 Gaussian window (sigma 1.5),
  per-channel (depthwise) convolution with zero same-padding, scalar mean.
* :func:`ssim_loss_map` -- the 3x3 mean-pool SSIM of the photometric loss:
  reflection pad 1, elementwise clamp((1 - SSIM) / 2, 0, 1).

Images are (H, W, C) f32 in [0, 1], as in the JAX package. The
convolutions and their input gradients run with TF32 off: in reduced
precision E[x^2] - mu^2 errs by about 1e-3, more than C2 = 9e-4, so on
near-constant images the window denominators turn negative and the mean
leaves [-1, 1].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import no_tf32

C1, C2 = 0.01**2, 0.03**2


class _DepthwiseConv(torch.autograd.Function):
    """Grouped ``F.conv2d`` of an NCHW image with a constant (C, 1, k, k)
    kernel, forward and input gradient both in full f32: the backward runs
    after the caller's ``no_tf32`` block has closed, so it scopes TF32 off
    itself (a training loss with ``with_ssim`` differentiates the map)."""

    @staticmethod
    def forward(ctx, x, k, pad):
        ctx.save_for_backward(k)
        ctx.shape, ctx.pad = x.shape, pad
        with no_tf32():
            return F.conv2d(x, k, padding=pad, groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        (k,) = ctx.saved_tensors
        with no_tf32():
            gx = torch.nn.grad.conv2d_input(ctx.shape, k, g, padding=ctx.pad,
                                            groups=ctx.shape[1])
        return gx, None, None


def _depthwise(x, kernel, pad):
    """(H, W, C) image convolved per channel with ``kernel`` (k, k)."""
    C = x.shape[-1]
    k = kernel.to(x)[None, None].expand(C, 1, *kernel.shape).contiguous()
    out = _DepthwiseConv.apply(x.permute(2, 0, 1)[None], k, pad)
    return out[0].permute(1, 2, 0)


def _gaussian_window(size=11, sigma=1.5):
    g = torch.exp(-((torch.arange(size, dtype=torch.float32) - size // 2)
                    ** 2) / (2.0 * sigma**2))
    g = g / g.sum()
    return g[:, None] @ g[None, :]


def ssim(img1, img2, window_size: int = 11):
    """Scalar SSIM between (H, W, C) images (pytorch_ssim semantics)."""
    win = _gaussian_window(window_size)
    pad = window_size // 2

    def conv(x):
        return _depthwise(x, win, pad)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu12
    m = (((2 * mu12 + C1) * (2 * s12 + C2))
         / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)))
    return m.mean()


def reflect_pad1(a):
    """(H, W, C) -> (H + 2, W + 2, C): reflection padding by one pixel (the
    edge is not repeated), bitwise ``F.pad(..., mode="reflect")``. Built
    from slices and concatenations, whose backward adds each reflected
    pixel's two gradients in one fixed order: on CUDA the backward of
    ``F.pad``'s reflect mode adds them with atomics, in an order that
    changes from run to run."""
    a = torch.cat([a[1:2], a, a[-2:-1]], dim=0)
    return torch.cat([a[:, 1:2], a, a[:, -2:-1]], dim=1)


def ssim_loss_map(x, y, c1=C1, c2=C2):
    """Elementwise SSIM-loss map for (H, W, C) images in [0, 1]."""
    # made on the images' device: a copy from host memory cannot be
    # captured into a CUDA graph of the step
    box = torch.full((3, 3), 1.0 / 9.0, device=x.device)

    def pool(a):
        return _depthwise(a, box, 0)

    x, y = reflect_pad1(x), reflect_pad1(y)
    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x**2
    sigma_y = pool(y * y) - mu_y**2
    sigma_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    d = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1.0 - n / d) / 2.0, 0.0, 1.0)
