"""Image sampling / resizing with torch-compatible semantics (port of
``nope_nerf_tpu/ops/interp.py``), written as gathers so the index math is
exactly the JAX package's:

* :func:`grid_sample` -- bilinear / nearest point sampling of an (H, W, C)
  image at [-1, 1] coordinates, zero padding outside;
* :func:`resize_nearest` -- src = floor(dst * f32(in/out));
* :func:`resize_bilinear` -- half-pixel centres, edges clamped.
"""
from __future__ import annotations

import torch


def grid_sample(img, coords, mode="bilinear", align_corners=False):
    """Sample ``img`` (H, W, C) at ``coords`` (N, 2) [x, y] in [-1, 1];
    out-of-bounds taps contribute 0. Returns (N, C)."""
    H, W, C = img.shape
    x, y = coords[:, 0], coords[:, 1]
    if align_corners:
        fx = (x + 1.0) / 2.0 * (W - 1)
        fy = (y + 1.0) / 2.0 * (H - 1)
    else:
        fx = ((x + 1.0) * W - 1.0) / 2.0
        fy = ((y + 1.0) * H - 1.0) / 2.0

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return v, inb.to(img.dtype)

    if mode == "nearest":
        v, inb = tap(torch.floor(fy + 0.5).long(), torch.floor(fx + 0.5).long())
        return v * inb[:, None]

    x0f, y0f = torch.floor(fx), torch.floor(fy)
    x0, y0 = x0f.long(), y0f.long()
    wx1, wy1 = fx - x0f, fy - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    out = torch.zeros((coords.shape[0], C), dtype=img.dtype, device=img.device)
    for xi, wxi in ((x0, wx0), (x0 + 1, wx1)):
        for yi, wyi in ((y0, wy0), (y0 + 1, wy1)):
            v, inb = tap(yi, xi)
            out = out + v * (wxi * wyi * inb)[:, None]
    return out


def _nearest_src(n_out, n_in, device):
    """floor(dst * f32(n_in / n_out)) in f32, as the JAX package computes it
    (the integer form differs where the f32 product rounds across an
    integer)."""
    scale = torch.tensor(n_in / n_out, dtype=torch.float32)
    dst = torch.arange(n_out, dtype=torch.float32)
    return torch.floor(dst * scale).long().to(device)


def resize_nearest(img, out_hw):
    """Nearest resize: (H, W[, C]) -> (h, w[, C]); identity shapes pass."""
    H, W = img.shape[:2]
    h, w = out_hw
    if (H, W) == (h, w):
        return img
    ys = _nearest_src(h, H, img.device)
    xs = _nearest_src(w, W, img.device)
    return img.index_select(0, ys).index_select(1, xs)


def resize_bilinear(img, out_hw):
    """Bilinear resize, align_corners=False: (H, W, C) -> (h, w, C)."""
    H, W = img.shape[:2]
    h, w = out_hw
    dev = img.device
    fy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (H / h) - 0.5
    fx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (W / w) - 0.5
    y0f, x0f = torch.floor(fy), torch.floor(fx)
    wy1 = torch.clamp(fy - y0f, 0.0, 1.0)[:, None, None]
    wx1 = torch.clamp(fx - x0f, 0.0, 1.0)[None, :, None]
    y0 = torch.clamp(y0f.long(), 0, H - 1)
    x0 = torch.clamp(x0f.long(), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    v00 = img[y0[:, None], x0[None, :]]
    v01 = img[y0[:, None], x1[None, :]]
    v10 = img[y1[:, None], x0[None, :]]
    v11 = img[y1[:, None], x1[None, :]]
    return v00 * wy0 * wx0 + v01 * wy0 * wx1 + v10 * wy1 * wx0 + v11 * wy1 * wx1
