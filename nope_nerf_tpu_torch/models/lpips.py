"""LPIPS perceptual metric, VGG16 backbone (port of
``nope_nerf_tpu/models/lpips.py``).

The reference scores eval images with the ``lpips`` package (net='vgg',
normalize=True): VGG16 features at relu1_2, relu2_2, relu3_3, relu4_3 and
relu5_3, unit-normalised along channels, squared differences reduced by the
learned non-negative 1x1 heads, averaged over space and summed over taps.

Parameters are the JAX package's tree with PyTorch's layouts (OIHW convs,
heads (1, C); :func:`..convert.lpips_params_from_jax`); the npz on disk is
the JAX package's, written by ``convert_lpips``. Convolutions run in full
f32 (:func:`..device.no_tf32`), as the JAX module runs them at
``Precision.HIGHEST``. No kernel is ported: these are ``F.conv2d`` calls.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..convert import lpips_params_from_jax, tree_to
from ..device import no_tf32
from ..training.checkpoints import load_pytree

# VGG16 feature config: (out_channels, n_convs) per block
VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# the lpips ScalingLayer (after [0, 1] -> [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

DEFAULT_WEIGHTS = os.path.join(
    os.path.expanduser("~"), ".cache", "nope_nerf_tpu", "lpips_vgg.npz"
)


def vgg_features(params, x):
    """x (B, 3, H, W) in [-1, 1] -> the 5 tap activations (post-relu at the
    end of each block; VALID 2x2 max-pools between blocks floor odd
    sizes)."""
    shift = x.new_tensor(_SHIFT).view(1, 3, 1, 1)
    scale = x.new_tensor(_SCALE).view(1, 3, 1, 1)
    x = (x - shift) / scale
    taps, ci = [], 0
    for bi, (_, n) in enumerate(VGG_BLOCKS):
        for _ in range(n):
            p = params["convs"][ci]
            x = F.relu(F.conv2d(x, p["w"], p["b"], padding=1))
            ci += 1
        taps.append(x)
        if bi < len(VGG_BLOCKS) - 1:
            x = F.max_pool2d(x, 2)
    return taps


def _distance(params, img0, img1):
    """:func:`lpips_distance` under the caller's autograd and TF32
    settings."""
    x = torch.stack([img0, img1]).permute(0, 3, 1, 2) * 2.0 - 1.0
    total = 0.0
    for t, lin in zip(vgg_features(params, x), params["lins"]):
        n = t / torch.sqrt(torch.sum(t**2, dim=1, keepdim=True) + 1e-10)
        diff = (n[0] - n[1]) ** 2  # (C, h, w)
        w = torch.clamp_min(lin["w"], 0.0)  # (1, C)
        total = total + torch.mean(
            torch.matmul(w, diff.reshape(diff.shape[0], -1)))
    return total


def lpips_distance(params, img0, img1):
    """Scalar LPIPS between (H, W, 3) images in [0, 1] (tensors on the
    parameters' device), in full f32 and without autograd."""
    with torch.no_grad(), no_tf32():
        return _distance(params, img0, img1)


def load_lpips(path: str | None = None, device=None):
    """-> callable(img0, img1: (H, W, 3) [0, 1] numpy or tensors) -> float,
    run on ``device`` (None: the CPU). ``path`` None reads
    :data:`DEFAULT_WEIGHTS`; a missing file raises FileNotFoundError."""
    tree, _, _ = load_pytree(path or DEFAULT_WEIGHTS)
    params = lpips_params_from_jax(tree["params"], device)

    def metric(img0, img1):
        a, b = (torch.as_tensor(im, dtype=torch.float32, device=device)
                for im in (img0, img1))
        return float(lpips_distance(params, a, b))

    return metric


def init_lpips_params(generator, device=None):
    """Random parameters in the port's layout (the JAX package's init laws:
    N(0, 0.05) convs, zero biases, heads 1/C); shape tests and smoke runs
    only: real use needs converted weights."""
    convs, cin = [], 3
    for cout, n in VGG_BLOCKS:
        for _ in range(n):
            convs.append({"w": torch.randn((cout, cin, 3, 3),
                                           generator=generator) * 0.05,
                          "b": torch.zeros(cout)})
            cin = cout
    lins = [{"w": torch.ones((1, c)) / c} for c, _ in VGG_BLOCKS]
    params = {"convs": convs, "lins": lins}
    return params if device is None else tree_to(params, device)
