"""The device an entry point runs on, and the f32 precision scope."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda"):
    """``torch.device(device)``; raises when it names CUDA and there is no
    CUDA device. Nothing falls back to the CPU: ask for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"nope_nerf_tpu_torch: device {str(device)!r} asked for, but no "
            "CUDA device is available; pass device='cpu' (--device cpu) to "
            "run on the CPU")
    return dev


@contextlib.contextmanager
def no_tf32():
    """Convolutions and f32 matrix products in full f32 inside the block:
    ``cudnn.allow_tf32`` (on by default) and ``cuda.matmul.allow_tf32``
    off, both restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
