"""The device an entry point runs on."""
from __future__ import annotations

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
