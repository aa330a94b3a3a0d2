"""Sinusoidal positional encoding (port of ``nope_nerf_tpu/ops/encoding.py``)."""
from __future__ import annotations

import torch


def encode_position(x: torch.Tensor, levels: int, inc_input: bool = True) -> torch.Tensor:
    """Encode each scalar with L sin/cos pairs at frequencies 2^0 .. 2^(L-1).

    x (..., C) -> (..., C*(2L+1)) if inc_input else (..., C*2L), channel
    order [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...], each
    block spanning all C channels.
    """
    if levels == 0:
        return x
    freqs = 2.0 ** torch.arange(levels, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                      # (..., L, C)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., L, 2, C)
    enc = enc.reshape(x.shape[:-1] + (2 * levels * x.shape[-1],))
    if inc_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
