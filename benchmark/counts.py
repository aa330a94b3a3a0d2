"""The yardstick: published peaks of one H100 and the work of each measured
function, counted from the configuration's shapes alone.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity): 989 TFLOP/s
bf16 on the tensor cores, 3.35 TB/s of HBM3, and 33.5 T FP32 lane
instructions/s (67 TFLOP/s FP32 counted as FMA pairs, 2 FLOPs each). They
hold at the card's full 700 W; the run prints the card's power limit beside
them.

Counts never read a kernel or what an implementation saves: a function's
bytes are its own inputs and outputs read or written once, its FLOPs the
model's.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_FP32_INSTR = 33.5e12

# FP32 instructions per (query, candidate) pair of the banded argmin:
# 3 subtractions, 3 multiplications, 2 additions and one running minimum
BAND_PAIR_INSTR = 9

F32 = 4


def mlp_flops_per_point(model_cfg):
    """2 * sum(fan_in * fan_out) over the field's layers: 2 * 593,408 for
    the 8x256 skip MLP with 63-wide position and 27-wide direction
    encodings."""
    d = model_cfg["hidden_dim"]
    pos = (2 * model_cfg["pos_enc_levels"] + 1) * 3
    dirs = (2 * model_cfg["dir_enc_levels"] + 1) * 3
    kn = (pos * d + 3 * d * d            # trunk before the skip
          + (d + pos) * d + 3 * d * d    # the skip layer and after it
          + d * 1 + d * d                # density and feature heads
          + (d + dirs) * (d // 2) + (d // 2) * 3)  # direction layer, rgb
    return 2 * kn


def n_weights(model_cfg):
    """Weights and biases of the field."""
    d = model_cfg["hidden_dim"]
    pos = (2 * model_cfg["pos_enc_levels"] + 1) * 3
    dirs = (2 * model_cfg["dir_enc_levels"] + 1) * 3
    layers = ([(pos, d)] + [(d, d)] * 3 + [(d + pos, d)] + [(d, d)] * 3
              + [(d, 1), (d, d), (d + dirs, d // 2), (d // 2, 3)])
    return sum(i * o + o for i, o in layers)


# passes over the MLP that the model needs: a forward; its input gradient;
# its weight gradient
PASSES = {"train": 3, "pose_opt": 2, "render": 1}


def mlp_flops(model_cfg, points, phase):
    """Model FLOPs of ``points`` field evaluations in ``phase``."""
    return PASSES[phase] * mlp_flops_per_point(model_cfg) * points


def mlp_bytes(model_cfg, rays, samples, phase):
    """Bytes of Kernel A's function in ``phase``, each read or written
    once: per-ray origins, directions and view directions (3 f32 each), z
    values and deltas (S f32 each), the weights; the outputs rgb (3), the
    distance (1) and alpha (S); in a backward the cotangents of rgb and the
    distance, the three per-ray input gradients and, in training, the
    weight gradients."""
    w = n_weights(model_cfg) * F32
    inputs = rays * (9 + 2 * samples) * F32 + w
    outputs = rays * (4 + samples) * F32
    total = inputs + outputs
    if phase in ("train", "pose_opt"):
        total += rays * 4 * F32 + rays * 9 * F32
    if phase == "train":
        total += w
    return total


def mlp_least_seconds(model_cfg, rays, samples, phase):
    """The least time of Kernel A's function: the larger of its FLOPs at
    the bf16 peak and its bytes at the HBM rate."""
    return max(mlp_flops(model_cfg, rays * samples, phase) / PEAK_BF16_FLOPS,
               mlp_bytes(model_cfg, rays, samples, phase) / PEAK_HBM_BYTES)


def band_least_seconds(pairs):
    """The least time of the banded argmin over ``pairs`` pairs: FP32 issue
    (its bytes, a few hundred KB, take under 0.2 us)."""
    return pairs * BAND_PAIR_INSTR / PEAK_FP32_INSTR
