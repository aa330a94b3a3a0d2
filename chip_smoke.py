#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nope_nerf_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --gate-control   # the PSNR gate's control only

Builds the port's CUDA kernels from ``nope_nerf_tpu_torch/csrc``, holds each
of the six kernels against its plain PyTorch version at the shapes of the
training step (A: fused MLP + compositing, fwd and bwd; B: banded Chamfer;
C: per-point fused MLP, fwd and bwd; D: exact Chamfer), runs the GEMM phase
(the forward's TMA + wgmma layer GEMM of ``csrc/mlp_gemm_sm90.cu``, which
A-fwd and C-fwd run on, at four layer shapes at M = 131,072: its error
against ``gemm_fwd_reference`` in bf16 ulps, a bitwise rerun, and its time
beside the WMMA GEMM it replaced, ``torch.addmm`` in bf16 as the cuBLAS
yardstick, and the memory bound) and the backward GEMM phase (A-bwd's and
C-bwd's input-gradient GEMM ``gemm_dgrad`` at five shapes and their
weight-gradient GEMM ``gemm_wgrad`` at three, with Kernel A's per-ray
direction weight gradient, in the same file, at M = 131,072: error against
the plain versions, bitwise rerun, time beside the WMMA ``gemm_nn`` /
``gemm_tn`` they replaced, ``torch.mm`` in bf16 and the memory bound; the
two narrow heads' weight gradients beside them),
then trains three configurations at full width for two epochs of eight
steps each on an in-memory 8-frame 540x960 scene with random weights and a
smooth camera trajectory:

* stock ``configs/default.yaml`` (1024 rays x 128 samples, 8 x 256 MLP,
  pc + rgb_s losses, banded Chamfer): Kernels A and B, and Kernel C's
  forward for the surface colour of the Phong preview that the stock
  ``visualize_every`` draws at step 0;
* stock with ``tpu.fuse_compositing: False, chamfer_mode: exact``: Kernels
  C and D;
* ``tpu.parity: True`` (f32 unfused MLP on torch.matmul, exact Chamfer,
  randperm ray sampling): Kernel D;

and checks that each run went through every kernel it should reach (the
forward GEMM 11 times per forward, the input-gradient GEMM 12 times per
backward, the weight-gradient launches 14 times per backward that needs
them, the WMMA GEMM never). The
stock run writes its checkpoints and per-epoch pose metrics; the eval phase
then restores them into fresh tensors (bit for bit), runs the eval CLI's
``main`` on the held-out view (test-time pose optimisation on Kernel A's
input-only backward, the 540x960 render through Kernel A's forward, PSNR /
SSIM, PNGs and video), checks its launch counts (Kernel A both ways, no
weight-gradient launch, no other kernel), renders a 135x240 view through
Kernel A and through its plain version, holds the input-only backward
bitwise to the full one, and times the render and a pose-optimisation step
with each backward.

The synthetic phase then writes the teacher scene of
``utils/synthetic.py`` to disk with the port's dataset writer, trains the
stock widths on it through ``train()`` (the scene read back by
``get_scene``, gt poses fixed) with the visualisation and the
reprojection-pair dumps on, and requires the last epoch's PSNR to beat the
first's by SYN_PSNR_GAIN dB and its last SYN_TAIL epochs to average
SYN_PSNR_TAIL dB; checks the
``rendering/`` tree and the launch counts (Kernel A both ways, the Chamfer
kernel ``auto`` resolves to, and Kernel C's forward, which the Phong
preview's surface colour runs as the JAX package's fused MLP does); runs
the render CLI (interp, SYN_NOVEL views, the geo pass: Kernel A's forward
once per view at least), the ``vis_poses`` and ``eval_poses --vis`` CLIs
and a short run of the bench entry, whose JSON line it parses; holds the
Chamfer kernel against its plain version at the clouds of the training's
last step (identical indices), and Kernel C's forward at the surface points
of the render CLI's last view and of the visualisation's view (at Kernel
C's bars); and times a ``render_visdata`` call (its render and its Phong
part) and a novel view.

Prints, in order: the card's name and power limit, the kernel build time,
one line per kernel check, the two GEMM phases' lines, one line per epoch, the
eval phase's lines, the synthetic phase's lines, a JSON line with every
kernel's errors, launches, times and bound (and the library call's time
where one exists), and last ``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that last line. It needs a CUDA device and the
repository beside it; it imports nothing of JAX. With ``--gate-control``
it runs only the synthetic phase, with the field's weight-matrix gradients
zeroed (:func:`gate_control`), and exits 0 when the PSNR gate rejects it.
"""
import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# stock shapes of Kernel A (configs/default.yaml) and of the bench workload
N_RAYS, N_SAMPLES = 1024, 128
H, W, N_FRAMES = 540, 960, 8
EPOCHS = 2
# the eval phase: test-time pose optimisation epochs on the held-out view
# (the stock configs run 1000), its rays per step, and the side of the view
# that is rendered through Kernel A and its plain version
EVAL_POSE_EPOCHS, EVAL_POINTS = 5, 1024
SMALL_VIEW = (135, 240)
# the synthetic phase: the teacher scene (6 frames of 60x80 on disk, of which
# the loader holds frame 4 out: 5 training views), trained at the stock
# widths with gt poses fixed for SYN_EPOCHS epochs (200 steps); the
# visualisation and the pair dumps fire every SYN_VIS_EVERY steps (it 0 and
# 100); the render CLI renders SYN_NOVEL views; the bench runs short
SYN_FRAMES, SYN_HW, SYN_EPOCHS, SYN_VIS_EVERY = 6, (60, 80), 40, 100
SYN_NOVEL = 8
SYN_PSNR_GAIN = 1.0  # dB, tests/test_training.py::test_vanilla_nerf_converges
# The teacher's frames are nearly uniform (the first epoch reads ~32.7 dB),
# so a gain of 1 dB proves little: the mean PSNR of the last SYN_TAIL
# epochs must also reach SYN_PSNR_TAIL. On an H100 (700 W) the sound run
# reads 58.08 dB there (57.03-59.04; a dip to 52.2 dB mid-run), and a run
# with the field's weight-matrix gradients zeroed, which fits the biases
# alone, reads 51.48 (50.85-51.84): see PERF.md and ``--gate-control``.
SYN_TAIL, SYN_PSNR_TAIL = 10, 55.0
BENCH_SHORT = (16, 1, 2)  # steps per group, warm-up groups, timed groups

# Kernel A's bars against its plain version. tests/test_pallas.py holds the
# TPU kernel to rgb atol 0.03, density rtol 0.08 / atol 0.05 and gradients
# to relL2 0.02 (l.101-102, 163). Kernel and plain version here round the
# same operands the same way and differ only in f32 summation order;
# measured on an H100 (700 W) at these shapes and seeds: rgb 2.8e-5, dist
# 1.9e-6, alpha 5.7e-5, gradients relL2 <= 4.1e-3 (d_rays). The bars are
# tightened to leave a margin of 2.4x or more over those.
RGB_ATOL, DIST_ATOL, ALPHA_ATOL, GRAD_RELL2 = 1e-3, 1e-3, 1e-3, 1e-2
# Kernel C runs Kernel A's GEMM chain with the same rounding points, so it is
# held to the same bars (rgb and density max|err| RGB_ATOL / ALPHA_ATOL,
# gradients relL2 GRAD_RELL2) under the training step's cotangents: those of
# rgb and depth carried back through the plain compositing. Kernel C + the
# plain compositing against Kernel A: the JAX package holds its two paths to
# atol 2e-5 on rgb and alpha and 2e-4 on depth (tests/test_pallas.py:298-311).
C_VS_A_ATOL, C_VS_A_DIST_ATOL = 2e-5, 2e-4
# The forward GEMM against gemm_fwd_reference (the same bf16 operands, f32
# sums in another order): at most one bf16 ulp, judged at the magnitude of
# max(|ref|, |out|, max|ref| / 256) -- below that, a value is a cancellation
# whose f32 order error is set by the terms, not by the value.
GEMM_ULPS = 1.0

# the card's peaks (H100 SXM datasheet, at 700 W):
# dense bf16 tensor-core FLOP/s, memory bytes/s, FP32 lane instructions/s
BF16_FLOPS, HBM_BYTES, FP32_INSTR = 989e12, 3.35e12, 33.5e12
# FP32 instructions per point pair of the Chamfer argmins (3 sub, 3 mul,
# 2 add, compare and select; no FMA by design)
PAIR_INSTR = 10


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10, warmup=2):
    """Device time of ``fn`` in ms: the kernels' summed device time under
    ``torch.profiler`` over ``iters`` calls, after ``warmup`` calls. Unlike
    :func:`cuda_ms` it leaves out the host's gaps between launches, which on
    a host-bound call of ~50 us kernels are most of the events' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / iters / 1e3


def bound(flops=0.0, nbytes=0.0, instr=0.0):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``nbytes`` (each input read once, each output written once) over
    the memory rate and the operations over their peak (bf16 tensor-core
    FLOPs, FP32 lane instructions)."""
    t_ops = max(flops / BF16_FLOPS, instr / FP32_INSTR)
    t_mem = nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def mlp_bounds(weights, m, io):
    """Bounds of a forward and a full backward of the fused MLP on ``m``
    points: 2 m sum(K N) FLOPs forward, twice that backward (input- and
    weight-gradient GEMMs); ``io`` the function's other inputs and
    outputs (the backward also writes a gradient per weight)."""
    flops = 2.0 * m * sum(w.numel() for w in weights[0::2])
    wb = nbytes(*weights)
    return bound(flops, wb + io), bound(2 * flops, 2 * wb + io)


def mlp_bwd_floor(m, D, H2, n_pos, n_dir, div, weight_grads=True):
    """The layer-by-layer memory floor of the fused MLP's backward on ``m``
    points, ms at the memory rate: each launch of ``_chain_bwd`` reads its
    inputs once and writes its outputs once (bf16 cotangents and saved
    activations, f32 g_raw and encoding cotangents), with the compositing
    or head-activation backward (raw, the cotangents in, g_raw out) and the
    encoding backward (its f32 cotangents in); the weights, the split
    partials and the (m / div)-row 3-vectors are left out. ``div`` is the
    points per direction-encoding row (S in Kernel A, 1 in C)."""
    bf, f4 = 2.0, 4.0
    per_row = (
        3 * 4 * f4                                  # raw, cotangents, g_raw
        + 4 * f4 + 2 * H2 * bf                      # heads_bwd -> g_hr
        + (H2 * bf + D * bf) + (H2 * bf + n_dir * f4)  # rgb_layer dgrad
        + 3 * D * bf + f4                           # fc_feature + fc_density
        + 7 * 3 * D * bf                            # masked trunk layers
        + 2 * (D * bf + n_pos * f4)                 # the two encoding tails
        + (2 * n_pos + n_dir) * f4)                 # encoding backward
    if weight_grads:
        per_row += (
            (H2 * bf + 4 * f4) + (D * bf + 4 * f4)  # fc_rgb, fc_density
            + (D * bf + H2 * bf)                    # rgb_layer feat half
            + H2 * bf + n_dir * bf / div            # its direction half
            + 8 * 2 * D * bf                        # 256 x 256 weight GEMMs
            + 2 * (n_pos * bf + D * bf)             # trunk1_0 enc, trunk0_0
            + 4 * f4)                               # the heads' bias sums
    return 1e3 * m * per_row / HBM_BYTES


def rel_l2(a, b):
    import torch

    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp_min(torch.linalg.vector_norm(b), 1e-12))


def stock_cfg():
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config

    return load_config(DEFAULT_CONFIG)


def stock_mlp_inputs(dev):
    """Random weights (seed SEED) and a 1024-ray x 128-sample batch at the
    stock step's shapes: (cfg, weights, origins, rays, dirs, z, deltas, the
    numpy generator for the cotangents, a host-to-device helper)."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = stock_cfg()
    near, far = cfg["rendering"]["depth_range"]
    rng = np.random.default_rng(SEED)
    N, S = N_RAYS, N_SAMPLES
    params = init_nerf_params(torch.Generator().manual_seed(SEED), cfg, dev)
    weights = [t.requires_grad_() for t in mk.collect_weights(params)]
    rays = rng.normal(size=(N, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    zb = near + (far - near) * np.linspace(0.0, 1.0, S)
    z = np.sort(zb[None] + rng.uniform(0, (far - near) / S, size=(N, S)), 1)
    deltas = np.concatenate([np.diff(z, axis=1), np.full((N, 1), 1e10)], 1)

    def t(a, grad=False):
        x = torch.tensor(np.asarray(a, np.float32), device=dev)
        return x.requires_grad_() if grad else x

    origins = t(np.broadcast_to(rng.normal(scale=0.1, size=3), (N, 3)), True)
    return (cfg, weights, origins, t(rays, True), t(-rays, True), t(z),
            t(deltas), rng, t)


def check_kernel_a(dev, card):
    """Kernel A (fused MLP + compositing) against its plain version at the
    stock step's shapes: forward errors, backward relL2, both times."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
     t) = stock_mlp_inputs(dev)
    N, S = N_RAYS, N_SAMPLES
    # cotangents as the training loss gives them: rgb and depth are read,
    # alpha is not. (A random alpha cotangent on all 131k samples makes the
    # backward chaotic: two runs of the plain version whose matmul outputs
    # differ by 1e-7 relative then differ by 5e-3 relL2 in the trunk.)
    cots = (t(rng.normal(size=(N, 3)) / N), t(rng.normal(size=(N, 1)) / N),
            torch.zeros((N, S), device=dev))
    static = (cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"],
              cfg["model"]["occ_activation"], True, False, False, S)
    inputs = [origins, rays_t, dirs] + weights

    def fwd(fn):
        return fn(weights, origins, rays_t, dirs, z_t, deltas_t, *static)

    def grads(outs):
        return torch.autograd.grad(outs, inputs, cots, retain_graph=True)

    out_k, out_r = fwd(mk.fused_mlp_composite), fwd(
        mk.fused_mlp_composite_reference)
    g_k, g_r = grads(out_k), grads(out_r)
    torch.cuda.synchronize()

    o_k = [o.detach() for o in out_k]
    o_r = [o.detach() for o in out_r]
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "dist", "alpha"), o_k, o_r)}
    alpha_bad = int(torch.sum(torch.abs(o_k[2] - o_r[2]) > ALPHA_ATOL))
    names = ["d_origins", "d_rays", "d_dirs"] + [
        f"{n}/{k}" for n in mk.W_NAMES for k in ("w", "b")]
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, g_k, g_r)}
    bwd_abs = max(float(torch.max(torch.abs(a - b))) for a, b in zip(g_k, g_r))
    finite = all(bool(torch.isfinite(x).all()) for x in (*o_k, *g_k))

    ms_fwd = cuda_ms(lambda: fwd(mk.fused_mlp_composite))
    ms_fwd_plain = cuda_ms(lambda: fwd(mk.fused_mlp_composite_reference))
    ms_bwd = cuda_ms(lambda: grads(out_k))
    ms_bwd_plain = cuda_ms(lambda: grads(out_r))
    dev_bwd = device_ms(lambda: grads(out_k))
    floor = mlp_bwd_floor(N * S, *_mlp_widths(weights, static), div=S)
    print(f"kernel A fwd [{card}] N={N} S={S} D={cfg['model']['hidden_dim']}:"
          f" max|err| rgb={err['rgb']:.3e} dist={err['dist']:.3e}"
          f" alpha={err['alpha']:.3e} (alpha entries over bar: {alpha_bad});"
          f" kernel {ms_fwd:.3f} ms, plain {ms_fwd_plain:.3f} ms")
    worst = max(rels, key=rels.get)
    print(f"kernel A bwd [{card}]: relL2 max {rels[worst]:.3e} ({worst}); "
          + " ".join(f"{n}={v:.2e}" for n, v in rels.items())
          + f"; kernel {ms_bwd:.3f} ms (device {dev_bwd:.3f} ms), plain "
          f"{ms_bwd_plain:.3f} ms; layer-by-layer memory floor {floor:.3f} ms")
    fails = []
    if not finite:
        fails.append("non-finite kernel output")
    if err["rgb"] > RGB_ATOL:
        fails.append(f"rgb max|err| {err['rgb']:.3e} > {RGB_ATOL}")
    if err["dist"] > DIST_ATOL:
        fails.append(f"dist max|err| {err['dist']:.3e} > {DIST_ATOL}")
    if alpha_bad:
        fails.append(f"{alpha_bad} alpha entries outside atol {ALPHA_ATOL}")
    fails += [f"{n} relL2 {v:.3e} >= {GRAD_RELL2}"
              for n, v in rels.items() if not v < GRAD_RELL2]
    if fails:
        raise AssertionError("kernel A disagrees with its plain version: "
                             + "; ".join(fails))
    (b_fwd, by_fwd), (b_bwd, by_bwd) = mlp_bounds(
        weights, N * S, nbytes(origins, rays_t, dirs, z_t, deltas_t, *o_k))
    fwd_rec = {"name": "mlp_composite_fwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_composite.cu + "
                         "nope_nerf_tpu_torch/csrc/mlp_gemm_sm90.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:668",
               "max_abs_err": max(err.values()), "ms": ms_fwd,
               "plain_ms": ms_fwd_plain, "bound_ms": b_fwd,
               "bound_by": by_fwd, "library_ms": None}
    bwd_rec = {"name": "mlp_composite_bwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_composite.cu + "
                         "nope_nerf_tpu_torch/csrc/mlp_gemm_sm90.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:702",
               "max_abs_err": bwd_abs, "max_rel_l2": rels[worst],
               "ms": ms_bwd, "device_ms": dev_bwd, "plain_ms": ms_bwd_plain,
               "bound_ms": b_bwd, "bound_by": by_bwd, "library_ms": None,
               "floor_ms": floor}
    return fwd_rec, bwd_rec


def _mlp_widths(weights, static):
    """(D, H2, n_pos, n_dir) of the fused MLP's weights, ``static`` starting
    with the two encodings' levels."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    n_pos, n_dir, D, H2 = mk._dims(weights, static[0], static[1])
    return D, H2, n_pos, n_dir


def depth_pair(dev, hs, ws, seed):
    """Two noisy (hs x ws) depth maps of one smooth surface, backprojected
    and the first warped by a small rigid motion, as the pc loss pairs its
    clouds: (X, Y, camera matrix)."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.geometry.rays import (arange_pixels,
                                                   transform_to_world)
    from nope_nerf_tpu_torch.geometry.so3 import make_c2w

    rng = np.random.default_rng(seed)
    cam = torch.tensor([[1.6, 0, 0, 0], [0, -1.8, 0, 0], [0, 0, -1, 0],
                        [0, 0, 0, 1]], dtype=torch.float32, device=dev)
    _, pix = arange_pixels((hs, ws), device=dev)
    yy, xx = np.meshgrid(np.linspace(0, 1, hs), np.linspace(0, 1, ws),
                         indexing="ij")
    depth = 2.0 + 0.5 * np.sin(3 * xx) * np.cos(2 * yy)
    d1 = depth + 0.01 * rng.normal(size=depth.shape)
    d2 = depth + 0.01 * rng.normal(size=depth.shape)
    td = lambda a: torch.tensor(a.reshape(-1), dtype=torch.float32, device=dev)  # noqa: E731
    pc1 = transform_to_world(pix, td(d1), cam)
    pc2 = transform_to_world(pix, td(d2), cam)
    rel = make_c2w(torch.tensor([0.01, -0.02, 0.005], device=dev),
                   torch.tensor([0.02, 0.01, -0.03], device=dev))
    return pc1 @ rel[:3, :3].t() + rel[:3, 3], pc2, cam


def check_kernel_b(dev, card):
    """Kernel B (banded Chamfer argmin) against its plain version on a
    135x240 depth-map pair warped by a small rigid motion."""
    import torch

    from nope_nerf_tpu_torch.geometry.rays import project_to_cam
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    cfg = stock_cfg()
    ratio = cfg["training"]["pc_ratio"]
    hs, ws = int(H / ratio), int(W / ratio)
    X, Y, cam = depth_pair(dev, hs, ws, SEED + 1)
    k = max(2, round(cfg["tpu"]["chamfer_band_rows"] * ws / cb.TILE))
    n = hs * ws
    starts = cb.rows_to_start_tiles(X, n, (hs, ws), cam, project_to_cam, k)
    idx_k = cb.nearest_idx_banded(X, Y, starts, k)
    idx_r = cb.nearest_idx_banded_reference(X, Y, starts, k)
    torch.cuda.synchronize()
    mism = int(torch.sum(idx_k != idx_r))
    dk = torch.linalg.vector_norm(X - Y[idx_k.long()], dim=-1)
    dr = torch.linalg.vector_norm(X - Y[idx_r.long()], dim=-1)
    max_abs = float(torch.max(torch.abs(dk - dr)))
    ms = cuda_ms(lambda: cb.nearest_idx_banded(X, Y, starts, k), iters=20)
    ms_plain = cuda_ms(
        lambda: cb.nearest_idx_banded_reference(X, Y, starts, k), iters=5)
    print(f"kernel B [{card}] {n} x {n} points, k_tiles={k}: "
          f"{mism} index mismatches, max|err| of the matched distance "
          f"{max_abs:.3e}; kernel {ms:.3f} ms, plain {ms_plain:.3f} ms")
    if mism:
        raise AssertionError(f"kernel B: {mism} indices differ from its "
                             "plain version")
    # every query group scans k_tiles (at most Y's tiles) of TILE rows
    pairs = (-(-n // cb.QB) * cb.QB * min(k, -(-n // cb.TILE)) * cb.TILE)
    b_ms, b_by = bound(instr=PAIR_INSTR * pairs,
                       nbytes=nbytes(X, Y, starts, idx_k))
    return {"name": "chamfer_band", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/chamfer_band.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/chamfer_band.py:90",
            "max_abs_err": max_abs, "index_mismatches": mism, "ms": ms,
            "plain_ms": ms_plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def check_kernel_c(dev, card):
    """Kernel C (per-point fused MLP) against its plain version at the
    stock step's 131,072 points, under the training step's cotangents;
    then Kernel C + the plain compositing against Kernel A on the same
    rays."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.rendering import composite

    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
     t) = stock_mlp_inputs(dev)
    N, S = N_RAYS, N_SAMPLES
    l_pos, l_dir = cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"]
    act = cfg["model"]["occ_activation"]
    # the points and directions as the unfused renderer forms them
    pts = (origins[:, None, :] + rays_t[:, None, :] * z_t[..., None]).reshape(
        -1, 3).detach().requires_grad_()
    pdirs = dirs[:, None, :].expand(N, S, 3).reshape(-1, 3).detach(
    ).requires_grad_()
    inputs = [pts, pdirs] + weights

    def fwd(fn):
        return fn(weights, pts, pdirs, l_pos, l_dir, act, True)

    def render(out):
        rgbv, dist, _ = composite(out[0].reshape(N, S, 3),
                                  out[1].reshape(N, S), z_t)
        return rgbv, dist

    out_k, out_r = fwd(mk.fused_mlp), fwd(mk.fused_mlp_reference)
    # per-point cotangents of a loss that reads rgb and depth per ray
    cots = torch.autograd.grad(
        render(out_r), out_r,
        (t(rng.normal(size=(N, 3)) / N), t(rng.normal(size=(N,)) / N)),
        retain_graph=True)

    def grads(outs):
        return torch.autograd.grad(outs, inputs, cots, retain_graph=True)

    g_k, g_r = grads(out_k), grads(out_r)
    torch.cuda.synchronize()
    o_k = [o.detach() for o in out_k]
    o_r = [o.detach() for o in out_r]
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "density"), o_k, o_r)}
    names = ["d_pts", "d_dirs"] + [
        f"{n}/{k}" for n in mk.W_NAMES for k in ("w", "b")]
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, g_k, g_r)}
    bwd_abs = max(float(torch.max(torch.abs(a - b))) for a, b in zip(g_k, g_r))
    finite = all(bool(torch.isfinite(x).all()) for x in (*o_k, *g_k))

    ms_fwd = cuda_ms(lambda: fwd(mk.fused_mlp))
    ms_fwd_plain = cuda_ms(lambda: fwd(mk.fused_mlp_reference))
    ms_bwd = cuda_ms(lambda: grads(out_k))
    ms_bwd_plain = cuda_ms(lambda: grads(out_r))
    dev_bwd = device_ms(lambda: grads(out_k))
    floor = mlp_bwd_floor(N * S, *_mlp_widths(weights, (l_pos, l_dir)), div=1)

    # Kernel C + plain compositing against Kernel A at the same inputs
    with torch.no_grad():
        rgbv_a, dist_a, alpha_a = mk.fused_mlp_composite(
            weights, origins, rays_t, dirs, z_t, deltas_t, l_pos, l_dir,
            act, True, False, False, S)
        rgbv_c, dist_c = render(o_k)
    vs_a = {"rgb": float(torch.max(torch.abs(rgbv_c - rgbv_a))),
            "alpha": float(torch.max(torch.abs(o_k[1].reshape(N, S)
                                               - alpha_a))),
            "dist": float(torch.max(torch.abs(dist_c - dist_a[:, 0])))}

    print(f"kernel C fwd [{card}] M={N * S} D={cfg['model']['hidden_dim']}:"
          f" max|err| rgb={err['rgb']:.3e} density={err['density']:.3e};"
          f" kernel {ms_fwd:.3f} ms, plain {ms_fwd_plain:.3f} ms")
    worst = max(rels, key=rels.get)
    print(f"kernel C bwd [{card}]: relL2 max {rels[worst]:.3e} ({worst}); "
          + " ".join(f"{n}={v:.2e}" for n, v in rels.items())
          + f"; kernel {ms_bwd:.3f} ms (device {dev_bwd:.3f} ms), plain "
          f"{ms_bwd_plain:.3f} ms; layer-by-layer memory floor {floor:.3f} ms")
    print(f"kernel C + plain compositing vs kernel A [{card}]: max|err| "
          + " ".join(f"{n}={v:.3e}" for n, v in vs_a.items()))
    fails = []
    if not finite:
        fails.append("non-finite kernel output")
    if err["rgb"] > RGB_ATOL:
        fails.append(f"rgb max|err| {err['rgb']:.3e} > {RGB_ATOL}")
    if err["density"] > ALPHA_ATOL:
        fails.append(f"density max|err| {err['density']:.3e} > {ALPHA_ATOL}")
    fails += [f"{n} relL2 {v:.3e} >= {GRAD_RELL2}"
              for n, v in rels.items() if not v < GRAD_RELL2]
    for n, bar in (("rgb", C_VS_A_ATOL), ("alpha", C_VS_A_ATOL),
                   ("dist", C_VS_A_DIST_ATOL)):
        if not vs_a[n] <= bar:
            fails.append(f"{n} against kernel A {vs_a[n]:.3e} > {bar}")
    if fails:
        raise AssertionError("kernel C disagrees: " + "; ".join(fails))
    (b_fwd, by_fwd), (b_bwd, by_bwd) = mlp_bounds(
        weights, N * S, nbytes(pts, pdirs, *o_k))
    fwd_rec = {"name": "mlp_point_fwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_composite.cu + "
                         "nope_nerf_tpu_torch/csrc/mlp_gemm_sm90.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:244",
               "max_abs_err": max(err.values()),
               "max_abs_err_vs_kernel_a": max(vs_a.values()), "ms": ms_fwd,
               "plain_ms": ms_fwd_plain, "bound_ms": b_fwd,
               "bound_by": by_fwd, "library_ms": None}
    bwd_rec = {"name": "mlp_point_bwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_composite.cu + "
                         "nope_nerf_tpu_torch/csrc/mlp_gemm_sm90.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:258",
               "max_abs_err": bwd_abs, "max_rel_l2": rels[worst],
               "ms": ms_bwd, "device_ms": dev_bwd, "plain_ms": ms_bwd_plain,
               "bound_ms": b_bwd, "bound_by": by_bwd, "library_ms": None,
               "floor_ms": floor}
    return fwd_rec, bwd_rec


def check_kernel_d(dev, card):
    """Kernel D (exact Chamfer argmin, both directions) against its plain
    version on warped depth-map pairs of 135x240 (the stock pc_ratio) and
    270x480 points: identical indices required. Times the kernel, the plain
    version and the grid mode at both sizes, and prints the cost laws of
    ``chamfer_mode: auto`` they give."""
    import torch

    from nope_nerf_tpu_torch.ops import chamfer as ch
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck

    ratio = stock_cfg()["training"]["pc_ratio"]
    rows = []
    for r in (ratio, ratio / 2):
        hs, ws = int(H / r), int(W / r)
        n = hs * ws
        X, Y, _ = depth_pair(dev, hs, ws, SEED + 2)
        idx_k = ck.nearest_idx_exact(X, Y)
        idx_r = ck.nearest_idx_exact_reference(X, Y)
        loss_k = ck.chamfer_loss_exact(X, Y)
        loss_r = ch.chamfer_loss(X, Y)
        torch.cuda.synchronize()
        mism = sum(int(torch.sum(a != b)) for a, b in zip(idx_k, idx_r))
        loss_err = float(torch.abs(loss_k - loss_r))
        ms = cuda_ms(lambda: ck.nearest_idx_exact(X, Y), iters=10)
        ms_plain = cuda_ms(lambda: ck.nearest_idx_exact_reference(X, Y),
                           iters=2, warmup=1)
        ms_grid = cuda_ms(lambda: ch.nearest_idx_window(X, Y), iters=5)
        print(f"kernel D [{card}] {n} x {n} points: {mism} index mismatches,"
              f" |loss err| {loss_err:.3e}; kernel {ms:.3f} ms, plain "
              f"{ms_plain:.3f} ms; grid mode {ms_grid:.3f} ms")
        if mism:
            raise AssertionError(f"kernel D: {mism} indices differ from its "
                                 f"plain version at {n} points")
        rows.append((n, mism, loss_err, ms, ms_plain, ms_grid,
                     nbytes(X, Y, *idx_k)))
    per_pair = sum(row[3] / row[0] ** 2 for row in rows) / len(rows)
    per_point = sum(row[5] / (2 * row[0]) for row in rows) / len(rows)
    print(f"chamfer auto cost laws [{card}]: exact {per_pair:.3e} ms/pair, "
          f"grid {per_point:.3e} ms/point; equal clouds cross over at "
          f"{2 * per_point / per_pair:.0f} points")
    # both directions scan every pair
    (b_ms, b_by), (b_large, _) = (bound(instr=PAIR_INSTR * 2 * row[0] ** 2,
                                        nbytes=row[6]) for row in rows)
    n, mism, loss_err, ms, ms_plain, ms_grid, _ = rows[0]
    return {"name": "chamfer_exact", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/chamfer_exact.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/chamfer_kernel.py:87",
            "max_abs_err": loss_err, "index_mismatches": mism, "ms": ms,
            "plain_ms": ms_plain, "grid_ms": ms_grid, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "large": {"points": rows[1][0], "ms": rows[1][3],
                      "plain_ms": rows[1][4], "grid_ms": rows[1][5],
                      "bound_ms": b_large}}


# the forward's layer GEMMs timed in the GEMM phase: (layer, K1, K2, N,
# direction row term, ReLU) at the stock widths
GEMM_CASES = (
    ("trunk0_1", 256, 0, 256, False, True),
    ("trunk0_0", 63, 0, 256, False, True),
    ("trunk1_0", 256, 63, 256, False, True),
    ("rgb_layer", 256, 0, 128, True, True),
)


def gemm_ulps(out, ref):
    """max |out - ref| in bf16 ulps of max(|ref|, |out|, max|ref| / 256)
    (see GEMM_ULPS)."""
    import torch

    out, ref = out.float(), ref.float()
    mag = torch.maximum(torch.maximum(ref.abs(), out.abs()),
                        ref.abs().max() / 256)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(torch.max((out - ref).abs() / ulp))


def check_gemm(dev, card):
    """The GEMM phase (see the module docstring). Operands: the stock
    field's weights and biases (seed SEED), bf16 activations from a seeded
    normal, and encodings whose padding column holds NaN (the tensor maps
    take the true widths, so it must never be read)."""
    import torch

    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = stock_cfg()
    params = init_nerf_params(torch.Generator().manual_seed(SEED), cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    M, S = N_RAYS * N_SAMPLES, N_SAMPLES
    bf = torch.bfloat16

    def acts(rows, k):
        buf = torch.full((rows, mk._pad8(k)), float("nan"), dtype=bf,
                         device=dev)
        buf[:, :k] = torch.randn((rows, k), generator=gen, device=dev)
        return buf[:, :k]

    layers, chain_new, chain_old, chain_lib = {}, [], [], []
    for name, k1, k2, n, has_rt, relu in GEMM_CASES:
        w, b = params[name]["w"].detach(), params[name]["b"].detach()
        wt, wb = mk._padded_t(w), w.to(bf)
        a1 = acts(M, k1)
        a2 = acts(M, k2) if k2 else None
        two = dict(a2=a2, w2t=wt[:, k1:k1 + k2]) if k2 else {}
        rt, div, old_two, rt_err = None, 1, {}, None
        if has_rt:  # the direction half of [feat, denc], one row per ray
            denc = acts(N_RAYS, w.shape[0] - k1)
            rt = mk.gemm_fwd(denc, wt[:, k1:w.shape[0]], out=torch.empty(
                (N_RAYS, n), dtype=torch.float32, device=dev))
            div = S
            rt_err = float(torch.max(torch.abs(rt - mk.gemm_fwd_reference(
                denc.float(), w[k1:], out_dtype=torch.float32))))
            old_two = dict(a2=mk._Mat(denc, denc.shape[1], ld=denc.stride(0),
                                      row_div=S), b2=wb[k1:])
        elif k2:
            old_two = dict(a2=mk._Mat(a2, k2, ld=a2.stride(0)), b2=wb[k1:])
        out = torch.empty((M, n), dtype=bf, device=dev)
        out_old = torch.empty_like(out)

        def new(out=out, a1=a1, wt=wt, k1=k1, b=b, relu=relu, rt=rt, div=div,
                two=two):
            return mk.gemm_fwd(a1, wt[:, :k1], bias=b, relu=relu, rowterm=rt,
                               div=div, out=out, **two)

        def old(out=out_old, a1=a1, wb=wb, k1=k1, n=n, b=b, relu=relu,
                two=old_two):
            return mk._gemm_nn(mk._Mat(a1, k1, ld=a1.stride(0)), wb[:k1], M,
                               n, out, bias=b, relu=relu, **two)

        # cuBLAS on the same FLOPs (bias, no ReLU): [a1 | a2] @ W, or the
        # main product of rgb_layer (its row term has no cuBLAS form)
        a_lib = torch.cat([a1, a2], 1) if k2 else a1
        w_lib = wb if k2 else wb[:k1]
        b_lib = b.to(bf)

        def lib(a=a_lib, w=w_lib, b=b_lib):
            return torch.addmm(b, a, w)

        def plain(a1=a1, w=w, k1=k1, a2=a2, b=b, relu=relu, rt=rt, div=div):
            return mk.gemm_fwd_reference(
                a1.float(), w[:k1], None if a2 is None else a2.float(),
                w[k1:] if a2 is not None else None, b, relu, rt, div)

        got, ref = new(), plain()
        again = mk.gemm_fwd(a1, wt[:, :k1], bias=b, relu=relu, rowterm=rt,
                            div=div, out=torch.empty_like(out), **two)
        torch.cuda.synchronize()
        ulps = gemm_ulps(got, ref)
        abs_err = float(torch.max(torch.abs(got.float() - ref)))
        bitwise = torch.equal(got, again)
        finite = bool(torch.isfinite(got.float()).all())
        ms = cuda_ms(new, iters=50, warmup=5)
        ms_old = cuda_ms(old, iters=20, warmup=2)
        ms_lib = cuda_ms(lib, iters=50, warmup=5)
        ms_plain = cuda_ms(plain, iters=3, warmup=1)
        moved = 2.0 * (M * (k1 + k2) + n * (k1 + k2) + M * n) + 4.0 * n + (
            4.0 * rt.numel() if rt is not None else 0.0)
        b_ms, b_by = bound(2.0 * M * n * (k1 + k2), moved)
        rec = {"K": k1 + k2, "N": n, "max_ulps": ulps, "max_abs_err": abs_err,
               "bitwise_rerun": bitwise, "ms": ms, "old_ms": ms_old,
               "library_ms": ms_lib, "plain_ms": ms_plain, "bound_ms": b_ms,
               "bound_by": b_by, "gb_per_s": moved / ms / 1e6,
               "rowterm_max_abs_err": rt_err}
        layers[name] = rec
        print(f"gemm {name} [{card}] M={M} K={k1}+{k2} N={n}"
              f"{f' + row term (max|err| {rt_err:.2e})' if has_rt else ''}"
              f": max err {ulps:.2f} bf16 ulp "
              f"(abs {abs_err:.3e}), bitwise rerun {bitwise}; new {ms:.4f} "
              f"ms, old WMMA {ms_old:.4f} ms, addmm {ms_lib:.4f} ms, plain "
              f"{ms_plain:.3f} ms; {rec['gb_per_s']:.0f} GB/s of "
              f"{HBM_BYTES / 1e9:.0f}, bound {b_ms:.4f} ms ({b_by})")
        if not (finite and bitwise and ulps <= GEMM_ULPS
                and (rt_err is None or rt_err <= 1e-5)):
            raise AssertionError(f"gemm {name}: {ulps:.2f} ulps (bar "
                                 f"{GEMM_ULPS}), finite {finite}, bitwise "
                                 f"rerun {bitwise}")
    # the forward's ten layer GEMMs (+ the row term) as a chain
    D = cfg["model"]["hidden_dim"]
    tw = {n: (mk._padded_t(params[n]["w"].detach()), params[n]["b"].detach())
          for n in mk.GEMM_LAYERS}
    enc, denc = acts(M, 63), acts(N_RAYS, 27)
    hbuf = [torch.empty((M, D), dtype=bf, device=dev) for _ in range(2)]
    hr = torch.empty((M, D // 2), dtype=bf, device=dev)
    rtb = torch.empty((N_RAYS, D // 2), dtype=torch.float32, device=dev)

    def chain():
        h = enc
        for i, name in enumerate(mk.GEMM_LAYERS[:9]):
            w, b = tw[name]
            two = (dict(a2=enc, w2t=w[:, D:D + 63]) if name == "trunk1_0"
                   else {})
            h = mk.gemm_fwd(h, w[:, :h.shape[1]], bias=b,
                            relu=name != "fc_feature", out=hbuf[i % 2], **two)
        w, b = tw["rgb_layer"]
        rt = mk.gemm_fwd(denc, w[:, D:D + 27], out=rtb)
        return mk.gemm_fwd(h, w[:, :D], bias=b, relu=True, rowterm=rt, div=S,
                           out=hr)

    lib_ops = []
    for name in mk.GEMM_LAYERS:
        w, b = params[name]["w"].detach(), params[name]["b"].detach()
        lib_ops.append((torch.randn((M, w.shape[0]), generator=gen,
                                    device=dev).to(bf), w.to(bf), b.to(bf)))

    def chain_addmm():
        for a, w, b in lib_ops:
            torch.addmm(b, a, w)

    ms_chain = cuda_ms(chain, iters=10)
    ms_chain_lib = cuda_ms(chain_addmm, iters=10)
    # host cost of one launch (the training step is host-bound): 200 calls
    # at M = 128, where the device finishes each before the next is issued
    a_s, (w_s, b_s) = acts(128, D), tw["trunk0_1"]
    w_s, wb_s = w_s[:, :D], params["trunk0_1"]["w"].detach().to(bf)
    bb_s, o_s = b_s.to(bf), torch.empty((128, D), dtype=bf, device=dev)
    host_us = {
        "new": lambda: mk.gemm_fwd(a_s, w_s, bias=b_s, relu=True, out=o_s),
        "old": lambda: mk._gemm_nn(mk._Mat(a_s, D), wb_s, 128, D, o_s,
                                   bias=b_s, relu=True),
        "addmm": lambda: torch.addmm(bb_s, a_s, wb_s)}
    host_us = {k: host_ms(fn, iters=200, sync=False)
               for k, fn in host_us.items()}
    host_us = {k: 1e3 * v for k, v in host_us.items()}
    flops = 2.0 * M * sum(params[n]["w"].numel() for n in mk.GEMM_LAYERS)
    print(f"gemm chain [{card}] M={M}: ten layer GEMMs + row term "
          f"{ms_chain:.4f} ms, ten addmm {ms_chain_lib:.4f} ms "
          f"({flops / 1e9:.1f} GFLOP: {flops / ms_chain / 1e9:.1f} TFLOP/s);"
          f" host us per launch: " + ", ".join(
              f"{k} {v:.1f}" for k, v in host_us.items()))
    head = layers["trunk0_1"]
    return {"name": "mlp_gemm_sm90", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/mlp_gemm_sm90.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:668",
            "also_serves": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:244",
            "shape": "trunk0_1: M=131072 K=256 N=256",
            "max_abs_err": max(r["max_abs_err"] for r in layers.values()),
            "max_ulps": max(r["max_ulps"] for r in layers.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "old_ms": head["old_ms"], "library_ms": head["library_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "layers": layers, "chain_ms": ms_chain,
            "chain_addmm_ms": ms_chain_lib, "host_us_per_launch": host_us}


# the backward's input-gradient GEMMs timed in the backward GEMM phase:
# (what it computes, K, N, output type, ReLU mask, fc_density's rank-1 term,
# column sums) at the stock widths; the trunk shape also serves trunk1_3..0
# (activation half) and trunk0_3..1, the 63-wide one trunk0_0
DGRAD_CASES = (
    ("rgb_layer->feat", 128, 256, "bf16", False, False, True),
    ("rgb_layer->denc", 128, 27, "f32", False, False, False),
    ("fc_feature+fc_density", 256, 256, "bf16", True, True, True),
    ("trunk", 256, 256, "bf16", True, False, True),
    ("trunk1_0->enc", 256, 63, "f32", False, False, False),
)
# its weight gradients: (layer, K_in, N, kind) with kind "wgmma" (gemm_wgrad),
# "per_ray" (Kernel A's direction half of rgb_layer: ray sums, then an f32
# product) or "head" (a narrow head, from g_raw's f32 columns)
WGRAD_CASES = (
    ("trunk", 256, 256, "wgmma"),
    ("trunk0_0 / trunk1_0 enc", 63, 256, "wgmma"),
    ("rgb_layer feat", 256, 128, "wgmma"),
    ("rgb_layer denc per ray", 27, 128, "per_ray"),
    ("fc_density", 256, 1, "head"),
    ("fc_rgb", 128, 3, "head"),
)


def check_gemm_bwd(dev, card):
    """The backward GEMM phase: each input-gradient shape of gemm_dgrad and
    each weight-gradient shape of gemm_wgrad (and Kernel A's per-ray
    direction weight gradient) at M = 131,072 against its plain version
    (bf16 outputs in bf16 ulps as in the forward's phase, f32 outputs and
    column sums in relL2), a bitwise rerun, and its device time
    (:func:`device_ms`: the split-K reductions included) beside the WMMA
    gemm_nn / gemm_tn it replaced (run as they ran, on f32 cotangents),
    ``torch.mm`` in bf16 on the same operands, and the memory bound."""
    import torch

    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    cfg = stock_cfg()
    D = cfg["model"]["hidden_dim"]
    params = init_nerf_params(torch.Generator().manual_seed(SEED), cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    M, S = N_RAYS * N_SAMPLES, N_SAMPLES
    bf, f32 = torch.bfloat16, torch.float32

    def rows(m, k, relu=False, scale=1.0):
        """bf16 (m, k) normal values with NaN in the row padding."""
        buf = torch.full((m, mk._pad8(k)), float("nan"), dtype=bf, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev) * scale
        buf[:, :k] = x.relu() if relu else x
        return buf[:, :k]

    def out_buf(m, n, dtype):
        return torch.empty((m, mk._pad8(n)), dtype=dtype, device=dev)[:, :n]

    def rel(a, b):
        return rel_l2(a.float(), b.float())

    dgrad, wgrad = {}, {}
    g_raw = torch.randn((M, 4), generator=gen, device=dev) * 1e-3
    wd = params["fc_density"]["w"].detach().to(bf).reshape(-1)
    for name, K, N, odt, masked, rank1, sums in DGRAD_CASES:
        dtype = bf if odt == "bf16" else f32
        # a weight whose rows are the layer's inputs and columns its K
        w = mk._padded(torch.randn((N, K), generator=gen, device=dev)
                       * K ** -0.5)
        a = rows(M, K, scale=1e-3)
        mask = rows(M, N, relu=True) if masked else None
        extra = dict(gsig=g_raw[:, 0], wd=wd) if rank1 else {}

        def new(out=out_buf(M, N, dtype), a=a, w=w, mask=mask, extra=extra,
                sums=sums):
            return mk.gemm_dgrad(a, w, out, mask=mask, colsum=sums, **extra)

        def plain(a=a, w=w, mask=mask, rank1=rank1):
            return mk.gemm_dgrad_reference(
                a.float(), w.float(), None if mask is None else mask.float(),
                g_raw[:, 0] if rank1 else None, wd.float() if rank1 else None)

        got, colsum = new()
        again, colsum2 = new(out=out_buf(M, N, dtype))
        ref = plain()
        torch.cuda.synchronize()
        err = (gemm_ulps(got, ref.to(bf)) if dtype == bf else rel(got, ref))
        sum_err = rel(colsum, ref.sum(0)) if sums else None
        bitwise = torch.equal(got, again) and (
            not sums or torch.equal(colsum, colsum2))
        finite = bool(torch.isfinite(got.float()).all())
        # the WMMA kernel as the old backward ran it: f32 cotangents, the
        # transposed weight as its (K, n) B, an f32 output
        a_old = a.float().contiguous()
        w_old = mk._padded_t(w.float())
        out_old = torch.empty((M, mk._pad8(N)), dtype=f32, device=dev)
        m_old = None if mask is None else mk._Mat(mask, N)
        ms = device_ms(new, iters=20)
        ms_old = device_ms(lambda a_old=a_old, w_old=w_old, m_old=m_old, N=N,
                           K=K, out_old=out_old: mk._gemm_nn(
                               mk._Mat(a_old, K), w_old, M, N, out_old,
                               mask=m_old), iters=5)
        ms_lib = device_ms(lambda a=a, w=w: torch.mm(a, w.t()), iters=20)
        ms_plain = device_ms(plain, iters=3, warmup=1)
        moved = (2.0 * M * K + 2.0 * N * K + M * N * got.element_size()
                 + (2.0 * M * N if masked else 0.0)
                 + (4.0 * M + 2.0 * N if rank1 else 0.0)
                 + (4.0 * N if sums else 0.0))
        b_ms, b_by = bound(2.0 * M * K * N, moved)
        rec = {"K": K, "N": N, "out": odt, "mask": masked, "rank1": rank1,
               "err": err, "err_unit": "bf16 ulps" if dtype == bf else
               "relL2", "colsum_rel_l2": sum_err, "bitwise_rerun": bitwise,
               "ms": ms, "old_ms": ms_old, "library_ms": ms_lib,
               "plain_ms": ms_plain, "bound_ms": b_ms, "bound_by": b_by,
               "gb_per_s": moved / ms / 1e6,
               "max_abs_err": float(torch.max(torch.abs(got.float() - ref)))}
        dgrad[name] = rec
        print(f"gemm dgrad {name} [{card}] M={M} K={K} N={N} {odt}"
              f"{' mask' if masked else ''}{' rank-1' if rank1 else ''}: err "
              f"{err:.3e} {rec['err_unit']}"
              + (f", column sums relL2 {sum_err:.2e}" if sums else "")
              + f"; bitwise rerun {bitwise}; new {ms:.4f} ms, old WMMA "
              f"{ms_old:.4f} ms, torch.mm {ms_lib:.4f} ms, plain "
              f"{ms_plain:.3f} ms; {rec['gb_per_s']:.0f} GB/s, bound "
              f"{b_ms:.4f} ms ({b_by})")
        ok = finite and bitwise and (err <= GEMM_ULPS if dtype == bf
                                     else err <= 1e-5)
        if not ok or (sums and not sum_err <= 1e-5):
            raise AssertionError(f"gemm dgrad {name}: err {err}, column sums "
                                 f"{sum_err}, finite {finite}, bitwise "
                                 f"{bitwise}")

    denc = rows(N_RAYS, 27)
    g4 = torch.randn((M, 4), generator=gen, device=dev) * 1e-3  # g_raw
    for name, K, N, kind in WGRAD_CASES:
        x = denc if kind == "per_ray" else rows(M, K, relu=True)
        # a head reads g_raw's f32 columns: fc_density the first, fc_rgb 1:4
        c0 = 0 if N == 1 else 1
        g = g4[:, c0:c0 + N] if kind == "head" else rows(M, N, scale=1e-3)

        def new(x=x, g=g, kind=kind, K=K, N=N):
            if kind == "head":
                return mk.head_weight_grad(x, g)
            out = torch.empty((K, N), dtype=f32, device=dev)
            if kind == "per_ray":
                return mk.dir_weight_grad(x, g, S, out)
            return mk.gemm_wgrad(x, g, out)

        def plain(x=x, g=g, kind=kind):
            if kind == "per_ray":
                return mk.dir_weight_grad_reference(x, g, S)
            return mk.gemm_wgrad_reference(x.float(), g.float())

        got, again, ref = new(), new(), plain()
        torch.cuda.synchronize()
        err = rel(got, ref)
        bitwise = torch.equal(got, again)
        # the WMMA gemm_tn as the old backward ran it, on f32 cotangents
        g_old = (mk._Mat(g4, N, offset=c0) if kind == "head"
                 else mk._Mat(g.float().contiguous(), N))
        if kind == "per_ray":  # its one [feat | denc per ray] launch
            feat = rows(M, D, relu=True)
            x_old = dict(x1=mk._Mat(feat, D), x2=mk._Mat(denc, 27, row_div=S))
        else:
            x_old = dict(x1=mk._Mat(x, K))
        g_lib = None if kind == "per_ray" else g.to(bf).contiguous()
        ms = device_ms(new, iters=20)
        ms_old = device_ms(lambda g_old=g_old, x_old=x_old: mk._weight_grad(
            g=g_old, m=M, **x_old), iters=5)
        ms_lib = None if g_lib is None else device_ms(
            lambda x=x, g_lib=g_lib: torch.mm(x.t(), g_lib), iters=20)
        ms_plain = device_ms(plain, iters=3, warmup=1)
        moved = (2.0 * x.shape[0] * K + M * N * g.element_size()
                 + 4.0 * K * N)
        b_ms, b_by = bound(2.0 * M * K * N, moved)
        rec = {"K_in": K, "N": N, "kind": kind, "rel_l2": err,
               "bitwise_rerun": bitwise, "ms": ms, "old_ms": ms_old,
               "library_ms": ms_lib, "plain_ms": ms_plain, "bound_ms": b_ms,
               "bound_by": b_by, "gb_per_s": moved / ms / 1e6,
               "max_abs_err": float(torch.max(torch.abs(got - ref)))}
        wgrad[name] = rec
        print(f"gemm wgrad {name} [{card}] M={M} K_in={K} N={N} ({kind}): "
              f"relL2 {err:.3e}; bitwise rerun {bitwise}; new {ms:.4f} ms, "
              f"old WMMA {ms_old:.4f} ms"
              f"{' (with the feat half)' if kind == 'per_ray' else ''}"
              ", torch.mm " + ("n/a" if ms_lib is None else f"{ms_lib:.4f} ms")
              + f", plain {ms_plain:.3f} ms; {rec['gb_per_s']:.0f} GB/s, "
              f"bound {b_ms:.4f} ms ({b_by})")
        if not (bitwise and err <= 1e-5 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"gemm wgrad {name}: relL2 {err}, bitwise "
                                 f"{bitwise}")
    src = "nope_nerf_tpu_torch/csrc/mlp_gemm_sm90.cu"
    recs = []
    for rec_name, head, table, err_key in (
            ("mlp_gemm_dgrad", dgrad["trunk"], dgrad, "max_abs_err"),
            ("mlp_gemm_wgrad", wgrad["trunk"], wgrad, "max_abs_err")):
        recs.append({
            "name": rec_name, "route": "cuda", "source": src,
            "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:702",
            "also_serves": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:258",
            "shape": "one 256x256 trunk layer at M=131072",
            "max_abs_err": max(r[err_key] for r in table.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "old_ms": head["old_ms"], "library_ms": head["library_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "shapes": table})
    return recs


def kernel_counters():
    """The launch counters of the six kernels, the forward's GEMM, the
    backward's input- and weight-gradient GEMMs (and every weight-gradient
    launch) and the WMMA GEMM they replaced."""
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    return (mk.FWD_LAUNCHES, mk.BWD_LAUNCHES, cb.LAUNCHES,
            mk.FWD_POINT_LAUNCHES, mk.BWD_POINT_LAUNCHES, ck.LAUNCHES,
            mk.GEMM_SM90_LAUNCHES, mk.GEMM_DGRAD_LAUNCHES,
            mk.GEMM_WGRAD_LAUNCHES, mk.WGRAD_LAUNCHES, mk.GEMM_NN_LAUNCHES)


def check_gemm_counts(label, counts, weight_grads=True):
    """Every forward of Kernels A and C ran its 11 GEMMs on the TMA + wgmma
    kernel, every backward its 12 input-gradient GEMMs on gemm_dgrad and,
    with ``weight_grads``, its weight gradients (11 of A's and 12 of C's on
    gemm_wgrad, 14 weight-gradient launches in all; none without); the WMMA
    GEMM never ran."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    fwd = counts["mlp_composite_fwd"] + counts["mlp_point_fwd"]
    a_bwd, c_bwd = counts["mlp_composite_bwd"], counts["mlp_point_bwd"]
    want = {"mlp_gemm_sm90": 11 * fwd, "mlp_gemm_nn": 0,
            "mlp_gemm_dgrad": mk.DGRAD_PER_BWD * (a_bwd + c_bwd),
            "mlp_gemm_wgrad": (11 * a_bwd + 12 * c_bwd) if weight_grads else 0,
            "mlp_weight_grad_gemm": (mk.WGRAD_PER_BWD * (a_bwd + c_bwd)
                                     if weight_grads else 0)}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: GEMM launches {got} for {fwd} "
                             f"forwards and {a_bwd} + {c_bwd} backwards, "
                             f"expected {want}")


# the training runs: (label, tpu overrides, kernels the run must launch;
# every other kernel must stay idle). The stock config visualises at it 0
# (visualize_every 10000, vis_geo): the Phong preview's surface colour runs
# Kernel C's forward wherever use_pallas_mlp is on, as the JAX package's
# fused MLP does
MLP_GEMMS = ("mlp_gemm_sm90", "mlp_gemm_dgrad", "mlp_gemm_wgrad",
             "mlp_weight_grad_gemm")
RUNS = (
    ("stock", {}, ("mlp_composite_fwd", "mlp_composite_bwd", "chamfer_band",
                   "mlp_point_fwd", *MLP_GEMMS)),
    ("unfused_exact", {"fuse_compositing": False, "chamfer_mode": "exact"},
     ("mlp_point_fwd", "mlp_point_bwd", "chamfer_exact", *MLP_GEMMS)),
    ("parity", {"parity": True}, ("chamfer_exact",)),
)


def run_training(dev, card, label, overrides, expect):
    """Train the stock configuration with ``overrides`` under ``tpu`` for
    EPOCHS epochs through the port's ``train`` in a fresh ``out_dir`` (a
    run there would otherwise resume from the last one's checkpoints);
    return the launch counts of that run, its state and its config."""
    import math

    import torch

    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import train

    cfg = stock_cfg()
    cfg["tpu"].update(overrides)
    cfg["training"]["out_dir"] = os.path.join(ROOT, "chiprun_out",
                                              "chip_smoke", label)
    cfg["training"]["seed"] = SEED
    shutil.rmtree(cfg["training"]["out_dir"], ignore_errors=True)
    scene = MemoryScene(N_FRAMES, H, W, SEED)
    counters = kernel_counters()
    torch.cuda.empty_cache()  # every run starts from the same allocator state
    for c in counters:
        c.reset()
    state, _, _, history = train(cfg, max_epochs=EPOCHS, scene=scene,
                                 device=dev)
    counts = {c.name: c.count for c in counters}
    for h in history:
        print(f"{label} epoch {h['epoch']} [{card}]: {h['steps']} steps, "
              f"loss {h['loss']:.6f}, {h['ms_per_step']:.3f} ms/step, "
              f"{h['rays_per_sec']:.1f} rays/s; ATE {h['ate_trans']:.5f}, "
              f"RPE trans {h['rpe_trans']:.5f}, rot {h['rpe_rot']:.5f} deg")
    steps = sum(h["steps"] for h in history)
    if steps != EPOCHS * N_FRAMES:
        raise AssertionError(f"{label}: {steps} training steps, expected "
                             f"{EPOCHS * N_FRAMES}")
    bad = [h for h in history for v in h["step_losses"] if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: non-finite training loss")
    check_launches(label, counts, expect)
    ckpts = sorted(f for f in os.listdir(cfg["training"]["out_dir"])
                   if f.endswith(".npz"))
    if "model.npz" not in ckpts or "model_pose.npz" not in ckpts:
        raise AssertionError(f"{label}: checkpoints not written: {ckpts}")
    print(f"{label} training launches: {counts}; checkpoints {ckpts}")
    return counts, state, cfg


@contextlib.contextmanager
def kernel_a_plain():
    """Route the renderer's Kernel A calls to its plain version (the
    renderer looks the wrapper up at each call)."""
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    real = mk.fused_mlp_composite
    mk.fused_mlp_composite = mk.fused_mlp_composite_reference
    try:
        yield
    finally:
        mk.fused_mlp_composite = real


def host_ms(fn, iters, warmup=1, sync=True):
    """Mean wall time of ``fn`` in ms, each call ended by a device
    synchronise (the host clock of a caller that waits for its result), or
    with ``sync`` False only the last (the host's cost of issuing it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        if sync:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def check_restore(dev, card, cfg, trained):
    """The stock run's four streams and Adam moments, restored into fresh
    tensors, equal the trained state's bit for bit."""
    import torch

    from nope_nerf_tpu_torch.convert import adam_state_from_jax_leaves
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.checkpoints import CheckpointIO
    from nope_nerf_tpu_torch.training.loop import build_params, restore
    from nope_nerf_tpu_torch.training.trainer import (group_tensors,
                                                      init_train_state)

    scene = MemoryScene(N_FRAMES, 8, 8, SEED + 1)
    fresh, _ = build_params(dict(cfg, _num_cams=N_FRAMES), scene,
                            torch.Generator().manual_seed(SEED + 1), dev)
    params, scalars, leaves = restore(CheckpointIO(cfg["training"]["out_dir"]),
                                      cfg, fresh, dev)
    state = init_train_state(params)
    adam_state_from_jax_leaves(state.optimizer, leaves)
    n_params = n_moments = 0
    bad = []
    for g in ("nerf", "pose", "focal", "distortion"):
        for a, b in zip(group_tensors(params[g]),
                        group_tensors(trained.params[g])):
            n_params += 1
            if not torch.equal(a.detach(), b.detach()):
                bad.append(f"{g} param")
            if g == "nerf":
                sa, sb = state.optimizer.state[a], trained.optimizer.state[b]
                for key in ("exp_avg", "exp_avg_sq"):
                    n_moments += 1
                    if not torch.equal(sa[key], sb[key]):
                        bad.append(f"nerf {key}")
    print(f"eval restore [{card}]: {n_params} parameter tensors and "
          f"{n_moments} nerf Adam moments restored into fresh tensors from "
          f"the stock run's checkpoints (it={scalars['it']}, "
          f"epoch_it={scalars['epoch_it']}): {len(bad)} differ")
    if bad:
        raise AssertionError(f"restored checkpoints differ: {bad}")
    return params


def check_input_only_backward(dev, card):
    """Kernel A's input-only backward (no weight needs a gradient) against
    the full one at the stock shapes: d_origins / d_rays / d_dirs bitwise
    equal, the same input-gradient GEMMs, WGRAD_PER_BWD weight-gradient
    launches against none, both timed beside the input-only memory
    floor."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    (cfg, weights, origins, rays_t, dirs, z_t, deltas_t, rng,
     t) = stock_mlp_inputs(dev)
    static = (cfg["model"]["pos_enc_levels"], cfg["model"]["dir_enc_levels"],
              cfg["model"]["occ_activation"], True, False, False, N_SAMPLES)
    cots = (t(rng.normal(size=(N_RAYS, 3)) / N_RAYS),
            t(rng.normal(size=(N_RAYS, 1)) / N_RAYS),
            torch.zeros((N_RAYS, N_SAMPLES), device=dev))
    frozen = [w.detach() for w in weights]
    geo = [origins, rays_t, dirs]
    out_full = mk.fused_mlp_composite(weights, *geo, z_t, deltas_t, *static)
    out_in = mk.fused_mlp_composite(frozen, *geo, z_t, deltas_t, *static)
    count = (mk.WGRAD_LAUNCHES, mk.GEMM_DGRAD_LAUNCHES)
    n0 = [c.count for c in count]
    g_full = torch.autograd.grad(out_full, geo + weights, cots,
                                 retain_graph=True)
    n1 = [c.count for c in count]
    g_in = torch.autograd.grad(out_in, geo, cots, retain_graph=True)
    n2 = [c.count for c in count]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(g_in, g_full[:3])]
    ms_full = cuda_ms(lambda: torch.autograd.grad(
        out_full, geo + weights, cots, retain_graph=True))
    ms_in = cuda_ms(lambda: torch.autograd.grad(out_in, geo, cots,
                                                retain_graph=True))
    dev_in = device_ms(lambda: torch.autograd.grad(out_in, geo, cots,
                                                   retain_graph=True))
    floor = mlp_bwd_floor(N_RAYS * N_SAMPLES, *_mlp_widths(weights, static),
                          div=N_SAMPLES, weight_grads=False)
    print(f"kernel A input-only bwd [{card}] N={N_RAYS} S={N_SAMPLES}: "
          f"d_origins/d_rays/d_dirs bitwise equal to the full backward "
          f"{same}; weight-gradient launches {n1[0] - n0[0]} (full) vs "
          f"{n2[0] - n1[0]}, input-gradient GEMMs {n1[1] - n0[1]} vs "
          f"{n2[1] - n1[1]}; full {ms_full:.3f} ms, input-only {ms_in:.3f} ms"
          f" (device {dev_in:.3f} ms); input-only memory floor {floor:.3f} ms")
    want = ((mk.WGRAD_PER_BWD, mk.DGRAD_PER_BWD), (0, mk.DGRAD_PER_BWD))
    got = tuple((b[0] - a[0], b[1] - a[1]) for a, b in ((n0, n1), (n1, n2)))
    if not all(same) or got != want:
        raise AssertionError("kernel A's input-only backward differs from "
                             f"the full one (launches {got}, expected {want})")
    return {"ms_full": ms_full, "ms_input_only": ms_in,
            "device_ms_input_only": dev_in, "floor_ms_input_only": floor}


def pose_step_ms(dev, nerf_params, scene, render_cfg, weight_grads):
    """Wall ms of one test-time pose-optimisation step (ray draw, render,
    MSE, backward, Adam) at EVAL_POINTS rays, with the field's weights
    requiring gradients (the full backward) or frozen (input-only)."""
    import torch

    from nope_nerf_tpu_torch.evaluation.pose_opt import pose_opt_loss
    from nope_nerf_tpu_torch.models.pose import init_pose_params
    from nope_nerf_tpu_torch.training.trainer import sample_ray_idx

    nerf = {k: {kk: v.detach().clone().requires_grad_(weight_grads)
                for kk, v in layer.items()} for k, layer in nerf_params.items()}
    imgs = torch.as_tensor(scene.imgs, device=dev)
    cam = torch.as_tensor(scene.K, device=dev)
    eye = torch.eye(4, device=dev)
    init = torch.as_tensor(scene.c2ws, device=dev)
    pose = init_pose_params(scene.N_imgs, dev)
    for v in pose.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(pose.values()), lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        idx = sample_ray_idx(EVAL_POINTS, imgs.shape[1:3], True, gen, dev)
        opt.zero_grad(set_to_none=True)
        pose_opt_loss(pose, nerf, imgs, cam, eye, 0, idx, init,
                      render_cfg).backward()
        opt.step()

    return host_ms(step, iters=20, warmup=3)


def run_eval(dev, card, cfg, trained):
    """The eval phase on the stock run's checkpoints (see the module
    docstring). Returns the eval launch counts and the measured numbers."""
    import torch

    from nope_nerf_tpu_torch import eval as peval
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.rendering import render_image
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg

    nerf = check_restore(dev, card, cfg, trained)["nerf"]
    cfg = dict(cfg, eval_pose=dict(cfg["eval_pose"],
                                   opt_pose_epoch=EVAL_POSE_EPOCHS,
                                   n_points=EVAL_POINTS))
    train_scene = MemoryScene(N_FRAMES, H, W, SEED)
    eval_scene = MemoryScene(N_FRAMES, H, W, SEED, mode="eval")
    counters = kernel_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset()
    res = peval.main(cfg, device=dev, train_scene=train_scene,
                     eval_scene=eval_scene)
    counts = {c.name: c.count for c in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    finite = all(math.isfinite(res[k]) for k in ("psnr", "ssim"))
    print(f"eval [{card}]: {EVAL_POSE_EPOCHS} pose epochs x "
          f"{eval_scene.N_imgs} held-out view at {EVAL_POINTS} rays, then "
          f"{H}x{W} through Kernel A: PSNR {res['psnr']:.4f}, SSIM "
          f"{res['ssim']:.5f}, {res['ms_per_image'][0]:.1f} ms/image (render"
          f" + scoring + PNGs), peak memory {peak / 2**30:.3f} GiB; "
          f"launches {counts}")
    stray = [n for n, v in counts.items() if v and n not in (
        "mlp_composite_fwd", "mlp_composite_bwd", *MLP_GEMMS)]
    if not (counts["mlp_composite_fwd"] and counts["mlp_composite_bwd"]) \
            or stray or not finite:
        raise AssertionError(f"eval: kernel A fwd/bwd not both launched, or "
                             f"launched off this path {stray}, or non-finite "
                             f"metrics {res}")
    check_gemm_counts("eval", counts, weight_grads=False)

    render_cfg = make_render_cfg(cfg, dev)
    cam = torch.as_tensor(train_scene.K, device=dev)
    world = torch.linalg.inv(torch.as_tensor(train_scene.c2ws[0], device=dev))
    eye = torch.eye(4, device=dev)
    before = {c.name: c.count for c in counters}
    render_ms = host_ms(lambda: render_image(nerf, (H, W), cam, world, eye,
                                             render_cfg, chunk=65536), iters=3)
    during = {c.name: c.count - before[c.name] for c in counters}
    check_gemm_counts("eval render", during, weight_grads=False)
    print(f"eval render launches [{card}]: {during}")
    small = render_image(nerf, SMALL_VIEW, cam, world, eye, render_cfg)
    with kernel_a_plain():
        small_plain = render_image(nerf, SMALL_VIEW, cam, world, eye,
                                   render_cfg)
        small_plain_ms = host_ms(lambda: render_image(
            nerf, SMALL_VIEW, cam, world, eye, render_cfg), iters=3)
    small_ms = host_ms(lambda: render_image(nerf, SMALL_VIEW, cam, world, eye,
                                            render_cfg), iters=3)
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "depth"), small, small_plain)}
    print(f"eval render [{card}]: {H}x{W} through Kernel A {render_ms:.1f} "
          f"ms/image; {SMALL_VIEW[0]}x{SMALL_VIEW[1]} Kernel A vs its plain "
          f"version max|err| rgb={err['rgb']:.3e} depth={err['depth']:.3e}; "
          f"kernel {small_ms:.1f} ms, plain {small_plain_ms:.1f} ms")
    if not (err["rgb"] <= RGB_ATOL and err["depth"] <= DIST_ATOL):
        raise AssertionError(f"eval render: Kernel A disagrees with its plain "
                             f"version {err}")

    bwd = check_input_only_backward(dev, card)
    ms_full = pose_step_ms(dev, nerf, eval_scene, render_cfg, True)
    ms_in = pose_step_ms(dev, nerf, eval_scene, render_cfg, False)
    print(f"eval pose step [{card}]: {EVAL_POINTS} rays, full backward "
          f"{ms_full:.3f} ms/step, input-only backward {ms_in:.3f} ms/step")
    return counts, {"psnr": res["psnr"], "ssim": res["ssim"],
                    "ms_per_image": res["ms_per_image"][0],
                    "render_ms": render_ms, "peak_bytes": peak,
                    "small_view_max_abs_err": err, "small_view_ms": small_ms,
                    "small_view_plain_ms": small_plain_ms,
                    "bwd_full_ms": bwd["ms_full"],
                    "bwd_input_only_ms": bwd["ms_input_only"],
                    "bwd_input_only_device_ms": bwd["device_ms_input_only"],
                    "bwd_input_only_floor_ms": bwd["floor_ms_input_only"],
                    "pose_step_full_ms": ms_full,
                    "pose_step_input_only_ms": ms_in}


def check_launches(label, counts, expect, weight_grads=True):
    """Every kernel in ``expect`` launched in ``counts``, no other one, and
    the GEMM counts of :func:`check_gemm_counts`."""
    idle = [n for n in expect if counts[n] == 0]
    stray = [n for n, v in counts.items() if v and n not in expect]
    if idle or stray:
        raise AssertionError(f"{label}: kernels never launched {idle}, "
                             f"launched off this path {stray}")
    check_gemm_counts(label, counts, weight_grads=weight_grads)


def synthetic_cfg(base):
    """The stock config on the teacher scene under ``base``: the depth range
    the teacher was rendered in, gt poses fixed, the stock pre-switch loss
    weights (rgb, depth, pc, rgb_s) throughout, a visualisation and a pair
    dump every SYN_VIS_EVERY steps, pose metrics every epoch."""
    cfg = stock_cfg()
    cfg["dataloading"].update(path=os.path.join(base, "data"),
                              scene=["scene"], resize_factor=None,
                              spherify=False)
    cfg["rendering"]["depth_range"] = [0.5, 6.0]
    cfg["pose"].update(learn_R=False, learn_t=False, init_pose=True,
                       init_pose_type="gt")
    cfg["training"].update(out_dir=os.path.join(base, "out"), seed=SEED,
                           auto_scheduler=False, print_every=0,
                           checkpoint_every=0, backup_every=0,
                           visualize_every=SYN_VIS_EVERY,
                           vis_reprojection_every=SYN_VIS_EVERY,
                           eval_pose_every=1, eval_img_every=1)
    cfg["extract_images"].update(traj_option="interp", N_novel_imgs=SYN_NOVEL,
                                 output_geo=True)
    return cfg


def reset_counts():
    counters = kernel_counters()
    for c in counters:
        c.reset()
    return counters


@contextlib.contextmanager
def recording(module, name, keep=1):
    """Wrap ``module.name`` inside the block; yields a list of the (args,
    kwargs) of its last ``keep`` calls, so a kernel's wrapper can be held
    against its plain version at the inputs a path gave it."""
    fn = getattr(module, name)
    calls = collections.deque(maxlen=keep)

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def check_argmin_calls(label, kernel, plain, calls):
    """Rerun recorded calls of a Chamfer argmin wrapper through the kernel
    and its plain version: identical indices required."""
    import torch

    mism = 0
    for args, kwargs in calls:
        out_k, out_r = kernel(*args, **kwargs), plain(*args, **kwargs)
        if torch.is_tensor(out_k):
            out_k, out_r = (out_k,), (out_r,)
        mism += sum(int(torch.sum(a != b)) for a, b in zip(out_k, out_r))
    if not calls or mism:
        raise AssertionError(f"{label}: {len(calls)} recorded calls, {mism} "
                             "indices differ from the plain version")
    X, Y = calls[-1][0][:2]
    return {"calls": len(calls), "points": [X.shape[0], Y.shape[0]],
            "index_mismatches": mism}


def check_point_mlp_call(label, calls):
    """Rerun the last recorded call of Kernel C's forward wrapper through
    the kernel and its plain version, at check_kernel_c's bars."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    (args, kwargs), = calls
    with torch.no_grad():
        out_k = mk.fused_mlp(*args, **kwargs)
        out_r = mk.fused_mlp_reference(*args, **kwargs)
    err = {n: float(torch.max(torch.abs(a - b)))
           for n, a, b in zip(("rgb", "density"), out_k, out_r)}
    finite = all(bool(torch.isfinite(o).all()) for o in out_k)
    if not (finite and err["rgb"] <= RGB_ATOL
            and err["density"] <= ALPHA_ATOL):
        raise AssertionError(f"{label}: kernel C fwd against its plain "
                             f"version max|err| {err}, finite {finite}")
    return {"points": args[1].shape[0], "max_abs_err": err}


def run_synthetic(dev, card):
    """The synthetic phase (see the module docstring). Returns the launch
    counts of its main-path runs (training, the render CLI, the bench) and
    its measured numbers."""
    import io

    import torch

    from nope_nerf_tpu_torch import bench, eval_poses, render, vis_poses
    from nope_nerf_tpu_torch.geometry.rays import arange_pixels
    from nope_nerf_tpu_torch.make_synthetic_dataset import write_dataset
    from nope_nerf_tpu_torch.ops.chamfer import resolve_chamfer_mode
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import chamfer_kernel as ck
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.ops.phong import phong_render
    from nope_nerf_tpu_torch.ops.rendering import render_image
    from nope_nerf_tpu_torch.training.loop import train
    from nope_nerf_tpu_torch.training.trainer import make_render_cfg
    from nope_nerf_tpu_torch.training.visualize import (render_visdata,
                                                        visdata_view)
    from nope_nerf_tpu_torch.utils.synthetic import SyntheticScene

    base = os.path.join(ROOT, "chiprun_out", "chip_smoke", "synthetic")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    teacher = SyntheticScene(n_frames=SYN_FRAMES, hw=SYN_HW, seed=SEED,
                             device=dev)
    write_dataset(teacher, os.path.join(base, "data", "scene"))
    print(f"synthetic [{card}]: teacher scene of {SYN_FRAMES} frames "
          f"{SYN_HW[0]}x{SYN_HW[1]} rendered and written in "
          f"{time.perf_counter() - t0:.1f} s")

    cfg = synthetic_cfg(base)
    ratio = cfg["training"]["pc_ratio"]
    n_pc = int(SYN_HW[0] / ratio) * int(SYN_HW[1] / ratio)
    mode = resolve_chamfer_mode(
        cfg["tpu"]["chamfer_mode"], n_pc, n_pc, n_devices=1,
        sharded_exact=False, hints_available=True)
    # the Chamfer kernel `auto` resolves to: its counter, wrapper and plain
    # version ("grid" runs none)
    argmin = {"band": ("chamfer_band", cb, "nearest_idx_banded",
                       cb.nearest_idx_banded_reference),
              "exact": ("chamfer_exact", ck, "nearest_idx_exact",
                        ck.nearest_idx_exact_reference)}.get(mode)
    torch.cuda.empty_cache()
    counters = reset_counts()
    t0 = time.perf_counter()
    with (recording(argmin[1], argmin[2], keep=2) if argmin
          else contextlib.nullcontext(())) as argmin_calls:
        state, _, scene, history = train(cfg, max_epochs=SYN_EPOCHS,
                                         device=dev)
    train_s = time.perf_counter() - t0
    counts = {c.name: c.count for c in counters}
    psnrs = [h["psnr"] for h in history]
    print(f"synthetic training [{card}]: {len(history)} epochs x "
          f"{history[0]['steps']} steps in {train_s:.1f} s (visualisations "
          f"and pair dumps included); PSNR per epoch "
          + " ".join(f"{p:.2f}" for p in psnrs))
    steps = sum(h["steps"] for h in history)
    if steps != SYN_EPOCHS * scene.N_imgs or not all(map(math.isfinite,
                                                         psnrs)):
        raise AssertionError(f"synthetic: {steps} steps, PSNRs {psnrs}")
    tail = sum(psnrs[-SYN_TAIL:]) / SYN_TAIL
    if not (psnrs[-1] >= psnrs[0] + SYN_PSNR_GAIN and tail >= SYN_PSNR_TAIL):
        raise AssertionError(f"synthetic: PSNR {psnrs[0]:.3f} -> "
                             f"{psnrs[-1]:.3f} dB, {tail:.3f} dB over the "
                             f"last {SYN_TAIL} epochs: less than a "
                             f"{SYN_PSNR_GAIN} dB gain or below "
                             f"{SYN_PSNR_TAIL} dB")
    rendering = os.path.join(cfg["training"]["out_dir"], "rendering")
    fired = [it for it in range(steps) if it % SYN_VIS_EVERY == 0]
    missing = [os.path.join("%04d_vis" % it, "0000_%s.png" % kind)
               for it in fired for kind in ("img", "depth", "geo")]
    pairs = [n for n in sorted(os.listdir(rendering))
             if n.endswith(("_img1.png", "_img2.png"))]
    missing = [n for n in missing
               if not os.path.isfile(os.path.join(rendering, n))]
    if len(fired) < 2 or missing or len(pairs) != 2 * len(fired):
        raise AssertionError(f"synthetic: rendering/ lacks {missing}; pair "
                             f"dumps {pairs} for steps {fired}")
    check_launches("synthetic training", counts,
                   ("mlp_composite_fwd", "mlp_composite_bwd",
                    "mlp_point_fwd", *(argmin[:1] if argmin else ()),
                    *MLP_GEMMS))
    print(f"synthetic training launches [{card}] (chamfer_mode auto -> "
          f"{mode} at {n_pc} points): {counts}; rendering/: "
          f"{len(fired)} visualisations, {len(pairs)} pair images")
    kernel_checks = {}
    if argmin:
        kernel_checks[argmin[0]] = check_argmin_calls(
            f"synthetic training's {argmin[0]}", getattr(argmin[1], argmin[2]),
            argmin[3], argmin_calls)

    counters = reset_counts()
    t0 = time.perf_counter()
    with recording(mk, "fused_mlp") as cli_calls:
        render_dir = render.main(cfg, device=dev)
    cli_ms = 1e3 * (time.perf_counter() - t0) / SYN_NOVEL
    render_counts = {c.name: c.count for c in counters}
    names = [os.path.join(d, f"{i:04d}.png") for i in range(SYN_NOVEL)
             for d in ("img_out", "depth_out", "geo_out")]
    names += [os.path.join("depth_out", f"{i}.npy") for i in range(SYN_NOVEL)]
    names += [os.path.join("video_out", f"{v}.mp4")
              for v in ("img", "depth", "geo")]
    missing = [n for n in names if not os.path.isfile(
        os.path.join(render_dir, n))]
    if missing or render_counts["mlp_composite_fwd"] < SYN_NOVEL:
        raise AssertionError(f"render CLI: missing {missing}; Kernel A "
                             f"forwards {render_counts['mlp_composite_fwd']}"
                             f" for {SYN_NOVEL} views")
    check_launches("render CLI", render_counts,
                   ("mlp_composite_fwd", "mlp_point_fwd", "mlp_gemm_sm90"),
                   weight_grads=False)
    kernel_checks["mlp_point_fwd"] = [check_point_mlp_call(
        "render CLI's last view", cli_calls)]
    print(f"render CLI [{card}]: {SYN_NOVEL} interp views at "
          f"{SYN_HW[0]}x{SYN_HW[1]} with the geo pass, {cli_ms:.1f} ms per "
          f"view (render, Phong, PNGs); launches {render_counts}")
    ply = vis_poses.main(cfg)
    poses = eval_poses.main(cfg, vis=True)
    pose_ply = os.path.join(cfg["training"]["out_dir"], "pose_vis.ply")
    if not (os.path.getsize(ply) and os.path.getsize(pose_ply)
            and all(math.isfinite(v) for v in poses.values())):
        raise AssertionError(f"vis_poses / eval_poses: {ply}, {poses}")

    # the time of one render_visdata call at the stock vis_resolution, and
    # of its two parts; then of one novel view's render
    render_cfg = make_render_cfg(cfg, dev)
    init_c2w = torch.as_tensor(scene.c2ws, dtype=torch.float32, device=dev)
    vis_hw = tuple(cfg["training"]["vis_resolution"])
    nerf = state.params["nerf"]
    with torch.no_grad():
        view = visdata_view(state.params, cfg, init_c2w, scene)
    _, pixels = arange_pixels(vis_hw, device=dev)
    # Kernel C's forward at the surface points of that view's Phong preview
    with recording(mk, "fused_mlp") as vis_calls:
        phong_render(nerf, pixels, *view, render_cfg,
                     rad=cfg["rendering"]["radius"])
    kernel_checks["mlp_point_fwd"].append(check_point_mlp_call(
        "render_visdata's Phong preview", vis_calls))
    print(f"synthetic kernel checks [{card}] at this phase's inputs: "
          f"{json.dumps(kernel_checks)}")
    vis_dir = os.path.join(base, "timed_vis")
    ms_vis = host_ms(lambda: render_visdata(
        state, cfg, render_cfg, init_c2w, scene, vis_hw, 0, vis_dir), iters=3)
    ms_vis_render = host_ms(lambda: render_image(
        nerf, vis_hw, *view, render_cfg, chunk=min(vis_hw[0] * vis_hw[1],
                                                  16384)), iters=3)
    ms_vis_phong = host_ms(lambda: phong_render(
        nerf, pixels, *view, render_cfg, rad=cfg["rendering"]["radius"]),
        iters=3)
    ms_view = host_ms(lambda: render_image(nerf, SYN_HW, *view, render_cfg),
                      iters=5)
    print(f"synthetic timings [{card}]: render_visdata at {vis_hw[0]}x"
          f"{vis_hw[1]} {ms_vis:.1f} ms (render {ms_vis_render:.1f} ms, "
          f"Phong {ms_vis_phong:.1f} ms); a {SYN_HW[0]}x{SYN_HW[1]} novel "
          f"view's render {ms_view:.1f} ms")

    saved = (bench.GROUP_STEPS, bench.WARMUP_GROUPS, bench.MEASURE_GROUPS)
    bench.GROUP_STEPS, bench.WARMUP_GROUPS, bench.MEASURE_GROUPS = BENCH_SHORT
    torch.cuda.empty_cache()
    counters = reset_counts()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            bench.run(dev)
    finally:
        bench.GROUP_STEPS, bench.WARMUP_GROUPS, bench.MEASURE_GROUPS = saved
    bench_counts = {c.name: c.count for c in counters}
    lines = out.getvalue().splitlines()
    rec = json.loads(lines[-1])
    if len(lines) != 1 or rec["metric"] != "train_rays_per_sec" or not (
            rec["value"] > 0):
        raise AssertionError(f"bench: printed {lines}")
    check_launches("bench", bench_counts,
                   ("mlp_composite_fwd", "mlp_composite_bwd",
                    "chamfer_band", *MLP_GEMMS))
    print(f"bench short [{card}]: {BENCH_SHORT[1]} x {BENCH_SHORT[0]} "
          f"warm-up steps, {BENCH_SHORT[2]} x {BENCH_SHORT[0]} timed: "
          f"{json.dumps(rec)}")

    total = {k: counts[k] + render_counts[k] + bench_counts[k]
             for k in counts}
    return total, {"psnr_per_epoch": psnrs, "psnr_tail_mean": tail,
                   "train_s": train_s,
                   "chamfer_mode": mode, "render_visdata_ms": ms_vis,
                   "render_visdata_render_ms": ms_vis_render,
                   "render_visdata_phong_ms": ms_vis_phong,
                   "novel_view_render_ms": ms_view,
                   "render_cli_ms_per_view": cli_ms,
                   "kernel_checks": kernel_checks,
                   "bench_short": rec, "pose_errors": poses}


def gate_control(dev, card):
    """The convergence gate's control: the synthetic phase with the field's
    weight-matrix gradients zeroed before every Adam step (its biases still
    learn). Returns 0 when the PSNR gate rejects the run, as it must."""
    import torch

    step = torch.optim.Adam.step

    def zeroed(self, *args, **kwargs):
        for group in self.param_groups:
            if group.get("name") == "nerf":
                for p in group["params"]:
                    if p.dim() == 2 and p.grad is not None:
                        p.grad.zero_()
        return step(self, *args, **kwargs)

    torch.optim.Adam.step = zeroed
    try:
        run_synthetic(dev, card)
    except AssertionError as e:
        if "PSNR" in str(e):
            print(f"gate control [{card}]: rejected: {e}")
            return 0
        raise
    finally:
        torch.optim.Adam.step = step
    print(f"gate control [{card}]: the PSNR gate passed a run whose weight "
          "matrices never learned", file=sys.stderr)
    return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--gate-control"]):
        print("usage: chip_smoke.py [--gate-control]", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "nope_nerf_tpu_torch")):
        print("chip_smoke: nope_nerf_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch device: {kind}")

    from nope_nerf_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path()})")
    if argv:
        return gate_control(dev, card)

    a_fwd, a_bwd = check_kernel_a(dev, card)
    b = check_kernel_b(dev, card)
    c_fwd, c_bwd = check_kernel_c(dev, card)
    d = check_kernel_d(dev, card)
    gemm = check_gemm(dev, card)
    gemm_bwd = check_gemm_bwd(dev, card)
    records = [a_fwd, a_bwd, b, c_fwd, c_bwd, d, gemm, *gemm_bwd]
    launches = {rec["name"]: 0 for rec in records}
    for label, overrides, expect in RUNS:
        counts, state, cfg = run_training(dev, card, label, overrides, expect)
        if label == "stock":
            stock = (cfg, state)
        for rec in records:
            launches[rec["name"]] += counts[rec["name"]]
    eval_counts, eval_rec = run_eval(dev, card, *stock)
    syn_counts, syn_rec = run_synthetic(dev, card)
    for rec in records:
        rec["launches"] = (launches[rec["name"]] + eval_counts[rec["name"]]
                           + syn_counts[rec["name"]])
        rec["eval_launches"] = eval_counts[rec["name"]]
        rec["synthetic_launches"] = syn_counts[rec["name"]]
    print(json.dumps({"eval": eval_rec}))
    print(json.dumps({"synthetic": syn_rec}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
