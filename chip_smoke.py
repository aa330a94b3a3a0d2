#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nope_nerf_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nope_nerf_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes of the stock training
step, then trains the stock configuration (``configs/default.yaml``: 1024
rays x 128 samples, 8 x 256 MLP, pc + rgb_s losses, banded Chamfer) for two
epochs of eight steps on an in-memory 8-frame 540x960 scene with random
weights, and checks that the training went through every kernel.

Prints, in order: the card's name and power limit, the kernel build time,
one line per kernel check, one line per epoch, a JSON line with every
kernel's errors, launches and times, and last
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that last line. It needs a CUDA device and the
repository beside it; it imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# stock shapes of Kernel A (configs/default.yaml) and of the bench workload
N_RAYS, N_SAMPLES = 1024, 128
H, W, N_FRAMES = 540, 960, 8
EPOCHS = 2

# Kernel A's bars against its plain version. tests/test_pallas.py holds the
# TPU kernel to rgb atol 0.03, density rtol 0.08 / atol 0.05 and gradients
# to relL2 0.02 (l.101-102, 163). Kernel and plain version here round the
# same operands the same way and differ only in f32 summation order;
# measured on an H100 (700 W) at these shapes and seeds: rgb 2.8e-5, dist
# 1.9e-6, alpha 5.7e-5, gradients relL2 <= 4.1e-3 (d_rays). The bars are
# tightened to leave a margin of 2.4x or more over those.
RGB_ATOL, DIST_ATOL, ALPHA_ATOL, GRAD_RELL2 = 1e-3, 1e-3, 1e-3, 1e-2


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


def rel_l2(a, b):
    import torch

    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp_min(torch.linalg.vector_norm(b), 1e-12))


def stock_cfg():
    from nope_nerf_tpu_torch.config import DEFAULT_CONFIG, load_config

    return load_config(DEFAULT_CONFIG)


def check_kernel_a(dev, card):
    """Kernel A (fused MLP + compositing) against its plain version at the
    stock step's shapes: forward errors, backward relL2, both times."""
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
    rays_t, dirs = t(rays, True), t(-rays, True)
    z_t, deltas_t = t(z), t(deltas)
    # cotangents as the training loss gives them: rgb and depth are read,
    # alpha is not. (A random alpha cotangent on all 131k samples makes the
    # backward chaotic: two runs of the plain version whose matmul outputs
    # differ by 1e-7 relative then differ by 5e-3 relL2 in the trunk.)
    cots = (t(rng.normal(size=(N, 3)) / N), t(rng.normal(size=(N, 1)) / N),
            t(np.zeros((N, S))))
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
    print(f"kernel A fwd [{card}] N={N} S={S} D={cfg['model']['hidden_dim']}:"
          f" max|err| rgb={err['rgb']:.3e} dist={err['dist']:.3e}"
          f" alpha={err['alpha']:.3e} (alpha entries over bar: {alpha_bad});"
          f" kernel {ms_fwd:.3f} ms, plain {ms_fwd_plain:.3f} ms")
    worst = max(rels, key=rels.get)
    print(f"kernel A bwd [{card}]: relL2 max {rels[worst]:.3e} ({worst}); "
          + " ".join(f"{n}={v:.2e}" for n, v in rels.items())
          + f"; kernel {ms_bwd:.3f} ms, plain {ms_bwd_plain:.3f} ms")
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
    fwd_rec = {"name": "mlp_composite_fwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_composite.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:668",
               "max_abs_err": max(err.values()), "ms": ms_fwd,
               "plain_ms": ms_fwd_plain}
    bwd_rec = {"name": "mlp_composite_bwd", "route": "cuda",
               "source": "nope_nerf_tpu_torch/csrc/mlp_composite.cu",
               "replaces": "nope_nerf_tpu/ops/pallas/mlp_kernel.py:702",
               "max_abs_err": bwd_abs, "max_rel_l2": rels[worst],
               "ms": ms_bwd, "plain_ms": ms_bwd_plain}
    return fwd_rec, bwd_rec


def check_kernel_b(dev, card):
    """Kernel B (banded Chamfer argmin) against its plain version on a
    135x240 depth-map pair warped by a small rigid motion."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.geometry.rays import (
        arange_pixels, project_to_cam, transform_to_world)
    from nope_nerf_tpu_torch.geometry.so3 import make_c2w
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    cfg = stock_cfg()
    ratio = cfg["training"]["pc_ratio"]
    hs, ws = int(H / ratio), int(W / ratio)
    rng = np.random.default_rng(SEED + 1)
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
    X = pc1 @ rel[:3, :3].t() + rel[:3, 3]
    Y = pc2
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
    return {"name": "chamfer_band", "route": "cuda",
            "source": "nope_nerf_tpu_torch/csrc/chamfer_band.cu",
            "replaces": "nope_nerf_tpu/ops/pallas/chamfer_band.py:90",
            "max_abs_err": max_abs, "index_mismatches": mism, "ms": ms,
            "plain_ms": ms_plain}


def run_slice(dev, card):
    """Train the stock configuration for two epochs through the port's
    ``train`` and return the launch counts of that run."""
    import math

    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk
    from nope_nerf_tpu_torch.synthetic import MemoryScene
    from nope_nerf_tpu_torch.training.loop import train

    cfg = stock_cfg()
    cfg["training"]["out_dir"] = os.path.join(ROOT, "chiprun_out",
                                              "chip_smoke")
    cfg["training"]["seed"] = SEED
    scene = MemoryScene(N_FRAMES, H, W, SEED)
    counters = (mk.FWD_LAUNCHES, mk.BWD_LAUNCHES, cb.LAUNCHES)
    for c in counters:
        c.reset()
    _, _, _, history = train(cfg, max_epochs=EPOCHS, scene=scene, device=dev)
    counts = {c.name: c.count for c in counters}
    for h in history:
        print(f"epoch {h['epoch']} [{card}]: {h['steps']} steps, "
              f"loss {h['loss']:.6f}, {h['ms_per_step']:.3f} ms/step, "
              f"{h['rays_per_sec']:.1f} rays/s")
    steps = sum(h["steps"] for h in history)
    if steps != EPOCHS * N_FRAMES:
        raise AssertionError(f"{steps} training steps, expected "
                             f"{EPOCHS * N_FRAMES}")
    bad = [h for h in history for v in h["step_losses"] if not math.isfinite(v)]
    if bad:
        raise AssertionError("non-finite training loss")
    idle = [n for n, v in counts.items() if v == 0]
    if idle:
        raise AssertionError(f"training never launched kernel(s) {idle}")
    print(f"training launches: {counts}")
    return counts


def main():
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

    a_fwd, a_bwd = check_kernel_a(dev, card)
    b = check_kernel_b(dev, card)
    records = [a_fwd, a_bwd, b]
    counts = run_slice(dev, card)
    for rec in records:
        rec["launches"] = counts[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
