"""Benchmark of the port: training-step throughput (rays/s) at the workload
of the repository's ``bench.py``:

    python -m nope_nerf_tpu_torch.bench [--device cuda]

The stock ``configs/default.yaml`` (1024 rays x 128 samples through the
256-wide MLP, the reference-pair losses with their Chamfer argmins over two
32,400-point clouds and the rgb_s reprojection, the four-group Adam) on 8
in-memory frames of 540x960 (``synthetic.MemoryScene``), on the scan path
as ``bench.py`` times it: ``WARMUP_DISPATCHES`` dispatches of
``SCAN_STEPS`` steps of ``training.trainer.make_epoch_step`` (on the card,
replays of one captured CUDA graph of the step), then
``MEASURE_DISPATCHES`` timed by the host clock, each followed by the read
of the previous dispatch's loss (pipelined: the read waits for that
dispatch alone, the next one already queued), and the last read.
``BENCH_TPU_OVERRIDES`` (a JSON dict) is merged into the config's ``tpu``
group for variant runs; with ``{"rays_per_step_multiplier": k}`` each step
takes k frames (:func:`bench_indices`: frame 0 in the dispatch's order,
which owns the reference pair, then the k - 1 frames after it) and rays/s
counts k * 1024 rays per step, as ``bench.py`` does.

Prints ONE JSON line, ``bench.py``'s:
  {"metric": "train_rays_per_sec", "value": N, "unit": "rays/s",
   "vs_baseline": N / BASELINE_RAYS_PER_SEC, "baseline": "estimated",
   "device": "<name>"}

BASELINE_RAYS_PER_SEC is the same estimate as ``bench.py``'s (~10 train
iterations/s x 1024 rays of the reference implementation on one GPU; no
published number exists, see BASELINE.md), not a measurement.

It runs on ``--device`` (default ``cuda``) and raises when no CUDA device
is there unless ``--device cpu`` is given. The measurement runs in a child
process, retried up to ``BENCH_ATTEMPTS`` times, so that a failed device
start does not end the benchmark.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import (
    DEFAULT_CONFIG,
    apply_parity_profile,
    check_supported,
    load_config,
)
from .device import resolve_device
from .synthetic import MemoryScene
from .training.loop import (HostCopy, build_params, check_one_device,
                            scene_batch_arrays)
from .training.trainer import (
    init_train_state,
    make_epoch_step,
    make_render_cfg,
)

BASELINE_RAYS_PER_SEC = 10240.0
BENCH_ATTEMPTS = 3
BENCH_RETRY_BACKOFF_S = 60.0

H, W = 540, 960
N_FRAMES = 8
SCAN_STEPS = 192        # steps per dispatch, bench.py's
WARMUP_DISPATCHES = 2
MEASURE_DISPATCHES = 3  # 576 steps timed
SEED = 0

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_config():
    """The default config with ``BENCH_TPU_OVERRIDES`` merged into ``tpu``."""
    cfg = load_config(DEFAULT_CONFIG)
    overrides = os.environ.get("BENCH_TPU_OVERRIDES")
    if overrides:
        cfg["tpu"] = {**(cfg.get("tpu") or {}), **json.loads(overrides)}
    return cfg


def bench_indices(k=1):
    """(idxs, refs) of one dispatch, ``bench.py``'s layout: frame
    ``s % N_FRAMES`` at step s, paired with the next frame; with k > 1
    the (SCAN_STEPS, k) indices add the k - 1 frames after it."""
    idxs = np.arange(SCAN_STEPS) % N_FRAMES
    if k > 1:
        extra = (idxs[:, None] + 1 + np.arange(k - 1)[None]) % N_FRAMES
        idxs = np.concatenate([idxs[:, None], extra], axis=1)
    refs = (np.arange(SCAN_STEPS) + 1) % N_FRAMES
    return idxs.astype(np.int32), refs.astype(np.int32)


def run(device):
    """Measure and print the JSON line; returns rays/s."""
    dev = resolve_device(device)
    cfg = bench_config()
    check_supported(cfg)
    apply_parity_profile(cfg)
    check_one_device(cfg, "bench")
    cfg["_num_cams"] = N_FRAMES
    scene = MemoryScene(N_FRAMES, H, W, SEED)
    batch0 = scene_batch_arrays(scene, cfg, dev)
    params, init_c2w = build_params(cfg, scene,
                                    torch.Generator().manual_seed(SEED), dev)
    state = init_train_state(params, capturable=dev.type == "cuda")
    epoch_fn = make_epoch_step(cfg, make_render_cfg(cfg, dev), init_c2w,
                               device=dev)
    groups = ("nerf", "pose", "focal", "distortion")
    scalars = {
        "weights": {"rgb_weight": 1.0, "depth_weight": 0.04,
                    "pc_weight": 1.0, "rgb_s_weight": 1.0,
                    "depth_consistency_weight": 0.0,
                    "weight_dist_1st_loss": 0.0,
                    "weight_dist_2nd_loss": 0.0},
        "w_l1": 1.0, "w_l2": 0.0, "lrs": {g: 1e-3 for g in groups},
    }
    static = {"render_model": True, "use_ref": True, "use_rgb_s": True}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k = max(int(cfg["tpu"].get("rays_per_step_multiplier", 1) or 1), 1)
    n_rays = cfg["training"]["n_training_points"] * k  # per step
    idxs, refs = bench_indices(k)

    def dispatch():
        """One dispatch of SCAN_STEPS steps; a copy of its mean loss on its
        way to the host."""
        _, aux, _ = epoch_fn(state, batch0, idxs, refs, scalars, gen, static)
        return HostCopy({"loss": aux["loss"]})

    for _ in range(WARMUP_DISPATCHES):
        last = dispatch()
    float(last.wait()["loss"])
    t0 = time.perf_counter()
    prev = None
    for _ in range(MEASURE_DISPATCHES):
        copy = dispatch()
        if prev is not None:
            float(prev.wait()["loss"])
        prev = copy
    float(prev.wait()["loss"])
    dt = time.perf_counter() - t0
    rays_per_sec = MEASURE_DISPATCHES * SCAN_STEPS * n_rays / dt
    print(json.dumps({
        "metric": "train_rays_per_sec",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
        # the reference publishes no throughput number: the denominator is
        # the ~10 it/s x 1024 rays estimate of BASELINE.md
        "baseline": "estimated",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }), flush=True)
    return rays_per_sec


def _supervise(argv):
    """Run the benchmark in a child process with bounded retries; relay its
    stdout (the JSON line) and return its final exit code."""
    env = dict(os.environ, _BENCH_CHILD="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    last_rc = 1
    for attempt in range(BENCH_ATTEMPTS):
        proc = subprocess.run(
            [sys.executable, "-m", "nope_nerf_tpu_torch.bench", *argv],
            env=env, capture_output=True, text=True)
        if proc.stderr:
            sys.stderr.write(proc.stderr)
        if proc.returncode == 0 and proc.stdout.strip():
            sys.stdout.write(proc.stdout)
            sys.stdout.flush()
            return 0
        last_rc = proc.returncode or 1
        if attempt < BENCH_ATTEMPTS - 1:
            sys.stderr.write(
                f"[bench] attempt {attempt + 1}/{BENCH_ATTEMPTS} failed "
                f"(rc={proc.returncode}); retrying in "
                f"{BENCH_RETRY_BACKOFF_S:.0f}s\n")
            sys.stderr.flush()
            time.sleep(BENCH_RETRY_BACKOFF_S)
    return last_rc


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(
        description="Training-step throughput of nope-nerf on PyTorch + CUDA")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda).")
    args = parser.parse_args(argv)
    if os.environ.get("_BENCH_CHILD") == "1":
        run(args.device)
        return 0
    resolve_device(args.device)  # no CUDA device: raise here, not retry
    return _supervise(argv)


if __name__ == "__main__":
    sys.exit(main())
