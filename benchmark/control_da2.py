"""Readings of the numbers that decide ``correct`` in the Depth Anything V2
cell, for setting their limits:

    python3 benchmark/control_da2.py --seeds 1,2,3 \
        --side program|tf32|pos_by_size|late_tap

``program`` reads the program as a run does (set-up, then the first
``sample_batches`` batches through ``dpt_depth.depth_batch``, compared as
the window's sample is), without the measured window. ``tf32`` is the
control: the plain reference in the program's place with TF32 on, the
precision below the configuration's float32. ``pos_by_size`` and
``late_tap`` are planted faults, the reference in the program's place with
the position embedding resized to the grid's size instead of by DINOv2's
scale factors, or with the first tap taken a block late. Each seed prints
one JSON line of its numbers; all seeds of a call run in one process.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402
from benchmark.reference import depth_anything_v2 as ref  # noqa: E402

WORKLOAD = "depth_anything_v2_large_ballroom.depth_priors_518"
SIDES = ("program", "tf32") + ref.FAULTS


def readings(seed, side, device="cuda", bench=None,
             bench_dir=harness.BENCH_DIR):
    """The compared numbers of one seed on ``side``."""
    import torch

    if side not in SIDES:
        raise SystemExit(f"unknown side {side!r}")
    bench = harness.benchmark() if bench is None else bench
    _, config, mix, _ = harness.cell_plan(bench, WORKLOAD, False, bench_dir)
    ctx = harness.Context(config, mix, seed, 0.0, False,
                          torch.device(device), WORKLOAD)
    drv = harness.driver(mix, bench_dir)
    s = drv.setup(ctx)
    k = mix["sample_batches"]
    if side == "program":
        for j in range(k):
            _, host, _, pre = drv.call(s, j)
            drv.keep(s, j, host, pre, k)
        return drv.compare(s, ctx, lambda m: None)
    gaps = {"depth_gap": 0.0, "inv_gap": 0.0, "clamped_share": 0.0}
    for j in range(k):
        frames = drv.frames_of(s, j)
        depth_r, pre_r = ref.forward(s.params, frames, s.depth_cfg)
        depth_c, pre_c = ref.forward(s.params, frames, s.depth_cfg,
                                     tf32=side == "tf32",
                                     fault=None if side == "tf32" else side)
        gaps["depth_gap"] = max(gaps["depth_gap"],
                                drv.worst_frame(depth_c, depth_r))
        gaps["inv_gap"] = max(gaps["inv_gap"], drv.worst_frame(pre_c, pre_r))
        gaps["clamped_share"] += float((pre_r < 0).double().mean()) / k
    return gaps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", default="program", choices=SIDES)
    args = ap.parse_args(argv)
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(seed, args.side)
        print(json.dumps({"workload": WORKLOAD, "side": args.side,
                          "seed": seed, "numbers": got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
