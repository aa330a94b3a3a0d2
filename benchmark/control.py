"""Readings of the numbers that decide ``correct``, for setting their limits:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --side program|fp8|half_batch|grad_double|grad_flip

``program`` reads the program as a run does (set-up's first steps, or for
the render cell the first ``sample_images`` images), without the measured
window. ``fp8`` is the control: the plain reference put in the program's
place with the field's matrix products in float8 (e4m3 operands forward,
e5m2 gradients backward, per-tensor scales, f32 accumulation), the step
below the configuration's bf16 operands. The others are planted faults,
the reference in the program's place: ``half_batch`` takes its ray losses
over half the batch, the mean over the rest; ``grad_double`` and
``grad_flip`` scale by 2 and by -1 the gradient that Adam gets, of one
trunk layer's weight in training (a wrong weight gradient of Kernel A's
backward) and of the pose in pose optimisation (a wrong input-only
backward). Each seed prints one JSON line of its numbers; all seeds of a
call run in one process.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402
from benchmark.reference import nerf as ref  # noqa: E402

TRUNK_W = "nerf/trunk1_1/w"  # the leaf of the training cells' gradient faults
GRAD_FAULTS = {"grad_double": 2.0, "grad_flip": -1.0}


def readings(workload, seed, side, device="cuda", bench=None,
             bench_dir=harness.BENCH_DIR):
    import torch

    bench = harness.benchmark() if bench is None else bench
    _, config, mix, _ = harness.cell_plan(bench, workload, False, bench_dir)
    dev = torch.device(device)
    ctx = harness.Context(config, mix, seed, 0.0, False, dev, workload)
    drv = harness.driver(mix, bench_dir)
    s = drv.setup(ctx)
    kind = mix["driver"]
    if kind == "render":
        if side == "program":
            for i in range(mix["sample_images"]):
                rgb, depth = drv.render(s, i)
                s.kept.append((i, rgb.reshape(-1, 3)[s.pixels].copy(),
                               depth.reshape(-1)[s.pixels].copy()))
            return drv.compare(s, ctx, lambda m: None)
        if side != "fp8":
            raise SystemExit(f"no side {side!r} for the render cell")
        pix = torch.as_tensor(s.pixels, device=dev)
        gaps = {"rgb_gap": 0.0, "depth_gap": 0.0}
        for i in range(mix["sample_images"]):
            args = (s.nerf, pix, s.hw, s.scene.K, s.worlds[i], s.cfg["model"],
                    s.cfg["rendering"])
            rgb_c, depth_c = ref.render_pixels(*args, ref.mm_fp8)
            rgb_r, depth_r = ref.render_pixels(*args, ref.mm_f32)
            gaps["rgb_gap"] = max(gaps["rgb_gap"], drv.rel_l2(
                rgb_c.cpu().numpy(), rgb_r.cpu().numpy()))
            gaps["depth_gap"] = max(gaps["depth_gap"], drv.rel_l2(
                depth_c.cpu().numpy(), depth_r.cpu().numpy()))
        return gaps
    if side == "program":
        return drv.compare(s, ctx, lambda m: None)
    if kind == "train":
        drv.free_program(s, dev)
        params0 = s.params0
    else:
        params0 = None
    if side == "fp8":
        prog = drv.reference_side(s, dev, mm=ref.mm_fp8)
    elif side == "half_batch":
        n = (s.cfg["training"]["n_training_points"] if kind == "train"
             else s.n_points)
        prog = drv.reference_side(s, dev, keep_rays=n // 2)
    elif side in GRAD_FAULTS:
        f = GRAD_FAULTS[side]
        prog = drv.reference_side(
            s, dev, grad_scale=(TRUNK_W, f) if kind == "train" else f)
    else:
        raise SystemExit(f"unknown side {side!r}")
    refr = drv.reference_side(s, dev)
    return (drv.numbers(prog, refr, params0) if kind == "train"
            else drv.numbers(prog, refr))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", default="program")
    args = ap.parse_args(argv)
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(args.workload, seed, args.side)
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, "numbers": got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
