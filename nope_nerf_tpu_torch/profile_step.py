"""Profile the stock training step on a CUDA device:

    python -m nope_nerf_tpu_torch.profile_step [--steps 8] [--out DIR]

Trains the stock configuration (``configs/default.yaml``) on the in-memory
8-frame 540x960 scene: a few warm-up steps, then ``--steps`` steps timed on
the host clock around a device synchronise, then the same number under
``torch.profiler``. Prints ms per step, rays/s, the device's busy share of
the profiled window and the device time per kernel, and writes the table
and a Chrome trace under ``--out``. ``--sync-debug`` first lists where one
step synchronises the host with the device.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .config import DEFAULT_CONFIG, load_config
from .synthetic import MemoryScene
from .training.loop import build_params, scene_batch_arrays
from .training.scheduler import Scheduler
from .training.trainer import init_train_state, make_render_cfg, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out/profile_step")
    ap.add_argument("--sync-debug", action="store_true",
                    help="list the operations that synchronise with the "
                         "device during one step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)

    cfg = load_config(DEFAULT_CONFIG)
    scene = MemoryScene()
    cfg["_num_cams"] = scene.N_imgs
    batch0 = scene_batch_arrays(scene, cfg, dev)
    params, init_c2w = build_params(cfg, scene, torch.Generator().manual_seed(0),
                                    dev)
    state = init_train_state(params)
    step = make_train_step(cfg, make_render_cfg(cfg, dev), init_c2w)
    sched = Scheduler(cfg)
    w_l1, w_l2 = sched.rgb_loss_switch(0)
    scalars = {"weights": sched.weights(0), "w_l1": w_l1, "w_l2": w_l2,
               "lrs": sched.applied_lrs(0)}
    static = sched.static_flags(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = scene.N_imgs

    def run(k):
        losses = []
        for i in range(k):
            batch = dict(batch0, idx=i % n, ref_idx=scene.sample_ref_idx(i % n))
            _, aux = step(state, batch, scalars, static, gen)
            losses.append(aux["loss"])
        return losses

    run(3)  # warm-up: allocator pools, cuBLAS handles, the kernel build
    if args.sync_debug:
        import warnings

        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            run(1)
            torch.cuda.set_sync_debug_mode("default")
        sites = sorted({f"{w.filename}:{w.lineno}" for w in caught})
        print(f"synchronising operations in one step: {len(caught)} at "
              f"{len(sites)} sites")
        for site in sites:
            print("  " + site)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = run(args.steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert all(np.isfinite(float(x)) for x in losses)
    ms = 1e3 * dt / args.steps
    rays = cfg["training"]["n_training_points"]
    print(f"steps without a per-step sync: {ms:.3f} ms/step, "
          f"{rays * 1e3 / ms:.1f} rays/s")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled: {wall_us / args.steps / 1e3:.3f} ms/step wall, device "
          f"busy {dev_us / args.steps / 1e3:.3f} ms/step "
          f"({100 * dev_us / wall_us:.1f}% of the window)")
    table = events.table(sort_by="self_device_time_total", row_limit=40,
                         max_name_column_width=70)
    print(table)
    with open(os.path.join(args.out, "kernels.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))


if __name__ == "__main__":
    main()
