"""Profile the stock training step, or the eval render, on a CUDA device:

    python -m nope_nerf_tpu_torch.profile_step [--steps 8] [--out DIR]
        [--set KEY=VALUE ...] [--render]

Trains the stock configuration (``configs/default.yaml`` with each
``--set``: a bare key sets the ``tpu:`` group, e.g. ``--set parity=True``,
a dotted one its group, e.g. ``--set tpu.rays_per_step_multiplier=4`` or
``--set training.with_ssim=True``) on the in-memory 8-frame 540x960 scene
(k > 1 frames per step in the bench entry's layout). With the stock
``tpu.epoch_scan: True`` it runs the scan path, as
``tools/profile_train_step.py`` does: each run is one call of
``training.trainer.make_epoch_step`` over ``--steps`` steps (on the card,
replays of one captured CUDA graph of the step); ``--set epoch_scan=False``
runs the per-step path. One warm-up run (on the scan path it captures the
graph), then ``--steps`` steps timed on the host clock around a device
synchronise, then the same number under ``torch.profiler``. Prints the wall
ms per step, rays/s, the device's busy ms per step (the replays' kernels on
the scan path) and its share of the profiled window, and the device time
per kernel, and writes the table and a Chrome trace under ``--out``.
``--sync-debug`` first lists where one run synchronises the host with the
device. ``--render`` profiles
``--steps`` full 540x960 renders of the scene's first view through
``render_image`` (the eval render: Kernel A's no-save forward) with random
weights (seed 0) instead of training steps.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import yaml

from .config import DEFAULT_CONFIG, apply_parity_profile, load_config
from .synthetic import MemoryScene
from .training.loop import (build_params, check_one_device,
                            scene_batch_arrays)
from .training.scheduler import Scheduler
from .training.trainer import (
    describe_routes,
    init_train_state,
    make_epoch_step,
    make_render_cfg,
    make_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out/profile_step")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a tpu: key, or GROUP.KEY (the value is "
                         "read as YAML)")
    ap.add_argument("--sync-debug", action="store_true",
                    help="list the operations that synchronise with the "
                         "device during one run of --steps steps")
    ap.add_argument("--render", action="store_true",
                    help="profile full-image renders instead of steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)

    cfg = load_config(DEFAULT_CONFIG)
    for item in args.set:
        key, _, value = item.partition("=")
        group, _, key = key.rpartition(".")
        cfg[group or "tpu"][key] = yaml.safe_load(value)
    apply_parity_profile(cfg)
    check_one_device(cfg, "profile_step")
    scene = MemoryScene()
    if args.render:
        return profile_render(cfg, scene, dev, args)
    cfg["_num_cams"] = scene.N_imgs
    batch0 = scene_batch_arrays(scene, cfg, dev)
    params, init_c2w = build_params(cfg, scene, torch.Generator().manual_seed(0),
                                    dev)
    scan = bool(cfg["tpu"].get("epoch_scan", True))
    state = init_train_state(params, capturable=scan)
    render_cfg = make_render_cfg(cfg, dev)
    n_pc = (int(batch0["dpts"].shape[1] / cfg["training"]["pc_ratio"])
            * int(batch0["dpts"].shape[2] / cfg["training"]["pc_ratio"]))
    print(describe_routes(cfg, render_cfg, dev, n_pc))
    sched = Scheduler(cfg)
    w_l1, w_l2 = sched.rgb_loss_switch(0)
    scalars = {"weights": sched.weights(0), "w_l1": w_l1, "w_l2": w_l2,
               "lrs": sched.applied_lrs(0)}
    static = sched.static_flags(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = scene.N_imgs
    k = max(int(cfg["tpu"].get("rays_per_step_multiplier", 1) or 1), 1)
    frames = [[(i + j) % n for j in range(k)] if k > 1 else i % n
              for i in range(args.steps)]
    refs = [scene.sample_ref_idx(i % n) for i in range(args.steps)]
    if scan:
        epoch_fn = make_epoch_step(cfg, render_cfg, init_c2w, device=dev)
        print(f"epoch_scan: {epoch_fn.route}, {args.steps} steps per call")

        def run(steps):
            assert steps == args.steps  # one captured graph's epoch
            epoch_fn(state, batch0, frames, refs, scalars, gen, static)
            return list(epoch_fn.steps["loss"])
    else:
        step = make_train_step(cfg, render_cfg, init_c2w)

        def run(steps):
            losses = []
            for i in range(steps):
                batch = dict(batch0, idx=frames[i], ref_idx=refs[i])
                _, aux = step(state, batch, scalars, static, gen)
                losses.append(aux["loss"])
            return losses

    # warm-up: allocator pools, cuBLAS handles, the kernel build (and on
    # the scan path the warm-up step and the capture)
    run(args.steps)
    if args.sync_debug:
        import warnings

        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            run(args.steps)
            torch.cuda.set_sync_debug_mode("default")
        sites = sorted({f"{w.filename}:{w.lineno}" for w in caught})
        print(f"synchronising operations in {args.steps} steps: "
              f"{len(caught)} at "
              f"{len(sites)} sites")
        for site in sites:
            print("  " + site)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    losses = run(args.steps)
    events[1].record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert all(np.isfinite(float(x)) for x in losses)
    ms = 1e3 * dt / args.steps
    rays = cfg["training"]["n_training_points"] * k
    print(f"steps without a per-step sync: {ms:.3f} ms/step wall, "
          f"{rays * 1e3 / ms:.1f} rays/s; "
          f"{events[0].elapsed_time(events[1]) / args.steps:.3f} ms/step "
          "on the device's timeline (CUDA events)")

    _profile(run, args.steps, args.out, "step")


def _profile(run, n, out, unit):
    """``run(n)`` under torch.profiler: wall and device-busy ms per
    ``unit``, the per-kernel table (printed and written to
    ``out/kernels.txt``) and ``out/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled: {wall_us / n / 1e3:.3f} ms/{unit} wall, device "
          f"busy {dev_us / n / 1e3:.3f} ms/{unit} "
          f"({100 * dev_us / wall_us:.1f}% of the window)")
    table = events.table(sort_by="self_device_time_total", row_limit=40,
                         max_name_column_width=70)
    print(table)
    with open(os.path.join(out, "kernels.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def profile_render(cfg, scene, dev, args):
    """The eval render: full-image renders of view 0 through
    ``render_image`` (no graph, so Kernel A's forward saves nothing)."""
    from .models.nerf import init_nerf_params
    from .ops.rendering import render_image

    params = init_nerf_params(torch.Generator().manual_seed(0), cfg, dev)
    render_cfg = make_render_cfg(cfg, dev)
    cam = torch.as_tensor(scene.K, device=dev)
    world = torch.linalg.inv(torch.as_tensor(scene.c2ws[0], device=dev))
    eye = torch.eye(4, device=dev)
    hw = scene.imgs.shape[1:3]

    def run(k):
        for _ in range(k):
            rgb, _ = render_image(params, hw, cam, world, eye, render_cfg,
                                  chunk=65536)
        assert bool(torch.isfinite(rgb).all())

    run(1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(args.steps)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / args.steps
    print(f"render {hw[0]}x{hw[1]}: {ms:.3f} ms/image")
    _profile(run, args.steps, args.out, "image")


if __name__ == "__main__":
    main()
