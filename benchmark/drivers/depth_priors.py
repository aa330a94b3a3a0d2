"""Depth-prior traffic: ``dpt_depth.depth_batch``, the function the
``dpt_depth`` CLI runs on every batch of a scene's frames (the input
transform on the device in float64, DPT-Hybrid in float32 with TF32 off,
the depth tail), with seeded weights on the configuration's seeded frames,
already on the card. Batch j holds frames batch * j .. batch * j + batch -
1, modulo the sequence's frames, so that every batch is full. Each batch's
depths are copied to the host before the next batch is issued (a closed
loop; no file is written).

The weights are the benchmark's (``benchmark/weights_dpt.py``, drawn on
the card from the seed at the configuration's ``network`` widths), not
the program's.

Each frame of a batch is timed as that batch's latency: from the start of
its ``depth_batch`` call until its depths are on the host. Each call also
returns the head's output before its ReLU (``pre_relu``: the same
kernels, one more tensor, left on the card). After the window, the
comparison recomputes a seeded sample of the window's batches (a
reservoir sample, drawn as the window runs) with the plain reference at
the same widths on the card, and holds both outputs of those calls to it:
the depths the window copied to the host and its pre-ReLU outputs.

Mix keys: ``driver`` "depth_priors", ``batch`` (frames a call, the CLI's
``dpt_depth.BATCH``), ``frames`` (the sequence's frames the batches cycle
through), ``sample_batches`` (batches compared), ``trace_dispatches``
(batches profiled in a traced run), ``probe_iters`` (calls of the
profiler's device-time probe of one batch).
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from benchmark import counts_dpt, scene as scenes
from benchmark.weights_dpt import dpt_weights
from benchmark.drivers.common import WindowOut, release
from benchmark.profiling import annotate, device_seconds, profile_slice
from benchmark.reference import dpt as ref

PHASE = "depth_priors"
SECTIONS = ("dpt.transform",) + counts_dpt.SECTIONS


class State:
    pass


def setup(ctx):
    # a tree without the batch function fails here, before any work
    from nope_nerf_tpu_torch.dpt_depth import depth_batch  # noqa: F401

    dev, mix, spec = ctx.device, ctx.mix, ctx.config["scene"]
    if mix["frames"] != spec["frames_total"]:
        raise ValueError("the mix's frames are not the scene's")
    s = State()
    s.batch, s.depth_cfg = mix["batch"], dict(ctx.cfg["depth"])
    sc = scenes.Scene(spec, ctx.seed, dev)
    train, test = scenes.split_ids(spec["frames_total"], spec["sample_rate"])
    s.frames = torch.empty((spec["frames_total"], sc.H, sc.W, 3),
                           device=dev)
    s.frames[torch.as_tensor(train, device=dev)] = sc.train_imgs
    s.frames[torch.as_tensor(test, device=dev)] = sc.eval_imgs
    del sc
    s.batches = [torch.as_tensor([(s.batch * j + i) % mix["frames"]
                                  for i in range(s.batch)], device=dev)
                 for j in range(mix["frames"])]
    s.params = dpt_weights(ctx.config["network"], ctx.seed, dev)
    s.hw = counts_dpt.network_hw(*s.frames.shape[1:3])
    s.host = s.event = None
    if dev.type == "cuda":
        s.host = torch.empty((s.batch, *s.hw), pin_memory=True)
        s.finite = torch.empty((s.batch,), dtype=torch.bool, pin_memory=True)
        s.event = torch.cuda.Event()
    s.sample_rng = scenes.host_rng(ctx.seed, scenes.STREAM_SAMPLE)
    s.kept, s.seen, s.next = [], 0, 0
    release(dev)
    for j in range(2):  # warm: this cell's one batch shape
        call(s, j)
    return s


def frames_of(s, j):
    return s.frames.index_select(0, s.batches[j % len(s.batches)])


def call(s, j):
    """Batch j through the program: (seconds from the call until its
    depths are on the host; the depths as numpy on the host, on the card a
    view of the pinned buffer that the next call overwrites; the frames
    with a depth that is not finite, counted on the device beside the
    copy; the head's output before its ReLU, on the device)."""
    from nope_nerf_tpu_torch.dpt_depth import depth_batch

    frames = frames_of(s, j)
    a = time.perf_counter()
    depth, pre = depth_batch(s.params, frames, s.depth_cfg, pre_relu=True)
    finite = torch.isfinite(depth).flatten(1).all(dim=1)
    if s.host is None:
        host, ok = depth.numpy(), finite.numpy()
    else:
        s.host.copy_(depth, non_blocking=True)
        s.finite.copy_(finite, non_blocking=True)
        s.event.record()
        s.event.synchronize()
        host, ok = s.host.numpy(), s.finite.numpy()
    return time.perf_counter() - a, host, int(s.batch - ok.sum()), pre


def keep(s, j, host, pre, k):
    """A seeded reservoir sample of ``k`` of the batches offered: the
    depths copied off the pinned buffer and the pre-ReLU output as the
    call left it."""
    s.seen += 1
    if len(s.kept) < k:
        s.kept.append((j, host.copy(), pre))
        return
    r = int(s.sample_rng.integers(0, s.seen))
    if r < k:
        s.kept[r] = (j, host.copy(), pre)


def _program_sections():
    """{section: device ms} of the program's last depth-prior batch (None
    where there are none, as on the CPU)."""
    from nope_nerf_tpu_torch import tracing

    return tracing.section_ms(PHASE, eager=True, wait=False)


def window(s, ctx, t_start):
    dev, mix = ctx.device, ctx.mix
    clock = {"deadline": None}
    run = {"times": [], "failed": 0, "sections": []}

    def loop(max_batches, traced):
        done = 0
        while done < max_batches and (
                traced or time.perf_counter() < clock["deadline"]):
            j = s.next
            s.next += 1
            with annotate("bench.batch", traced):
                secs, host, bad, pre = call(s, j)
            if traced:
                done += 1
                continue
            run["times"] += [secs] * s.batch
            run["failed"] += bad
            keep(s, j, host, pre, mix["sample_batches"])
            if ctx.trace:
                run["sections"].append(_program_sections())
            done += 1

    readings = {"phase": PHASE}
    if ctx.trace:
        n_tr = mix["trace_dispatches"]
        readings["slice"] = profile_slice(lambda: loop(n_tr, True), dev)
        readings["slice_steps"] = n_tr * s.batch
    # the timed window starts after a traced run's profiled slice
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    clock["deadline"] = t0 + ctx.seconds
    t0_ns = time.perf_counter_ns()
    loop(float("inf"), False)
    s.window_ns = (t0_ns, time.perf_counter_ns())
    s.window_sections = [x for x in run["sections"] if x]
    readings["step_wall_s"] = (time.perf_counter() - t0) / len(run["times"])
    times_ms = np.array(run["times"]) * 1e3
    n = len(times_ms) // s.batch
    wall_ms = readings["step_wall_s"] * s.batch * 1e3
    print(f"depth_priors: {n} batches of {s.batch} frames, median "
          f"{statistics.median(times_ms):.4f} ms, p90 "
          f"{np.percentile(times_ms, 90):.4f} ms, slowest "
          f"{times_ms.max():.4f} ms; wall {wall_ms:.4f} ms a batch",
          flush=True, file=sys.stderr)
    if ctx.trace:
        sl = readings["slice"]
        print(f"depth_priors: profiled slice busy {sl.busy_s * 1e3 / n_tr:.4f}"
              f" ms, wall {sl.wall_s * 1e3 / n_tr:.4f} ms a batch",
              flush=True, file=sys.stderr)
    readings["model_flops_per_frame"] = counts_dpt.flops(*s.hw)
    e2e = {"render_image_ms_p90": float(np.percentile(times_ms, 90)),
           "setup_s": setup_s}
    return WindowOut(e2e, len(times_ms), run["failed"], readings)


def probe(s, ctx):
    """From the program's tracing: each section's device ms a frame (the
    median over the window's batches) and the ``dpt.batch`` span a frame
    (the median over the window's); each section's least time a frame;
    one batch's device time under the profiler, beside the sections'
    sum."""
    from nope_nerf_tpu_torch import tracing
    from nope_nerf_tpu_torch.dpt_depth import depth_batch

    t0, t1 = s.window_ns
    spans = [r.ns for r in tracing.spans()
             if r.name == "dpt.batch" and t0 <= r.start_ns <= t1]
    per_batch = {k: [x[k] for x in s.window_sections if k in x]
                 for k in SECTIONS}
    sections = {k: statistics.median(v) / s.batch
                for k, v in per_batch.items() if v}
    frames, secs = frames_of(s, 0), None
    if ctx.device.type == "cuda":
        secs = device_seconds(lambda: depth_batch(s.params, frames,
                                                  s.depth_cfg),
                              ctx.device, iters=ctx.mix["probe_iters"])
    if secs is not None and sections:
        print(f"depth_priors: a batch's kernels {secs * 1e3:.4f} ms under "
              f"the profiler, its sections' events "
              f"{sum(sections.values()) * s.batch:.4f} ms (window median)",
              file=sys.stderr, flush=True)
    return {"dpt_sections_ms": sections or None,
            "dpt_host_ms": (statistics.median(spans) / 1e6 / s.batch
                            if spans else None),
            "dpt_least_s": counts_dpt.least_seconds(*s.hw, s.batch)}


def compare(s, ctx, log):
    release(ctx.device)
    depth_gap = inv_gap = clamped = 0.0
    for j, depth_p, pre_p in s.kept:
        depth_r, pre_r = ref.forward(s.params, frames_of(s, j), s.depth_cfg)
        depth_gap = max(depth_gap, worst_frame(torch.as_tensor(depth_p),
                                               depth_r))
        inv_gap = max(inv_gap, worst_frame(pre_p, pre_r))
        clamped += float((pre_r < 0).double().mean()) / len(s.kept)
    log(f"compared batches {sorted(x[0] for x in s.kept)} of {s.seen}; "
        f"the head's ReLU clamps {clamped:.4f} of their pixels")
    return {"depth_gap": depth_gap, "inv_gap": inv_gap,
            "clamped_share": clamped}


def worst_frame(prog, ref_out):
    """The largest relative L2 gap of a frame, float64."""
    p = prog.to(ref_out.device, torch.float64).flatten(1)
    r = ref_out.double().flatten(1)
    gaps = torch.linalg.vector_norm(p - r, dim=1) / torch.clamp_min(
        torch.linalg.vector_norm(r, dim=1), 1e-30)
    return float(gaps.max())
