"""What the port's own tracing (``nope_nerf_tpu_torch/tracing.py``) reads in
one run of a benchmark cell, on the card:

    python3 tools/torch_trace_report.py --workload tanks_ballroom.train \
        --seed 7 --seconds 30 --trace 1 [--out chiprun_out/trace_report]

Runs the cell once through the benchmark's harness (``benchmark/
harness.py::run_cell``) and prints one JSON line, also written to
``<out>/<cell>.<trace>.json``: the run's metrics (with ``--trace 0`` the
end-to-end ones, with the program's device ms per step and replay host ms
beside them); the sections of the phase's last replay and of its eager
warm-up; each dispatch's device ms per step, the window's by quarter; the
host us of each replay of the last dispatch (issued onto an idle card in
a traced run). With ``--trace 1`` also the profiled slice's five longest
idle gaps, each named by the program's and the harness's spans open at
its middle. Then, on a fresh set-up of the cell: the host us of each
replay of three dispatches issued onto an idle device, the device ms of
one replay of the step with its section events against one without, and
the kernels of one eager step by the section whose host span launched
them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, profiling, program_trace  # noqa: E402
from nope_nerf_tpu_torch import tracing  # noqa: E402

PROGRAM_SPANS = ("bench.", "dispatch", "step.")
TOP = 5


def named_gaps(events, top=TOP):
    """The ``top`` longest idle gaps of a profiled slice: their us, and the
    program's and the harness's spans open at each gap's middle, outermost
    first."""
    dev, spans = [], []
    for e in events:
        if profiling.on_device(e):
            dev.append((e.time_range.start, e.time_range.end))
        elif (e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith(PROGRAM_SPANS)):
            spans.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    gaps, cur = [], None
    for start, end in dev:
        if cur is not None and start > cur:
            gaps.append((cur, start))
        cur = end if cur is None else max(cur, end)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        inside = sorted((s for s in spans if s[0] <= mid <= s[1]),
                        key=lambda s: s[0] - s[1])
        out.append({"us": g1 - g0, "spans": [s[2] for s in inside]})
    return out


def kernels_by_section(events):
    """{section: {kernels, ms, top: [[name, ms]]}} of the device kernels in
    ``events``, each put under the innermost ``step.*`` span open on the
    host when the runtime call that launched it (the kernel's correlation
    id) was issued (``unnamed`` outside one)."""
    launch_at = {}
    sections = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name.startswith("step."):
            sections.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith(("cuda", "cu")):  # runtime and driver calls
            launch_at[e.id] = e.time_range.start
    out = {}
    for e in events:
        if not profiling.on_device(e) or e.name.startswith(
                profiling.COPY_PREFIXES):
            continue
        t = launch_at.get(e.id)
        inside = [s for s in sections if t is not None and s[0] <= t <= s[1]]
        name = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                else "unnamed")
        row = out.setdefault(name, {"kernels": 0, "ms": 0.0, "by": {}})
        ms = (e.time_range.end - e.time_range.start) / 1e3
        row["kernels"] += 1
        row["ms"] += ms
        row["by"][e.name] = row["by"].get(e.name, 0.0) + ms
    for row in out.values():
        row["top"] = [[k[:90], v] for k, v in sorted(
            row.pop("by").items(), key=lambda kv: -kv[1])[:TOP]]
    return out


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return list(prof.events())


def _replay_cost(captured, reset, reps=20):
    """Device ms of one replay of ``captured`` without and with its section
    events (medians of ``reps`` each, in turns); ``reset`` rewinds the
    step counter first so that every replay reads a row of its buffers."""
    pairs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(2 * reps)]
    for i, (a, b) in enumerate(pairs):
        reset()
        a.record()
        captured.replay(timed=i % 2 == 1)
        b.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in pairs]
    plain, timed = (statistics.median(ms[j::2]) for j in (0, 1))
    return {"plain_ms": plain, "timed_ms": timed,
            "events": len(captured.sections.names)}


def idle_replays_us(s, drv, ctx, reps=3):
    """The host us of each replay of ``reps`` dispatches, each issued onto
    an idle device (the harness's probe of ``host_ms_per_step``)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if ctx.mix["driver"] == "train":
            drv.dispatch(s, s.rng.permutation(s.n))
            number = s.epoch_fn.last_dispatch.number
        else:
            drv.dispatch(s, 1)
            number = s.block.last_dispatch.number
        out.append([r.ns / 1e3 for r in tracing.spans()
                    if r.dispatch == number and r.name == "dispatch.replay"])
    torch.cuda.synchronize()
    return out


def step_extras(ctx, drv):
    """On a fresh set-up of the cell: the host us of each replay of
    dispatches issued onto an idle device, one replay's device ms with and
    without its events, and the kernels of one eager step by section (the
    profiler last, so that it slows nothing before it)."""
    s = drv.setup(ctx)
    idle = idle_replays_us(s, drv, ctx)
    if ctx.mix["driver"] == "train":
        from nope_nerf_tpu_torch.training.trainer import make_epoch_step

        eager = make_epoch_step(s.cfg, s.render_cfg, None,
                                device=ctx.device, eager=True)
        order = s.rng.permutation(s.n)[:2]
        refs = [drv.ref_partner(int(i), s.n) for i in order]

        def step():
            eager(s.train_state, s.batch, order, refs, s.scalars, s.gen,
                  s.static)

        (captured,) = s.epoch_fn.graphs.graphs.values()
        reset = s.epoch_fn.counter.zero_
    else:
        from nope_nerf_tpu_torch.evaluation.pose_opt import PoseOptBlock

        sc = s.scene
        block = PoseOptBlock(s.cfg, s.render_cfg, s.init_c2w, s.n_points,
                             (sc.H, sc.W), ctx.device, eager=True)
        lrs = s.lrs_epoch[:1].repeat(2)

        def step():
            block(s.nerf, s.pose, s.opt, sc.eval_imgs, sc.K, s.eye, lrs,
                  [0, 1], s.gen)

        (captured,) = s.block.graphs.graphs.values()
        reset = s.block.bufs["counter"].zero_
    cost = _replay_cost(captured, reset)
    step()  # the eager route's first steps build and allocate
    kernels = kernels_by_section(_profiled(step))
    return {"idle_replays_us": idle, "replay_cost": cost,
            "eager_step_kernels": kernels,
            "eager_route_sections": tracing.section_ms(ctx.mix["driver"],
                                                       eager=True)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "trace_report"))
    args = ap.parse_args(argv)
    report = {}
    real_reduce = profiling.reduce_events

    def reduce_events(events, wall_s):
        events = list(events)
        report["slice_gaps"] = named_gaps(events)
        return real_reduce(events, wall_s)

    profiling.reduce_events = reduce_events
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START)
    finally:
        profiling.reduce_events = real_reduce
    bench = harness.benchmark()
    _, config, mix, _ = harness.cell_plan(bench, args.workload, False)
    phase = mix["driver"]
    t = {"phase": phase}
    report.update(
        workload=args.workload, seed=args.seed, trace=args.trace,
        card=torch.cuda.get_device_name(0), power_limit=harness.power_limit(),
        metrics={k: v["value"] for k, v in result["metrics"].items()},
        correct=result["correct"], device=result["device"],
        device_ms_per_step=program_trace.device_ms_per_step(t, phase),
        replay_host_ms=program_trace.replay_host_ms(t, phase),
        sections=tracing.section_ms(phase),
        warm_up_sections=tracing.section_ms(phase, eager=True))
    ds = tracing.dispatches(phase)
    per = [(d.device_ms() or 0.0) / d.steps for d in ds]
    report["dispatch_ms_per_step"] = per
    first = 1 + (mix["trace_dispatches"] if args.trace else 0)
    window = per[first:len(per) - (3 if args.trace else 0)]
    q = len(window) // 4
    report["window_replay_host_ms_per_step"] = statistics.median(
        d.host.get("dispatch.replay", 0) / 1e6 / d.steps
        for d in ds[first:len(ds) - (3 if args.trace else 0)])
    report["window_quarters_ms_per_step"] = [
        statistics.fmean(window[i * q:(i + 1) * q]) for i in range(4)
    ] if q else None
    last = ds[-1]
    report["last_dispatch"] = {
        "steps": last.steps, "device_ms_per_step": per[-1],
        "replay_host_us": [r.ns / 1e3 for r in tracing.spans()
                           if r.dispatch == last.number
                           and r.name == "dispatch.replay"]}
    if report["sections"]:
        report["sections_sum_ms"] = sum(report["sections"].values())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.workload}.{args.trace}.json")
    if args.trace:
        sliced = sum(d.steps for d in ds[1:first])
        report["slice_busy_ms_per_step"] = (
            1e3 * result["device"]["busy_s"] / sliced)
    _write(path, report)
    ctx = harness.Context(config, mix, args.seed + 1, args.seconds, False,
                          torch.device("cuda"), args.workload)
    report.update(step_extras(ctx, harness.driver(mix)))
    _write(path, report)
    print(json.dumps(report), flush=True)
    return 0


def _write(path, report):
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
