"""Reduction of a profiled slice of the window to the numbers the per-layer
metrics read, and device time of one function (the profiler's sum of its
kernels, without the host's gaps between them).

A slice is profiled with ``torch.profiler`` (CPU and CUDA activities). The
device is busy where any device operation (kernel, copy or fill) runs: the
union of their intervals. Idle gaps are named by the innermost of the
harness's own host annotations (``annotate``) open at the gap's middle.
"""
from __future__ import annotations

import contextlib
import time

import torch

COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10


def annotate(name, on):
    """A host span named ``name`` in the profile when ``on``."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Slice:
    """What one profiled slice read: wall_s (host clock, between device
    synchronisations), busy_s, kernels (launches), ops {name: seconds},
    gaps [(seconds, name)]."""

    def __init__(self, wall_s, busy_s, kernels, ops, gaps):
        self.wall_s, self.busy_s, self.kernels = wall_s, busy_s, kernels
        self.ops, self.gaps = ops, gaps

    def breakdown(self):
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[name, s] for s, name in self.gaps[:TOP]]}


def profile_slice(fn, device):
    """Run ``fn()`` under the profiler between two synchronisations and
    reduce the trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    return reduce_events(prof.events(), wall)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def on_device(e):
    """A kernel, copy or fill on the device (not the device-side mirror of
    a host annotation)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))


def reduce_events(events, wall_s):
    dev, spans = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if on_device(e):
            dev.append((start, end, e.name))
        elif (e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("bench.")):
            spans.append((start, end, e.name))
    dev.sort()
    ops, kernels = {}, 0
    for start, end, name in dev:
        ops[name] = ops.get(name, 0.0) + (end - start) / 1e6
        kernels += not name.startswith(COPY_PREFIXES)
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for start, end, _ in dev:
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        name = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                else "bench.other_host_work")
        named.append(((g1 - g0) / 1e6, name))
    named.sort(key=lambda x: -x[0])
    return Slice(wall_s, busy / 1e6, kernels, ops, named)


def device_seconds(fn, device, iters=10, warmup=2):
    """Seconds of device time per call of ``fn``: the summed duration of
    the device operations of ``iters`` calls under the profiler, after
    ``warmup`` calls. None when the profiler saw no device operation."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    sync(device)
    for _ in range(3):  # a window with no device events is profiled again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync(device)
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if on_device(e))
        if us > 0:
            return us / iters / 1e6
    return None
