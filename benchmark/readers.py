"""The arithmetic of the per-layer metrics, over a traced run's readings
(``drivers/*.py``): each ``metrics/<name>.py`` picks one of these for its
phase. Every function returns None when the run has nothing to read."""
from __future__ import annotations

from benchmark import counts


def _phase(t, phase):
    return t.get("phase") == phase


def host_ms_per_step(t, phase):
    """The host's span around a dispatch call issued onto an idle device,
    over that dispatch's steps (the median of the probe's calls)."""
    spans = t.get("host_spans") or []
    if not _phase(t, phase) or not spans:
        return None
    per = sorted(a / n for a, n in spans)
    return 1e3 * per[len(per) // 2]


def launches_per_step(t, phase):
    """Kernel launches in the profiled slice over its steps."""
    sl = t.get("slice")
    if not _phase(t, phase) or sl is None or not t.get("slice_steps"):
        return None
    return sl.kernels / t["slice_steps"]


def mfu(t, phase):
    """Model FLOPs of the slice's steps (images) over its wall time, as a
    share of the bf16 peak."""
    sl = t.get("slice")
    if not _phase(t, phase) or sl is None or not t.get("slice_steps"):
        return None
    flops = t["model_flops_per_step"] * t["slice_steps"]
    return 100.0 * flops / sl.wall_s / counts.PEAK_BF16_FLOPS


def roofline(t, phase, function):
    """A function's least time over its device time on the cell's
    shapes."""
    got = t.get(function)
    if not _phase(t, phase) or got is None or not got[1]:
        return None
    least, device = got
    return 100.0 * least / device


def device_idle_pct(t, phase):
    """The share of the untraced window's wall time per step (image) in
    which no device operation ran: 1 - the profiled slice's busy time per
    step over the window's wall time per step. The slice's own wall time
    is stretched by the profiler (CUPTI slows the launches), its busy time
    hardly, so the untraced window's wall time stands for the idle gaps."""
    sl = t.get("slice")
    if (not _phase(t, phase) or sl is None or sl.busy_s <= 0
            or not t.get("slice_steps") or not t.get("step_wall_s")):
        return None
    return 100.0 * (1.0 - sl.busy_s / t["slice_steps"] / t["step_wall_s"])
