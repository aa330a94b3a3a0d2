"""The arithmetic of the depth-prior cell's per-layer metrics, over a
traced run's readings (``drivers/depth_priors.py``); each
``metrics/dpt_*.py`` picks one. Every function returns None in a run of
another phase and when the run has nothing to read."""
from __future__ import annotations

from benchmark import counts_dpt

PHASE = "depth_priors"


def _mine(t):
    return t.get("phase") == PHASE


def section_ms(t, name):
    """Device ms a frame of the program's section ``name``: its timing
    events' span in a batch, the median over the window's batches, over
    the batch's frames."""
    ms = t.get("dpt_sections_ms") if _mine(t) else None
    return None if not ms else ms.get(name)


def host_ms(t):
    """Host ms a frame of the program's ``dpt.batch`` span, the median
    over the window's batches. The call never waits for the device (its
    depths are copied to the host after it returns), so the span is the
    host's own work: transform set-up, the forward's launches, tracing."""
    return t.get("dpt_host_ms") if _mine(t) else None


def mfu(t):
    """The network's FLOPs of the profiled slice's frames over the slice's
    wall time, as a share of the f32 peak (the configuration computes in
    float32 with TF32 off)."""
    sl = t.get("slice")
    if not _mine(t) or sl is None or not t.get("slice_steps"):
        return None
    flops = t["model_flops_per_frame"] * t["slice_steps"]
    return 100.0 * flops / sl.wall_s / counts_dpt.PEAK_FP32_FLOPS


def roofline(t, name):
    """The section's least time a frame over its device time a frame."""
    ms = section_ms(t, name)
    least = (t.get("dpt_least_s") or {}).get(name)
    if not ms or least is None:
        return None
    return 100.0 * least / (ms / 1e3)
