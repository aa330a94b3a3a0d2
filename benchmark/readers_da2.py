"""The arithmetic of the Depth Anything V2 cell's per-layer metrics, over a
traced run's readings (``drivers/depth_priors_518.py``); each
``metrics/da2_*.py`` picks one. Every function returns None in a run of
another phase or network and when the run has nothing to read."""
from __future__ import annotations

from benchmark import readers, readers_dpt

PHASE = "depth_priors"
NETWORK = "DepthAnythingV2"
# each metric's sections: the encoder's own intervals and its attention
# cores' (Sections.read sums the 24 of each), or one of them
GROUPS = {"encoder": ("dpt.dinov2", "dpt.dinov2.attn"),
          "attn": ("dpt.dinov2.attn",),
          "head": ("dpt.decoder",)}


def _mine(t):
    return t.get("phase") == PHASE and t.get("network") == NETWORK


def section_ms(t, group):
    """Device ms a frame of the sections of ``group``: each one's timing
    events' intervals in a batch, summed, the median over the window's
    batches, over the batch's frames."""
    ms = t.get("dpt_sections_ms") if _mine(t) else None
    if not ms or any(k not in ms for k in GROUPS[group]):
        return None
    return sum(ms[k] for k in GROUPS[group])


def roofline(t, group):
    """The sections' least time a frame over their device time a frame."""
    ms = section_ms(t, group)
    least = t.get("dpt_least_s") or {}
    if not ms or any(k not in least for k in GROUPS[group]):
        return None
    return 100.0 * sum(least[k] for k in GROUPS[group]) / (ms / 1e3)


def mfu(t):
    """Depth Anything V2-Large's FLOPs of the profiled slice's frames over
    the slice's wall time, as a share of the f32 peak."""
    return readers_dpt.mfu(t) if _mine(t) else None


def device_idle_pct(t):
    """As ``readers.device_idle_pct`` for this network's runs."""
    return readers.device_idle_pct(t, PHASE) if _mine(t) else None
