"""Per-layer metrics read from the program's own tracing
(``nope_nerf_tpu_torch/tracing.py``): the device ms of each section of the
last replay of the phase's captured step, the dispatches' device ms per
step, and the host ms of one graph replay. Each function
returns None in a run of another phase, and when the program recorded
nothing (a tree without the module included)."""
from __future__ import annotations

import statistics


def _tracing(t, phase):
    """The program's tracing module in a run of ``phase``, else None."""
    if t.get("phase") != phase:
        return None
    try:
        from nope_nerf_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def section_ms(t, phase, name):
    """Device ms of the section ``name`` in the last replay of the phase's
    captured step (a step of the last dispatch's)."""
    tracing = _tracing(t, phase)
    ms = None if tracing is None else tracing.section_ms(phase)
    return None if not ms else ms.get(name)


def _median(values):
    return statistics.median(values) if values else None


def device_ms_per_step(t, phase):
    """The median over the process's dispatches of the phase of their
    device ms (one event pair around each call's work) over their steps."""
    tracing = _tracing(t, phase)
    if tracing is None:
        return None
    per = []
    for d in tracing.dispatches(phase):
        ms = d.device_ms()
        if ms is not None and d.steps:
            per.append(ms / d.steps)
    return _median(per)


def replay_host_ms(t, phase):
    """The host ms of one graph replay (a ``dispatch.replay`` span, around
    one ``graph.replay()``): the median over the process's dispatches of
    the phase that began on an idle device of their fastest replay. Behind
    a busy device each replay call waits for room in the launch queue and
    reads the device's time a step instead."""
    tracing = _tracing(t, phase)
    if tracing is None:
        return None
    return _median([d.replay_min_ns / 1e6 for d in tracing.dispatches(phase)
                    if d.idle and d.replay_min_ns is not None])
