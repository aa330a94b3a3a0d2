"""What the drivers share: the window's outcome, copies to the host that
do not wait for the device, reading the program's state between the steps
of one call, the comparison's gap measures, and freeing the program's
state before the reference runs."""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time

import torch

# dispatches timed on an idle device for host_ms_per_step
HOST_PROBE_DISPATCHES = 3


class WindowOut:
    """The window's end-to-end values, its attempted and failed counts, and
    the readings that the per-layer metrics take from a traced run."""

    def __init__(self, end_to_end, attempted, failed, readings):
        self.end_to_end, self.attempted = end_to_end, attempted
        self.failed, self.readings = failed, readings


class HostCopy:
    """A device tensor copied to pinned host memory behind an event, so
    that the host waits for that copy alone and not for work queued after
    it."""

    def __init__(self, t):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.detach().clone()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host


@contextlib.contextmanager
def stops_after(stops):
    """Within the block, a call that runs n steps through the program's
    ``StepGraphs`` (``EpochStep``, ``PoseOptBlock``) runs ``stops[k]()``
    once its first k steps are done, for each k <= n. On the card the
    steps are the call's own: the key's eager first step, its capture and
    the replays of that graph, split between replays. The callbacks copy
    state and change nothing."""
    from nope_nerf_tpu_torch.training.capture import StepGraphs

    real = StepGraphs.run

    def run(self, key, fn, n, generators=(), inputs=()):
        done = 0
        for k in sorted(stops):
            if done < k <= n:
                real(self, key, fn, k - done, generators, inputs)
                done = k
                stops[k]()
        real(self, key, fn, n - done, generators, inputs)

    StepGraphs.run = run
    try:
        yield
    finally:
        StepGraphs.run = real


def idle_host_spans(dispatch, device, reps=HOST_PROBE_DISPATCHES):
    """[(host seconds, steps)] of ``reps`` calls of ``dispatch`` (returning
    its ``HostCopy`` and its steps), each issued onto an idle device and
    waited for after its span: the host's own cost of queueing a
    dispatch, without the wait for room in the device's queue that a call
    into a busy window includes."""
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        a = time.perf_counter()
        cp, n = dispatch()
        out.append((time.perf_counter() - a, n))
        cp.wait()
    return out


def quarter_rates(marks, t0, wall):
    """Steps per second in each quarter of the window, from ``marks``
    [(host time, steps completed by then)], linear between marks: beside
    the run's rate, how far a run's own rate moves within its window."""
    pts = [(t0, 0)] + list(marks)

    def done_at(t):
        for (ta, na), (tb, nb) in zip(pts, pts[1:]):
            if ta <= t <= tb:
                return na + (nb - na) * (t - ta) / max(tb - ta, 1e-12)
        return pts[-1][1]

    edges = [done_at(t0 + wall * q / 4) for q in range(5)]
    return [(b - a) / (wall / 4) for a, b in zip(edges, edges[1:])]


def print_quarters(marks, t0, wall, rays_per_step):
    """One line on standard error: the rays per second of each quarter of
    the window."""
    rates = quarter_rates(marks, t0, wall)
    print("window quarters, rays/s: "
          + " ".join(f"{r * rays_per_step:.1f}" for r in rates),
          file=sys.stderr, flush=True)


def release(device):
    """Return the memory of objects the caller has dropped."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def loss_gap(prog, ref):
    """The largest relative gap of the program's step losses from the
    reference's."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def rms_gap(prog, ref):
    """The root mean square of the step losses' relative gaps."""
    gaps = [((p - r) / max(abs(r), 1e-30)) ** 2 for p, r in zip(prog, ref)]
    return math.sqrt(sum(gaps) / len(gaps)) if gaps else float("nan")


def _worst(values):
    """The largest value, NaN when any is NaN."""
    values = list(values)
    return (float("nan") if any(v != v for v in values)
            else max(values))


def gap_spread(prog, ref):
    """The population standard deviation of the step losses' relative
    gaps about their mean."""
    gaps = [(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]
    if not gaps:
        return float("nan")
    mean = sum(gaps) / len(gaps)
    return math.sqrt(sum((g - mean) ** 2 for g in gaps) / len(gaps))


def leaf_gap(prog, ref, keep=None):
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger; ``keep`` names the leaves compared (all when
    None)."""
    names = [k for k in ref if keep is None or k in keep]
    ref_n = {k: norm(ref[k]) for k in names}
    med = sorted(ref_n.values())[len(names) // 2]
    return _worst(abs(norm(prog[k]) - ref_n[k]) / max(ref_n[k], med, 1e-30)
                  for k in names)


def leaf_dev(prog, ref, keep=None):
    """The worst leaf's deviation, the norm of the program's difference from
    the reference over the reference's norm of that leaf or of the median
    leaf, whichever is larger: unlike :func:`leaf_gap` it sees a sign."""
    names = [k for k in ref if keep is None or k in keep]
    ref_n = {k: norm(ref[k]) for k in names}
    med = sorted(ref_n.values())[len(names) // 2]
    return _worst(norm(prog[k] - ref[k]) / max(ref_n[k], med, 1e-30)
                  for k in names)


def first_gradient(moment1, like):
    """Each leaf's first gradient from Adam's first moment after one step,
    m / (1 - beta1); NaN for a leaf that Adam never stepped."""
    return {k: moment1[k] / 0.1 if k in moment1
            else torch.full_like(t, float("nan")) for k, t in like.items()}


def rel_dev(prog, ref):
    """The program's deviation from the reference, ||prog - ref|| /
    ||ref||."""
    return norm(prog - ref) / max(norm(ref), 1e-30)


def moving_leaves(first_grads):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone, so their
    change is not compared."""
    n = {k: norm(g) for k, g in first_grads.items()}
    med = sorted(n.values())[len(n) // 2]
    return {k for k, v in n.items() if v >= 1e-3 * med}


def finite(x):
    return x == x and not math.isinf(x)
