"""CUDA graphs of one step: the port's counterpart of the JAX package's
``lax.scan`` dispatch (``make_epoch_step``, ``make_pose_opt_block``).

The JAX package runs a whole epoch (or a block of pose-optimisation steps)
as one device dispatch so that the host leaves the step. On the card the
port captures ONE step into a ``torch.cuda.CUDAGraph`` and replays it once
per step: a device counter that the step itself advances selects the
step's inputs from static buffers, in the role of the scan's xs.

:class:`StepGraphs` owns one graph pool shared by every graph it captures,
a cache of graphs by key (the JAX package re-traces per ``static``, the
port captures per key), the warm-up and the replay counts, and runs the
n steps of a call (:meth:`StepGraphs.run`). A key's first step runs
eagerly on a side stream (the warm-up, which creates the optimiser state
and builds the kernels) and counts as a real step; the capture that
follows records the same step without running it, and every later step of
that key is a replay. A capture that fails raises: nothing falls back to
eager steps. A replay reads and writes the storage it was captured on, so
a later call whose tensors or generators lie elsewhere raises too. With
``eager`` (the reference route, and the only one on the CPU) the same
steps run as they are.

Sections: a :class:`StepGraphs` made with a ``phase`` runs its warm-up
and eager steps inside ``tracing.step``, so the step's
``tracing.section`` boundaries record timing events (``tracing.py``), and
captures each key's step twice: once as it is, and once inside
``tracing.step``, whose boundaries become external event-record nodes of
that second graph. The last step of each call is a replay of the second
graph, every other step a replay of the first: each node stalls the step
by ~4 us, 0.8% of a stock training step and 3% of a pose step when every
replay carried them (PERF.md), while one timed step a call leaves the
section times of the call's last step. Each replay opens the host span
``dispatch.replay``.

Launch counts: a kernel wrapper called while the stream captures counts
its launch in ``LaunchCounter.captured``; each graph keeps its own share
(:class:`LaunchRecord`: the launches of one replay) and its replays, so
the launches a graph ran are ``launches * replays``
(:func:`replayed_launches`).
"""
from __future__ import annotations

import torch

from .. import tracing
from ..ops.kernels import LaunchCounter


class LaunchRecord:
    """The kernel launches of one replay of a graph, and its replays."""

    def __init__(self, key, launches):
        self.key = key
        self.launches = launches
        self.replays = 0


# one record per graph captured in this process (the graphs themselves
# belong to their StepGraphs), for replayed_launches
_RECORDS = []


class CapturedStep:
    """One captured step: its graph, its :class:`LaunchRecord`, the
    tensors and generators it was captured on, and with a phase the same
    step captured with its section events (``timed``) and their
    ``tracing.Sections`` (both None without)."""

    def __init__(self, graph, record, generators, tensors, timed=None,
                 sections=None):
        self.graph, self.timed = graph, timed
        self.record = record
        self.generators = tuple(generators)
        self.storage = _storage(tensors)
        self.sections = sections

    def check(self, generators, tensors):
        """Raise unless ``generators`` and ``tensors`` are those of the
        capture: a replay would update those and leave these untouched."""
        if (len(generators) != len(self.generators)
                or any(a is not b for a, b in zip(generators,
                                                  self.generators))
                or _storage(tensors) != self.storage):
            raise ValueError(
                f"the graph of step {self.record.key!r} was captured on "
                "other tensors or generators than this call's: a replay "
                "reads and writes the storage of its capture")

    def replay(self, timed=False):
        """One replay: of the graph with the section events when ``timed``
        and there is one."""
        graph = self.timed if timed and self.timed is not None else self.graph
        with tracing.span("dispatch.replay"):
            graph.replay()
        self.record.replays += 1


def _listed(inputs):
    return inputs() if callable(inputs) else list(inputs)


def _storage(tensors):
    return [(t.data_ptr(), tuple(t.shape)) for t in tensors]


def bound_tensors(*objs):
    """The tensors of ``objs`` that a step reads or writes in place: those
    in nested dicts, lists and tuples, and of a ``torch.optim.Optimizer``
    its parameters, their state and its tensor learning rates."""
    out = []
    for obj in objs:
        if torch.is_tensor(obj):
            out.append(obj)
        elif isinstance(obj, dict):
            out.extend(bound_tensors(*obj.values()))
        elif isinstance(obj, (list, tuple)):
            out.extend(bound_tensors(*obj))
        elif isinstance(obj, torch.optim.Optimizer):
            for group in obj.param_groups:
                out.extend(bound_tensors(group["params"], group["lr"]))
                for p in group["params"]:
                    st = obj.state.get(p, {})
                    out.extend(bound_tensors(*(st[k] for k in sorted(st))))
    return out


def replayed_launches():
    """{kernel name: launches run by graph replays} over every graph
    captured since the last :func:`reset_replays`."""
    out = {c.name: 0 for c in LaunchCounter.all}
    for rec in _RECORDS:
        for name, n in rec.launches.items():
            out[name] += n * rec.replays
    return out


def executed_launches():
    """{kernel name: launches run} -- the eager ones of each counter plus
    those of every graph replay."""
    replayed = replayed_launches()
    return {c.name: c.count + replayed[c.name] for c in LaunchCounter.all}


def records():
    """The :class:`LaunchRecord` of every graph captured so far."""
    return list(_RECORDS)


def reset_replays():
    """Set every graph's replay count to 0."""
    for rec in _RECORDS:
        rec.replays = 0


class StepGraphs:
    """The steps of one device by key: replays of one captured graph per
    key in one graph pool, or with ``eager`` the step function as it is.
    With ``phase`` ("train", "pose_opt") the steps record their
    ``tracing`` sections."""

    def __init__(self, device, eager=False, phase=None):
        device = torch.device(device)
        if not eager and device.type != "cuda":
            raise ValueError(f"no CUDA graph on {device}: only eager steps")
        self.device, self.eager, self.phase = device, eager, phase
        self.pool = None if eager else torch.cuda.graph_pool_handle()
        self.graphs = {}
        self.warmups = 0
        self.eager_sections = {}

    def _traced(self, key, fn, sections=None):
        """``fn`` as one step recording its sections: into ``sections``, or
        into the key's eager ones; ``fn`` itself without a phase."""
        if self.phase is None:
            return fn
        if sections is None:
            sections = self.eager_sections.get(key)
            if sections is None:
                sections = self.eager_sections[key] = tracing.Sections(
                    self.phase, False, self.device)

        def traced():
            with tracing.step(sections):
                fn()

        return traced

    @property
    def route(self):
        return "eager" if self.eager else "cuda graph"

    def run(self, key, fn, n, generators=(), inputs=()):
        """Run ``fn`` as ``n`` steps of ``key``: replays of its graph (the
        last one of the timed graph, with a phase), or for a new key an
        eager warm-up step on a side stream, its capture and n - 1
        replays. ``fn`` must read and write only tensors that
        outlive the graph (it may allocate temporaries), and synchronise
        nothing with the host. ``generators`` are the explicit
        ``torch.Generator`` s it draws from: the graph registers them, so
        every replay draws what an eager step would at the generator's
        state and advances it as that step would. ``inputs()`` lists the
        tensors that ``fn`` reads or writes in place (:func:`bound_tensors`
        of its arguments); a replay on other tensors or generators than
        the capture's raises."""
        if self.eager:
            step = self._traced(key, fn)
            for _ in range(n):
                step()
            return
        if n <= 0:
            return
        captured = self.graphs.get(key)
        if captured is None:
            self.warm_up(self._traced(key, fn))
            captured = self.graphs[key] = self.capture(
                key, fn, generators, inputs)
            n -= 1
        else:
            captured.check(generators, _listed(inputs))
        for i in range(n):
            captured.replay(timed=i == n - 1)
        if n and captured.sections is not None:
            tracing.replayed(captured.sections)

    def warm_up(self, fn):
        """Run ``fn`` once eagerly on a side stream, ordered with the
        current stream (the first step of a key)."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)
        self.warmups += 1

    def capture(self, key, fn, generators=(), inputs=()):
        """Record ``fn`` into a new graph in this pool (nothing runs), on
        the tensors ``inputs`` (a list, or a function giving it once the
        warm-up has made the optimiser state) and ``generators``; with a
        phase, again into a second graph with its section events."""
        before = [c.captured for c in LaunchCounter.all]
        graph = self._graph(fn, generators)
        launches = {c.name: c.captured - b
                    for c, b in zip(LaunchCounter.all, before)
                    if c.captured != b}
        rec = LaunchRecord(key, launches)
        _RECORDS.append(rec)
        timed = sections = None
        if self.phase is not None:
            sections = tracing.Sections(self.phase, True, self.device)
            warm = self.eager_sections.get(key)
            sections.reserve(len(warm.names) if warm is not None else 0)
            timed = self._graph(self._traced(key, fn, sections), generators)
        return CapturedStep(graph, rec, generators, _listed(inputs), timed,
                            sections)

    def _graph(self, fn, generators):
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self.pool):
            fn()
        return graph
