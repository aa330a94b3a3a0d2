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

Launch counts: a kernel wrapper called while the stream captures counts
its launch in ``LaunchCounter.captured``; each graph keeps its own share
(:class:`LaunchRecord`: the launches of one replay) and its replays, so
the launches a graph ran are ``launches * replays``
(:func:`replayed_launches`).
"""
from __future__ import annotations

import torch

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
    """One captured step: its graph, its :class:`LaunchRecord`, and the
    tensors and generators it was captured on."""

    def __init__(self, graph, record, generators, tensors):
        self.graph = graph
        self.record = record
        self.generators = tuple(generators)
        self.storage = _storage(tensors)

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

    def replay(self):
        self.graph.replay()
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
    key in one graph pool, or with ``eager`` the step function as it is."""

    def __init__(self, device, eager=False):
        device = torch.device(device)
        if not eager and device.type != "cuda":
            raise ValueError(f"no CUDA graph on {device}: only eager steps")
        self.device, self.eager = device, eager
        self.pool = None if eager else torch.cuda.graph_pool_handle()
        self.graphs = {}
        self.warmups = 0

    @property
    def route(self):
        return "eager" if self.eager else "cuda graph"

    def run(self, key, fn, n, generators=(), inputs=()):
        """Run ``fn`` as ``n`` steps of ``key``: replays of its graph, or
        for a new key an eager warm-up step on a side stream, its capture
        and n - 1 replays. ``fn`` must read and write only tensors that
        outlive the graph (it may allocate temporaries), and synchronise
        nothing with the host. ``generators`` are the explicit
        ``torch.Generator`` s it draws from: the graph registers them, so
        every replay draws what an eager step would at the generator's
        state and advances it as that step would. ``inputs()`` lists the
        tensors that ``fn`` reads or writes in place (:func:`bound_tensors`
        of its arguments); a replay on other tensors or generators than
        the capture's raises."""
        if self.eager:
            for _ in range(n):
                fn()
            return
        if n <= 0:
            return
        captured = self.graphs.get(key)
        if captured is None:
            self.warm_up(fn)
            captured = self.graphs[key] = self.capture(
                key, fn, generators, inputs)
            n -= 1
        else:
            captured.check(generators, _listed(inputs))
        for _ in range(n):
            captured.replay()

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
        warm-up has made the optimiser state) and ``generators``."""
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = [c.captured for c in LaunchCounter.all]
        with torch.cuda.graph(graph, pool=self.pool):
            fn()
        launches = {c.name: c.captured - b
                    for c, b in zip(LaunchCounter.all, before)
                    if c.captured != b}
        rec = LaunchRecord(key, launches)
        _RECORDS.append(rec)
        return CapturedStep(graph, rec, generators, _listed(inputs))
