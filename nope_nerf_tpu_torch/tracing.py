"""The port's own tracing of its training and pose steps: host spans, the
device sections of a step, and the device span of each dispatch.

Host spans (:func:`span`). A span records its name, its start and end on
the host clock (``time.perf_counter_ns``), its parent (the innermost span
open when it opened) and the number of the dispatch it belongs to. The
last :data:`RING` spans are kept in memory, with per-name totals (count,
sum, max: :func:`totals`). While a ``torch.profiler`` session records, a
span also opens ``torch.profiler.record_function`` of its name, so that it
lies in the profiler's trace on the device's timeline: in a traced
benchmark run and in ``tpu.profile_dir``'s trace. Names are ``dispatch``
and ``dispatch.*`` (the host's side of one call of ``EpochStep`` or
``PoseOptBlock``) and ``step.*`` (the sections below).

Device sections (:func:`section`). Inside a step that
``training/capture.py::StepGraphs`` runs for ``EpochStep`` (phase "train")
or ``PoseOptBlock`` ("pose_opt"), each call of ``section(name)`` is a
boundary: it records a timing CUDA event and opens the host span ``name``.
A section is the interval from its boundary to the next one; the step's
last boundary (:data:`END`) follows its aux bookkeeping, so the sections
tile the step. In a step being captured into a CUDA graph the events are
external (``torch.cuda.Event(external=True)``): each is an event-record
node of the graph, recorded again by every replay of it. ``StepGraphs``
replays that graph as the last step of each call, and a capture of the
same step without the events as the others. A boundary whose name extends
the open section's (``step.backward.field`` inside ``step.backward``)
nests its host span in that section's, and a boundary that names an open
section resumes it. Outside such a step ``section`` does nothing
(``render_image``, a bare ``fused_mlp_composite``, ``train()``'s per-step
route). :func:`section_ms` reads the sections of a phase's last replay, or
of its last eager step (the warm-up of a captured step, or any step of the
eager route), in device ms; on the CPU there are no events, only the host
spans.

Dispatches (:func:`dispatch`). Each call of ``EpochStep`` or
``PoseOptBlock`` is one dispatch: a host span ``dispatch``, and a
:class:`DeviceTimer` around its work, whose pair of events is taken from a
recycled pool and read only once its end has been reached
(``Event.query``), so that nothing waits. Its :class:`Dispatch` record
(number, phase, steps, device ms, host ns of its spans by name) is kept in
a ring like the spans; :func:`dispatches` lists them.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# spans and dispatch records kept in memory
RING = 4096
# the step's last boundary, after its aux bookkeeping: no section
END = "step.end"


class SpanRecord(collections.namedtuple(
        "SpanRecord", "name start_ns end_ns parent dispatch")):
    """One closed host span: ``parent`` is the name of the innermost span
    open when it opened (None at the top), ``dispatch`` the number of the
    dispatch it belongs to (None outside one)."""

    @property
    def ns(self):
        return self.end_ns - self.start_ns


class _Open:
    __slots__ = ("name", "parent", "dispatch", "fn", "start")

    def __init__(self, name, parent, dispatch, fn, start):
        self.name, self.parent, self.dispatch = name, parent, dispatch
        self.fn, self.start = fn, start


# event pairs of read DeviceTimers, for the next ones
_PAIRS = []


class DeviceTimer:
    """Seconds on the device's timeline from :meth:`__init__` to
    :meth:`stop`: the span between two CUDA events (a pair taken from a
    pool that reading returns it to), idle time between kernels included,
    so near the kernels' time where the host queues ahead and near the
    wall time where it waits for each step. None off CUDA, where no device
    time is measured."""

    def __init__(self, device):
        self.events, self.value = None, None
        if torch.device(device).type == "cuda":
            self.events = _PAIRS.pop() if _PAIRS else tuple(
                torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.events[0].record()

    def stop(self):
        if self.events is not None:
            self.events[1].record()

    def done(self):
        """Whether :meth:`seconds` can be read without waiting."""
        return self.events is None or self.events[1].query()

    def seconds(self, wait=True):
        """The span in seconds (None off CUDA); without ``wait``, None
        while the device has not reached its end."""
        if self.events is None:
            return self.value
        if not wait and not self.events[1].query():
            return None
        self.events[1].synchronize()
        self.value = self.events[0].elapsed_time(self.events[1]) / 1e3
        _PAIRS.append(self.events)
        self.events = None
        return self.value


class Dispatch:
    """One dispatch: its ``number`` (from 1 in a process), ``phase``,
    ``steps``, the host ns of each span name within it (``host``, the
    dispatch span itself under ``dispatch``), the host ns of its fastest
    graph replay (``replay_min_ns``, None without one), whether every
    earlier dispatch had finished on the device when it began (``idle``)
    and its :class:`DeviceTimer`.

    A replay's host span is its launch while the device's queue has room;
    once ~40 replays wait in it, each further call waits for one to finish
    (PERF.md), so in a dispatch issued behind a busy device the replay
    spans read the device's time, and the fastest replay of one issued
    onto an idle device reads the launch alone."""

    def __init__(self, number, phase, steps, timer, idle=True):
        self.number, self.phase, self.steps = number, phase, steps
        self.host = {}
        self.replay_min_ns = None
        self.idle = idle
        self.timer = timer

    def device_ms(self, wait=True):
        """The dispatch's device ms (None off CUDA, or without ``wait``
        while the device has not finished it)."""
        s = self.timer.seconds(wait)
        return None if s is None else 1e3 * s


class Sections:
    """The boundaries of one step of ``phase``: their names in order (the
    last :data:`END`) and, on CUDA, a timing event each, external when
    ``captured`` (the events become nodes of the step's graph). An eager
    step records into the same events each time it runs."""

    def __init__(self, phase, captured, device):
        self.phase, self.captured = phase, captured
        self.cuda = torch.device(device).type == "cuda"
        self.names, self.events = [], []
        self.marked = 0

    def reserve(self, n):
        """Create ``n`` events before a capture (an event's handle is made
        at its first record, which a capturing stream turns into a node)."""
        while len(self.events) < n and self.cuda:
            e = self._event()
            e.record()
            self.events.append(e)

    def _event(self):
        return torch.cuda.Event(enable_timing=True, external=self.captured)

    def mark(self, name):
        i = self.marked
        self.marked += 1
        if i < len(self.names):
            self.names[i] = name
        else:
            self.names.append(name)
        if self.cuda:
            if i == len(self.events):
                self.events.append(self._event())
            self.events[i].record()

    def read(self, wait=True):
        """{section: device ms} of the last recording of these boundaries
        (None on the CPU, or without ``wait`` while the device has not
        passed its last boundary)."""
        n = len(self.names)
        if not self.cuda or n < 2:
            return None
        last = self.events[n - 1]
        if not wait and not last.query():
            return None
        last.synchronize()
        out = {}
        for name, a, b in zip(self.names, self.events, self.events[1:n]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


class _State:
    def __init__(self):
        self.spans = collections.deque(maxlen=RING)
        self.totals = {}
        self.open = []
        self.dispatches = collections.deque(maxlen=RING)
        self.unread = collections.deque()
        self.number = 0
        self.dispatch = None
        self.step = None
        self.sections = []
        self.last = {}


_S = _State()


def reset():
    """Forget every span, total, dispatch and section recorded so far."""
    global _S
    _S = _State()


def _push(name):
    fn = None
    if _autograd_profiler._is_profiler_enabled:
        fn = torch.profiler.record_function(name)
        fn.__enter__()
    d = _S.dispatch
    o = _Open(name, _S.open[-1].name if _S.open else None,
              None if d is None else d.number, fn, time.perf_counter_ns())
    _S.open.append(o)
    return o


def _pop(o):
    end = time.perf_counter_ns()
    if o not in _S.open:
        return
    while _S.open:  # spans left open inside this one close with it
        top = _S.open.pop()
        if top.fn is not None:
            top.fn.__exit__(None, None, None)
        ns = end - top.start
        _S.spans.append(SpanRecord(top.name, top.start, end, top.parent,
                                   top.dispatch))
        t = _S.totals.get(top.name)
        if t is None:
            _S.totals[top.name] = [1, ns, ns]
        else:
            t[0] += 1
            t[1] += ns
            t[2] = max(t[2], ns)
        d = _S.dispatch
        if d is not None and top.dispatch == d.number:
            d.host[top.name] = d.host.get(top.name, 0) + ns
            if top.name == "dispatch.replay" and (
                    d.replay_min_ns is None or ns < d.replay_min_ns):
                d.replay_min_ns = ns
        if top is o:
            return


@contextlib.contextmanager
def span(name):
    """A host span named ``name`` around the block."""
    o = _push(name)
    try:
        yield
    finally:
        _pop(o)


def spans():
    """The kept :class:`SpanRecord` s, oldest first."""
    return list(_S.spans)


def totals():
    """{name: (count, sum ns, max ns)} over every span closed so far."""
    return {k: tuple(v) for k, v in _S.totals.items()}


def _read_unread(wait):
    """Read the device time of finished dispatches, oldest first, so that
    their event pairs return to the pool; with ``wait`` every one."""
    while _S.unread and (wait or _S.unread[0].timer.done()):
        _S.unread.popleft().timer.seconds()


@contextlib.contextmanager
def dispatch(phase, steps, device):
    """One dispatch of ``steps`` steps of ``phase`` on ``device``: the host
    span ``dispatch`` and a device span around the block, kept as a
    :class:`Dispatch`, which the block receives."""
    _read_unread(False)
    _S.number += 1
    rec = Dispatch(_S.number, phase, steps, None, idle=not _S.unread)
    outer, _S.dispatch = _S.dispatch, rec
    o = _push("dispatch")
    rec.timer = DeviceTimer(device)
    try:
        yield rec
    finally:
        rec.timer.stop()
        _pop(o)
        _S.dispatch = outer
        _S.dispatches.append(rec)
        if rec.timer.events is not None:
            _S.unread.append(rec)


def dispatches(phase=None):
    """The kept :class:`Dispatch` records (of ``phase``), oldest first, each
    with its device time read (waiting for the device where it has not
    finished)."""
    _read_unread(True)
    return [d for d in _S.dispatches if phase is None or d.phase == phase]


@contextlib.contextmanager
def step(sections):
    """Record the block's boundaries into ``sections`` (a
    :class:`Sections`): one step. The last boundary, :data:`END`, is
    marked when the block ends."""
    sections.marked = 0
    _S.step = sections
    try:
        yield
        section(END)
        del sections.names[sections.marked:]
    finally:
        if _S.sections:
            _pop(_S.sections[0])
        _S.sections, _S.step = [], None
    if not sections.captured:
        _S.last[(sections.phase, False)] = sections


def replayed(sections):
    """Note that the captured step of ``sections`` was replayed: it is the
    phase's last replay until another is."""
    _S.last[(sections.phase, True)] = sections


def section(name):
    """A boundary of the open step (nothing outside one): the section
    ``name`` starts here."""
    s = _S.step
    if s is None:
        return
    open_ = _S.sections
    while open_ and not (name == open_[-1].name
                         or name.startswith(open_[-1].name + ".")):
        _pop(open_.pop())
    if name != END and not (open_ and open_[-1].name == name):
        open_.append(_push(name))
    s.mark(name)


def section_ms(phase, eager=False, wait=True):
    """{section: device ms} of the last replay of ``phase``'s captured step,
    or with ``eager`` of its last eager step; waits for the device unless
    ``wait`` is False (then None while it has not passed the last
    boundary). None when nothing was recorded, and on the CPU."""
    s = _S.last.get((phase, not eager))
    return None if s is None else s.read(wait)
