"""Spans and counters inside the served path, on the port's telemetry
registry (``core.telemetry.MetricRegistry``), with device time that holds
inside a CUDA graph.

Three helpers, for the serving steps and the model code under them:

* :func:`host_span` is ``telemetry.span`` and, while a profiler records,
  a ``torch.profiler.record_function`` of the same name, so a program span
  sits in the profiler's trace too, stamped by the clock the trace uses
  (``Span.start`` is ``time.time()``);
* :func:`device_span` records a pair of CUDA timing events on the current
  stream. While the stream captures a graph the events are
  ``external=True``, so they become event-record nodes of the graph and
  fire on every replay; the graph's owner hands them back after each
  replay (:func:`replayed`). On a CPU device the host clock stands in
  (CPU operations run synchronously). A name that starts with ``.`` is
  taken relative to the innermost device span open: ``.route`` inside
  ``decode.ffn`` is ``decode.ffn.route``. :func:`phases` opens device
  spans one after another without a ``with`` block each;
* :func:`device_counter` adds a count on the device into a persistent
  int64 tensor (allocated outside any capture, so a captured add adds on
  every replay), folded into the registry's ``Counter`` of that name when
  the :class:`Timeline` closes.

Host spans are on while an ambient trace of a registry is open on the
calling thread (``MetricRegistry.trace``). Device spans and counters need,
besides, a :class:`Timeline` open on the thread: a trace alone times the
host (a profiled section keeps the plain graph), a timeline adds the
device. Outside them every helper is the shared null object, and
``GraphedServeStep`` replays the graph it captures without one: no extra
node. With a timeline open it times each replay from outside the graph
(``decode.graph``) and, where the timeline asks for the layers
(:attr:`Timeline.layers`), replays a graph variant of its own, captured
with the spans inside (``serve/serve_step.py``).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from ..core import telemetry

COUNTER_SLOTS = 32                     # distinct device counter names


class _Null:
    """The shared no-op span: a context manager with nothing to record."""

    __slots__ = ()

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL = _Null()
_STATE = threading.local()   # .timelines: those open, None where paused
_COUNTS: Dict[torch.device, torch.Tensor] = {}   # device -> counts
_SLOTS: Dict[str, int] = {}            # counter name -> index in counts


class _Record:
    """A device span: its name and start and end marks (CUDA events, or
    host-clock seconds on a CPU device)."""

    __slots__ = ("name", "start", "end")

    def __init__(self, name: str) -> None:
        self.name = name
        self.start = self.end = None


# (name, start ms, end ms), the times from the timeline's anchor
Interval = Tuple[str, float, float]


def _counts(device: torch.device) -> torch.Tensor:
    t = _COUNTS.get(device)
    if t is None:
        t = _COUNTS[device] = torch.zeros(COUNTER_SLOTS, dtype=torch.int64,
                                          device=device)
    return t


class Timeline:
    """The device spans and counters of one section of an ambient trace.

    ``with Timeline(device) as tl:`` inside ``registry.trace(...)``: an
    anchor mark is recorded on entry, so every span reads as milliseconds
    from it; :meth:`read` turns the spans recorded since the last read into
    :data:`Interval`\\ s, waiting for the device to reach them. On exit
    what the device counts gained since the entry is folded into the
    registry's counters (one read-back) and unread spans are dropped.

    Spans of a graph replay are the same events on every replay: read them
    before the next replay, or they are dropped when it comes
    (:meth:`replayed`). :attr:`layers` chooses what a graph replay
    records: True (the default), the graph captured with the spans inside
    it; False, the plain graph, timed as a whole from outside (the
    events inside a graph take device time of their own)."""

    def __init__(self, device: torch.device) -> None:
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        if self.cuda and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.registry: Optional[telemetry.MetricRegistry] = None
        self.pending: List[_Record] = []
        self._open: List[str] = []
        self.anchor = None
        self._base: Optional[torch.Tensor] = None
        self.layers = True

    def __enter__(self) -> "Timeline":
        self.registry = telemetry.ambient_registry()
        if self.registry is None:
            raise RuntimeError("a Timeline opens inside an ambient trace "
                               "(MetricRegistry.trace)")
        if self.cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("open the Timeline before the capture")
        self._base = _counts(self.device).clone()
        self.anchor = self._mark()
        stack = getattr(_STATE, "timelines", None)
        if stack is None:
            stack = _STATE.timelines = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _STATE.timelines
        if not stack or stack[-1] is not self:
            raise RuntimeError("unbalanced Timeline")
        stack.pop()
        self.pending.clear()
        counts = (_counts(self.device) - self._base).tolist()
        for name, slot in _SLOTS.items():
            if counts[slot]:
                self.registry.counter(name).inc(counts[slot])
        return False

    # -- recording ------------------------------------------------------------
    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        capturing = torch.cuda.is_current_stream_capturing()
        ev = torch.cuda.Event(enable_timing=True, external=capturing)
        ev.record()
        return ev

    def span(self, name: str) -> "_DeviceSpan":
        if name.startswith("."):
            name = (self._open[-1] if self._open else "") + name
            name = name.lstrip(".")
        return _DeviceSpan(self, name)

    def count(self, name: str, value: Union[int, torch.Tensor]) -> None:
        slot = _SLOTS.get(name)
        if slot is None:
            if len(_SLOTS) == COUNTER_SLOTS:
                raise ValueError(f"more than {COUNTER_SLOTS} device counters")
            slot = _SLOTS[name] = len(_SLOTS)
        _counts(self.device)[slot].add_(value)

    def mark(self) -> int:
        """Where the spans recorded from now on start (:meth:`take`)."""
        return len(self.pending)

    def take(self, mark: int) -> List[_Record]:
        """The spans recorded since ``mark``, taken out of the pending ones
        (a capture's: they fire when the graph replays)."""
        out = self.pending[mark:]
        del self.pending[mark:]
        return out

    def replayed(self, records: Sequence[_Record]) -> None:
        """A graph holding ``records`` was replayed: they are pending, and
        any still pending from its last replay are gone (overwritten)."""
        ids = {id(r) for r in records}
        self.pending = [r for r in self.pending if id(r) not in ids]
        self.pending.extend(records)

    # -- reading --------------------------------------------------------------
    def read(self) -> List[Interval]:
        """The pending spans, in the order they were opened, as
        milliseconds from the anchor; waits for the device to reach the
        last of them."""
        recs, self.pending = self.pending, []
        if not recs:
            return []
        if self.cuda:
            torch.cuda.synchronize(self.device)
            at = self.anchor.elapsed_time
        else:
            anchor = self.anchor

            def at(t):
                return (t - anchor) * 1e3
        return [(r.name, at(r.start), at(r.end)) for r in recs]


class _DeviceSpan:
    __slots__ = ("_tl", "_rec")

    def __init__(self, tl: Timeline, name: str) -> None:
        self._tl = tl
        self._rec = _Record(name)

    def __enter__(self) -> "_DeviceSpan":
        tl, rec = self._tl, self._rec
        tl._open.append(rec.name)
        tl.pending.append(rec)
        rec.start = tl._mark()
        return self

    def __exit__(self, *exc) -> bool:
        self._rec.end = self._tl._mark()
        self._tl._open.pop()
        return False


class _HostSpan:
    __slots__ = ("_span", "_fn")

    def __init__(self, name: str) -> None:
        self._span = telemetry.span(name)
        # in the profiler's trace too, where one records
        self._fn = (torch.profiler.record_function(name)
                    if torch.autograd._profiler_enabled() else None)

    def __enter__(self):
        span = self._span.__enter__()
        if self._fn is not None:
            self._fn.__enter__()
        return span

    def __exit__(self, *exc) -> bool:
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return self._span.__exit__(*exc)


def timeline() -> Optional[Timeline]:
    """The innermost :class:`Timeline` open on this thread, or None (none,
    or :func:`paused`)."""
    stack = getattr(_STATE, "timelines", None)
    return stack[-1] if stack else None


def host_span(name: str):
    """A span of the ambient trace, also in a profiler trace; :data:`NULL`
    outside a trace."""
    if telemetry.ambient_registry() is None:
        return NULL
    return _HostSpan(name)


def device_span(name: str):
    """A device span of the open timeline (module docstring); :data:`NULL`
    without one."""
    tl = timeline()
    return NULL if tl is None else tl.span(name)


def _no_phase(name: Optional[str]) -> None:
    """The phases without a timeline (:func:`phases`): nothing."""


class _Phases:
    __slots__ = ("_tl", "_span")

    def __init__(self, tl: Timeline) -> None:
        self._tl = tl
        self._span: Optional[_DeviceSpan] = None

    def __call__(self, name: Optional[str]) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if name is not None:
            self._span = self._tl.span(name).__enter__()


def phases():
    """Device spans one after another at one level, for a function whose
    parts follow each other: ``phase = phases()``, then ``phase(name)``
    closes the span it opened last and opens ``name``, ``phase(None)``
    closes it. Without a timeline, a function that does nothing."""
    tl = timeline()
    return _no_phase if tl is None else _Phases(tl)


def device_counter(name: str, value: Union[int, torch.Tensor]) -> None:
    """Adds ``value`` (an int, or a 0-d integer tensor on the timeline's
    device) to the device counter ``name``; nothing without a timeline.
    Where ``value`` costs an operation, test :func:`timeline` first."""
    tl = timeline()
    if tl is not None:
        tl.count(name, value)


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """No timeline inside the block (a plain graph's capture)."""
    stack = getattr(_STATE, "timelines", None)
    if stack is None:
        stack = _STATE.timelines = []
    stack.append(None)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def discarded() -> Iterator[None]:
    """Device spans and counts made inside the block are thrown away (a
    warm-up's before a capture): the pending spans are cut back and the
    counts restored on the device."""
    tl = timeline()
    if tl is None:
        yield
        return
    mark, counts = tl.mark(), _counts(tl.device)
    saved = counts.clone()
    try:
        yield
    finally:
        del tl.pending[mark:]
        counts.copy_(saved)


def replayed(records: Sequence[_Record]) -> None:
    """A graph captured with ``records`` was replayed
    (:meth:`Timeline.replayed` on the open timeline)."""
    tl = timeline()
    if tl is not None and records:
        tl.replayed(records)
