"""Unified telemetry plane: metric registry + pipeline-wide tracing.

The engine reproduces a filesystem's *synthetic understanding* — this
module gives the engine the same treatment. Every pre-existing ad-hoc
counter (``Catalog.arrays_calls``, ``Reports.store_served``, the device
store's tiering/permission counters, ...) is now a series in one
:class:`MetricRegistry`, readable through the old attribute APIs via
thin compatibility descriptors, exportable as a nested dict
(:meth:`MetricRegistry.snapshot`) or Prometheus text exposition format
(:meth:`MetricRegistry.render_prometheus`), and resettable at a scrape
boundary (:meth:`MetricRegistry.reset`).

Topology: one registry per catalog "deployment". ``Catalog`` creates (or
accepts) a registry; everything attached to that catalog — device store,
reports facade, profile cube, policy engine, event pipeline, changelog
streams — lands its series in the same registry, disambiguated by an
``instance`` style label (``store0``, ``reports1``, ...) handed out by
:meth:`MetricRegistry.instance`. Pass one shared registry to several
catalogs to aggregate a whole process; pass
``MetricRegistry(enabled=False)`` to run uninstrumented
(``benchmarks/bench_telemetry.py`` holds the overhead contract:
instrumented warm match/serve throughput >= 0.95x uninstrumented).

Metric kinds
------------
* :class:`Counter` — monotone float, ``inc``/``add``; compat writes via
  ``set_to`` keep ``obj.counter += 1`` working through
  :class:`counter_attr` descriptors.
* :class:`Gauge` — last-set value, or registered callbacks evaluated at
  collection time (:meth:`MetricRegistry.register_callback` — the
  changelog backlog/lag gauges read live stream state this way).
* :class:`Histogram` — bounded memory: fixed bucket edges chosen at
  creation, counts + sum only (no samples kept). ``percentile`` answers
  p50/p99 by linear interpolation inside the winning bucket.
* :class:`TextState` — a single descriptive string (e.g.
  ``Reports.last_fallback_reason``), rendered as an info-gauge.

Tracing
-------
:meth:`MetricRegistry.trace` opens a span: wall-clock timed, nested
per-thread (a ``trace`` inside an active trace of the same registry
becomes a child), thread-safe (each thread owns its ambient stack;
spans from other threads become root spans). Completed root spans land
in a bounded ring buffer and every span close feeds the
``span_seconds{span=...}`` histogram. Device work is dispatched async —
a span around a kernel launch times the *dispatch* unless the caller
opts in to a device sync: ``trace(name, sync=arrays)`` (or
``span.block_on(tensors)``) calls ``torch.cuda.synchronize()`` at close and
records the wait separately, so hot paths stay async by default.

Registry-less library code (``core.segments``, ``kernels/*/ops.py``)
instruments through the **ambient** helpers :func:`span` and
:func:`ambient_counter`: they attach to whatever trace is active on the
calling thread and are no-ops (a shared null object, no allocation)
otherwise.

Labels hold no wall-clock / date values — series cardinality is bounded
by instances x enum-like label values, never by time.
"""
from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "Span", "TextState",
    "ambient_counter", "ambient_registry", "counter_attr", "state_attr",
    "parse_prometheus", "span", "DEFAULT_LATENCY_EDGES",
]

# log-spaced seconds: 50us .. 10s — wide enough for a host fold at 1M
# rows, fine enough to split a warm mesh query from a cold upload
DEFAULT_LATENCY_EDGES: Tuple[float, ...] = (
    50e-6, 100e-6, 250e-6, 500e-6, 1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3,
    50e-3, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")
# one exposition line: name{labels} value  (labels optional)
_PROM_LINE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
    r' (-?(?:[0-9.eE+-]+|[Ii]nf|NaN))$')


def _sanitize_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"') \
                .replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Render integers without a trailing .0 (counters read naturally)."""
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotone counter series. ``set_to`` exists only for the
    compatibility descriptors (``obj.counter = 0`` in legacy ``__init__``
    bodies and ``+=`` through property get/set)."""

    __slots__ = ("_lock", "value", "_enabled")

    def __init__(self, enabled: List[bool]) -> None:
        self._lock = threading.Lock()
        self.value = 0.0
        self._enabled = enabled

    def inc(self, n: float = 1.0) -> None:
        if not self._enabled[0]:
            return
        with self._lock:
            self.value += n

    add = inc

    def set_to(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def reset(self) -> None:
        self.set_to(0.0)


class Gauge:
    """Last-set-value gauge series."""

    __slots__ = ("_lock", "value", "_enabled")

    def __init__(self, enabled: List[bool]) -> None:
        self._lock = threading.Lock()
        self.value = 0.0
        self._enabled = enabled

    def set(self, value: float) -> None:
        if not self._enabled[0]:
            return
        with self._lock:
            self.value = float(value)


class Histogram:
    """Fixed-bucket histogram: bounded memory regardless of observation
    count (``len(edges) + 1`` bucket counters + sum + count)."""

    __slots__ = ("_lock", "edges", "counts", "sum", "count", "_enabled")

    def __init__(self, edges: Tuple[float, ...],
                 enabled: List[bool]) -> None:
        if list(edges) != sorted(edges) or not edges:
            raise ValueError(f"histogram edges must be sorted, non-empty: "
                             f"{edges!r}")
        self._lock = threading.Lock()
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(edges) + 1)     # last = overflow (+Inf)
        self.sum = 0.0
        self.count = 0
        self._enabled = enabled

    def observe(self, value: float) -> None:
        if not self._enabled[0]:
            return
        idx = bisect.bisect_left(self.edges, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def percentile(self, q: float) -> float:
        """Approximate quantile (0..1): linear interpolation inside the
        winning bucket; 0.0 on an empty histogram."""
        with self._lock:
            total = self.count
            if not total:
                return 0.0
            target = q * total
            seen = 0
            for i, c in enumerate(self.counts):
                if seen + c >= target and c:
                    lo = self.edges[i - 1] if i else 0.0
                    hi = self.edges[i] if i < len(self.edges) \
                        else self.edges[-1]
                    frac = (target - seen) / c
                    return lo + (hi - lo) * min(1.0, max(0.0, frac))
                seen += c
            return self.edges[-1]

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * len(self.counts)
            self.sum = 0.0
            self.count = 0


class TextState:
    """A single descriptive string (``last_fallback_reason`` style):
    ``None`` means cleared — the exporter emits nothing for it."""

    __slots__ = ("_lock", "_value", "_enabled")

    def __init__(self, enabled: List[bool]) -> None:
        self._lock = threading.Lock()
        self._value: Optional[str] = None
        self._enabled = enabled

    def set(self, value: Optional[str]) -> None:
        with self._lock:
            self._value = value

    def get(self) -> Optional[str]:
        with self._lock:
            return self._value

    def reset(self) -> None:
        self.set(None)


def _holds_cuda(obj) -> bool:
    """True when ``obj`` (a tensor or a nest of lists/tuples/dicts of
    tensors) holds at least one CUDA tensor."""
    if isinstance(obj, dict):
        return any(_holds_cuda(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_holds_cuda(v) for v in obj)
    return bool(getattr(obj, "is_cuda", False))


class Span:
    """One timed region. Built by :meth:`MetricRegistry.trace`; children
    attach from nested traces on the same thread."""

    __slots__ = ("name", "attrs", "start", "elapsed", "sync_wait",
                 "children", "_t0", "_sync")

    def __init__(self, name: str, attrs: Dict[str, object],
                 sync=None) -> None:
        self.name = name
        self.attrs = attrs
        self.start = time.time()
        self.elapsed = 0.0
        self.sync_wait = 0.0           # device-sync wait at close (opt-in)
        self.children: List["Span"] = []
        self._t0 = time.perf_counter()
        self._sync = sync

    def block_on(self, arrays) -> None:
        """Opt into a device sync at span close: when ``arrays`` holds CUDA
        tensors, ``torch.cuda.synchronize()`` runs before the clock is
        read, and the wait is recorded in ``sync_wait`` — so the span's
        wall time covers the
        device work, not just its async dispatch."""
        self._sync = arrays

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _close(self) -> None:
        if self._sync is not None:
            t0 = time.perf_counter()
            if _holds_cuda(self._sync):
                import torch
                torch.cuda.synchronize()
            self.sync_wait = time.perf_counter() - t0
            self._sync = None
        self.elapsed = time.perf_counter() - self._t0

    def to_dict(self) -> dict:
        out = {"name": self.name, "elapsed_s": self.elapsed}
        if self.sync_wait:
            out["sync_wait_s"] = self.sync_wait
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out

    def find(self, name: str) -> Optional["Span"]:
        """Depth-first lookup by span name (tests/assertions)."""
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None


class _NullSpan:
    """Shared no-op span/context-manager for disabled registries and
    ambient helpers outside any trace. Stateless -> reentrant."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def block_on(self, arrays) -> None:
        pass

    def annotate(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()
_ACTIVE = threading.local()              # per-thread [(registry, span)] stack


class _TraceCtx:
    """Context manager produced by :meth:`MetricRegistry.trace`."""

    __slots__ = ("_reg", "_span", "_root")

    def __init__(self, reg: "MetricRegistry", span_: Span) -> None:
        self._reg = reg
        self._span = span_
        self._root = False

    def __enter__(self) -> Span:
        stack = getattr(_ACTIVE, "stack", None)
        if stack is None:
            stack = _ACTIVE.stack = []
        if stack and stack[-1][0] is self._reg:
            stack[-1][1].children.append(self._span)
        else:
            self._root = True
        stack.append((self._reg, self._span))
        return self._span

    def __exit__(self, *exc) -> bool:
        stack = _ACTIVE.stack
        assert stack and stack[-1][1] is self._span, "unbalanced trace()"
        stack.pop()
        self._span._close()
        self._reg._span_closed(self._span, self._root)
        return False


class MetricRegistry:
    """Process-wide but injectable registry of metric families.

    A *family* is (name, kind, help); each family holds label-keyed
    series. ``enabled=False`` turns every write and trace into a no-op
    (reads still work, returning zeros) — the benchmarked
    "uninstrumented" configuration.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 256) -> None:
        self._lock = threading.Lock()
        # name -> (kind, help, {label_key_tuple: metric})
        self._families: Dict[str, Tuple[str, str, Dict[tuple, object]]] = {}
        # name -> (help, callback) — evaluated at collection time
        self._callbacks: Dict[str, Tuple[str, Callable[[], Iterable]]] = {}
        self._instances: Dict[str, int] = {}
        self._enabled = [bool(enabled)]
        self._spans: List[Span] = []
        self._max_spans = max_spans

    # -- configuration ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled[0]

    @enabled.setter
    def enabled(self, on: bool) -> None:
        self._enabled[0] = bool(on)

    def instance(self, prefix: str) -> str:
        """Deterministic per-registry instance label (``store0``,
        ``store1``, ...): disambiguates several objects of one kind
        sharing the registry without wall-clock/ids in labels."""
        with self._lock:
            n = self._instances.get(prefix, 0)
            self._instances[prefix] = n + 1
            return f"{prefix}{n}"

    # -- metric families -------------------------------------------------------
    def _series(self, kind: str, name: str, labels: Dict[str, str],
                help_: str, factory) -> object:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, help_, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"requested {kind}")
            metric = fam[2].get(key)
            if metric is None:
                metric = factory()
                fam[2][key] = metric
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._series("counter", name, labels, help,
                            lambda: Counter(self._enabled))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._series("gauge", name, labels, help,
                            lambda: Gauge(self._enabled))

    def histogram(self, name: str,
                  edges: Tuple[float, ...] = DEFAULT_LATENCY_EDGES,
                  help: str = "", **labels) -> Histogram:
        return self._series("histogram", name, labels, help,
                            lambda: Histogram(edges, self._enabled))

    def state(self, name: str, help: str = "", **labels) -> TextState:
        return self._series("state", name, labels, help,
                            lambda: TextState(self._enabled))

    def register_callback(self, name: str,
                          fn: Callable[[], Iterable[Tuple[Dict[str, str],
                                                          float]]],
                          help: str = "") -> None:
        """Register a collection-time gauge family: ``fn()`` yields
        ``(labels_dict, value)`` pairs each time the registry is
        snapshotted or rendered (live state — backlog depths, lag
        seconds — without a write on every event)."""
        with self._lock:
            self._callbacks[name] = (help, fn)

    # -- tracing ---------------------------------------------------------------
    def trace(self, name: str, sync=None, **attrs):
        """Open a span (see module docstring). ``sync=`` opts into a
        device sync at close. Returns a context manager yielding the
        :class:`Span` (a shared no-op when the registry is disabled)."""
        if not self._enabled[0]:
            return _NULL_SPAN
        return _TraceCtx(self, Span(name, attrs, sync))

    def _span_closed(self, span_: Span, root: bool) -> None:
        self.histogram("span_seconds", span=span_.name).observe(span_.elapsed)
        if root:
            with self._lock:
                self._spans.append(span_)
                if len(self._spans) > self._max_spans:
                    del self._spans[: len(self._spans) - self._max_spans]

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Completed root spans, newest last (bounded ring buffer)."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    # -- export ----------------------------------------------------------------
    def _collected_callbacks(self) -> List[Tuple[str, str,
                                                 List[Tuple[tuple, float]]]]:
        with self._lock:
            cbs = list(self._callbacks.items())
        out = []
        for name, (help_, fn) in cbs:
            series = []
            for labels, value in fn():
                key = tuple(sorted((str(k), str(v))
                            for k, v in labels.items()))
                series.append((key, float(value)))
            out.append((name, help_, series))
        return out

    def counter_values(self) -> Dict[str, float]:
        """Flat ``name{a="b",...} -> value`` view of every counter series
        — the diffable form behind ``RunReport.telemetry`` counter
        deltas."""
        out: Dict[str, float] = {}
        with self._lock:
            fams = [(n, f) for n, f in self._families.items()
                    if f[0] == "counter"]
        for name, (_k, _h, series) in fams:
            for key, metric in list(series.items()):
                out[_series_name(name, key)] = metric.value
        return out

    def snapshot(self) -> dict:
        """Nested dict of every family: machine-readable export (the
        ``fs_top`` example and ``RunReport.telemetry`` read this)."""
        out: dict = {}
        with self._lock:
            fams = list(self._families.items())
        for name, (kind, help_, series) in fams:
            fam_out: dict = {"kind": kind, "series": {}}
            if help_:
                fam_out["help"] = help_
            for key, metric in list(series.items()):
                skey = _labels_str(key)
                if kind in ("counter", "gauge"):
                    fam_out["series"][skey] = metric.value
                elif kind == "histogram":
                    fam_out["series"][skey] = {
                        "edges": list(metric.edges),
                        "counts": list(metric.counts),
                        "sum": metric.sum, "count": metric.count,
                        "p50": metric.percentile(0.50),
                        "p99": metric.percentile(0.99),
                    }
                else:                     # state
                    fam_out["series"][skey] = metric.get()
            out[name] = fam_out
        for name, help_, series in self._collected_callbacks():
            fam_out = {"kind": "gauge", "series":
                       {_labels_str(k): v for k, v in series}}
            if help_:
                fam_out["help"] = help_
            out[name] = fam_out
        return out

    def render_prometheus(self) -> str:
        """Text exposition format (the simple line-oriented subset:
        ``# TYPE``/``# HELP`` comments + ``name{labels} value`` samples;
        round-trips through :func:`parse_prometheus`)."""
        lines: List[str] = []
        with self._lock:
            fams = list(self._families.items())
        for name, (kind, help_, series) in fams:
            pname = _sanitize_name(name)
            if help_:
                lines.append(f"# HELP {pname} {help_}")
            lines.append(f"# TYPE {pname} "
                         f"{'gauge' if kind == 'state' else kind}")
            for key, metric in list(series.items()):
                if kind in ("counter", "gauge"):
                    lines.append(f"{pname}{_prom_labels(key)} "
                                 f"{_fmt(metric.value)}")
                elif kind == "histogram":
                    cum = 0
                    for edge, c in zip(metric.edges, metric.counts):
                        cum += c
                        lines.append(
                            f"{pname}_bucket"
                            f"{_prom_labels(key, le=_fmt(edge))} {cum}")
                    cum += metric.counts[-1]
                    lines.append(f"{pname}_bucket"
                                 f"{_prom_labels(key, le='+Inf')} {cum}")
                    lines.append(f"{pname}_sum{_prom_labels(key)} "
                                 f"{repr(metric.sum)}")
                    lines.append(f"{pname}_count{_prom_labels(key)} "
                                 f"{metric.count}")
                else:                     # state -> info-style gauge
                    value = metric.get()
                    if value is not None:
                        lines.append(
                            f"{pname}"
                            f"{_prom_labels(key, value=value)} 1")
        for name, help_, series in self._collected_callbacks():
            pname = _sanitize_name(name)
            if help_:
                lines.append(f"# HELP {pname} {help_}")
            lines.append(f"# TYPE {pname} gauge")
            for key, value in series:
                lines.append(f"{pname}{_prom_labels(key)} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Scrape boundary: zero every counter and histogram and clear
        every text state, across ALL instances sharing this registry
        (``Reports.reset_counters`` delegates here so serving, tiering,
        permission and fallback families clear together). Gauges and
        callbacks describe current state and are left alone."""
        with self._lock:
            fams = list(self._families.values())
        for kind, _help, series in fams:
            if kind in ("counter", "histogram", "state"):
                for metric in list(series.values()):
                    metric.reset()


def _labels_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _series_name(name: str, key: tuple) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


def _prom_labels(key: tuple, **extra: str) -> str:
    pairs = [(_LABEL_RE.sub("_", k), _escape_label(str(v)))
             for k, v in key] + \
            [(k, _escape_label(str(v))) for k, v in extra.items()]
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Line-format check for the exposition output: returns
    ``{sample_name_with_labels: value}``; raises ``ValueError`` on any
    malformed line. This is the CI round-trip parser — deliberately the
    simple subset :meth:`MetricRegistry.render_prometheus` emits."""
    out: Dict[str, float] = {}
    for i, line in enumerate(text.splitlines()):
        if not line or line.startswith("#"):
            if line.startswith("#") and not line.startswith(("# HELP ",
                                                             "# TYPE ")):
                raise ValueError(f"line {i + 1}: bad comment {line!r}")
            continue
        m = _PROM_LINE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i + 1}: unparseable sample {line!r}")
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


# -- ambient helpers (registry-less library code) ------------------------------
def ambient_registry() -> Optional[MetricRegistry]:
    """The registry of the innermost active trace on this thread."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1][0] if stack else None


def span(name: str, **attrs):
    """Child span of whatever trace is active on this thread — a shared
    no-op outside any trace. Lets ``core.segments`` / kernel op wrappers
    time themselves without holding a registry reference."""
    stack = getattr(_ACTIVE, "stack", None)
    if not stack:
        return _NULL_SPAN
    return stack[-1][0].trace(name, **attrs)


def ambient_counter(name: str, n: float = 1.0, **labels) -> None:
    """Increment a counter on the ambient registry (no-op outside any
    trace)."""
    reg = ambient_registry()
    if reg is not None:
        reg.counter(name, **labels).inc(n)


# -- compatibility descriptors -------------------------------------------------
class counter_attr:
    """Class-level descriptor exposing a registry counter as a plain int
    attribute: ``self.full_uploads += 1`` and ``store.full_uploads``
    keep working, now backed by ``obj.telemetry`` with ``obj._tlabels``
    as the instance labels. The owner must assign ``self.telemetry`` and
    ``self._tlabels`` before first use."""

    __slots__ = ("metric", "help")

    def __init__(self, metric: str, help: str = "") -> None:
        self.metric = metric
        self.help = help

    def _counter(self, obj) -> Counter:
        return obj.telemetry.counter(self.metric, help=self.help,
                                     **obj._tlabels)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return int(self._counter(obj).value)

    def __set__(self, obj, value) -> None:
        self._counter(obj).set_to(value)


class state_attr:
    """Descriptor sibling of :class:`counter_attr` for
    :class:`TextState` attributes (``Reports.last_fallback_reason``)."""

    __slots__ = ("metric", "help")

    def __init__(self, metric: str, help: str = "") -> None:
        self.metric = metric
        self.help = help

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.telemetry.state(self.metric, help=self.help,
                                   **obj._tlabels).get()

    def __set__(self, obj, value) -> None:
        obj.telemetry.state(self.metric, help=self.help,
                            **obj._tlabels).set(value)


def slug(text: str, limit: int = 60) -> str:
    """Bounded label value from free text (fallback reasons): lowercase,
    word characters only — keeps series cardinality sane while staying
    greppable against the full ``RunReport.fallback_reason``."""
    s = re.sub(r"[^a-z0-9]+", "_", text.lower()).strip("_")
    return s[:limit].rstrip("_")
