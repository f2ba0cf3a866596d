"""A traced part of the window: ``torch.profiler`` over the host's spans
and the card's operations, reduced to what the per-layer metrics and the
breakdown read.

The card is busy where any device operation runs: the union of the
operations' intervals, so operations that overlap count once. An idle
gap is named by the benchmark's host span (``prefill``, ``step``,
``deliver``) that was open at its middle, ``other`` where none was.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch

from . import stats

SPANS = ("prefill", "step", "deliver")
WINDOW = "traced_window"


def span(name: str):
    """A host span the breakdown names idle gaps by."""
    return torch.profiler.record_function(name)


def _events(prof) -> List[Tuple[str, bool, bool, float, float]]:
    """(name, on the device, user annotation, start s, end s) of every
    event the profiler kept."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        s, name = e.start_ns() / 1e9, e.name()
        note = e.is_user_annotation() or name in SPANS or name == WINDOW
        out.append((name, e.device_type() == DeviceType.CUDA, note, s,
                    s + e.duration_ns() / 1e9))
    return out


class Tracer:
    """Profiles one part of the window; :meth:`summary` reduces it."""

    def __init__(self) -> None:
        self.prof = None
        self._span = None

    @staticmethod
    def warm(device: torch.device) -> None:
        """Starts the profiler once over one small operation, so that the
        traced part of the window does not pay its first start."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum().item()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._span = span(WINDOW)
        self._span.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> Dict:
        """``busy_s`` and ``window_s``; ``ops``: device seconds and count
        by operation name; ``device_ops`` and ``idle_gaps``: the ten
        largest of each, [name (an operation's first 120 characters),
        seconds]."""
        events = _events(self.prof)
        windows = [(s, e) for n, dev, ann, s, e in events
                   if n == WINDOW and not dev]
        lo, hi = windows[0]
        device = [(n, s, e) for n, dev, ann, s, e in events
                  if dev and not ann]
        intervals = [(s, e) for _, s, e in device]
        busy = stats.covered(intervals, lo, hi)
        ops: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0.0, 0])
        for n, s, e in device:
            ops[n][0] += e - s
            ops[n][1] += 1
        host = [(n, s, e) for n, dev, ann, s, e in events
                if not dev and n in SPANS]
        named = []
        longest = sorted(stats.gaps(intervals, lo, hi),
                         key=lambda g: g[0] - g[1])[:10]
        for s, e in longest:
            mid = (s + e) / 2
            inner = [(hs, n) for n, hs, he in host if hs <= mid < he]
            named.append([max(inner)[1] if inner else "other", e - s])
        top = sorted(([n[:120], v[0]] for n, v in ops.items()),
                     key=lambda r: -r[1])
        return {"busy_s": busy, "window_s": hi - lo,
                "ops": {n: tuple(v) for n, v in ops.items()},
                "device_ops": top[:10], "idle_gaps": named}
