"""The program's own spans and counters over a part of a cell's window,
with the profiler off, and the numbers they give.

The port records them (``repro_torch.runtime.spans``) while an ambient
trace of a ``MetricRegistry`` is open, and its device spans and counters
while a ``Timeline`` is open too: ``GraphedServeStep`` then replays a
graph captured with CUDA timing events at each layer kind and the MoE
counters in it (:meth:`Events.capture` captures it ahead). :class:`Events`
opens both over a run of decode steps or of prefills, reads each step's
events back and reduces them (:func:`reduce`):

* ``graph_ms``: the median device time of a plain replay,
  ``decode.graph`` (events on the stream around it);
* ``step_gap_ms``: the median device gap from a plain replay's end to the
  next replay's start;
* ``mix_ms.decode``, ``ffn_ms.decode``: ``decode.mix`` and ``decode.ffn``
  summed over the layers, the median over the steps;
* ``mix_ms.prefill``: ``prefill.mix`` summed over the layers, the median
  over the prefills;
* ``moe_slot_use``: 100 x ``moe_tokens_kept`` / ``moe_slots``.

The events inside a graph take device time of their own and reading them
back delays the next replay, so the steps take turns: the instrumented
graph (the sums by layer kind), then the plain one (``graph_ms``, and the
gap after it); a replay's two ``decode.graph`` events are read every
step, and the instrumented replay's ``decode.graph`` against the plain
one's is what the events inside cost.

``tools/events_turns.py`` drives it on the card over a cell's steps.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import stats

Interval = Tuple[str, float, float]       # name, start, end (ms)

GRAPH = "decode.graph"


def first(intervals: Sequence[Interval], name: str) -> Optional[Interval]:
    """The first interval named ``name``, or None."""
    return next((iv for iv in intervals if iv[0] == name), None)


def summed(intervals: Sequence[Interval], name: str) -> float:
    """The time of the intervals named ``name``, summed (ms)."""
    return sum(e - s for n, s, e in intervals if n == name)


def reduce(steps: Sequence[Sequence[Interval]], full: Sequence[bool],
           prefills: Sequence[Sequence[Interval]] = (),
           counters: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The numbers of a section: ``steps[i]`` the intervals read after
    decode step i (the instrumented graph's where ``full[i]``, else the
    plain graph's ``decode.graph``), ``prefills[j]`` those of prefill j,
    ``counters`` the registry's counters. ``graph_ms`` and ``step_gap_ms``
    are the plain graph's, the sums by layer kind the instrumented
    graph's. A number with nothing to read is left out."""
    out: Dict[str, float] = {}
    graphs = [first(iv, GRAPH) for iv in steps]
    plain = [i for i, f in enumerate(full) if not f and graphs[i]]
    if plain:
        out["graph_ms"] = statistics.median(
            graphs[i][2] - graphs[i][1] for i in plain)
        gaps = [graphs[i + 1][1] - graphs[i][2] for i in plain
                if i + 1 < len(graphs) and graphs[i + 1]]
        if gaps:
            out["step_gap_ms"] = statistics.median(gaps)
    whole = [iv for iv, f in zip(steps, full) if f]
    for name, key in (("decode.mix", "mix_ms.decode"),
                      ("decode.ffn", "ffn_ms.decode")):
        if whole and first(whole[0], name):
            out[key] = statistics.median(summed(iv, name) for iv in whole)
    if prefills and first(prefills[0], "prefill.mix"):
        out["mix_ms.prefill"] = statistics.median(
            summed(iv, "prefill.mix") for iv in prefills)
    counters = counters or {}
    if counters.get("moe_slots"):
        out["moe_slot_use"] = (100.0 * counters.get("moe_tokens_kept", 0.0)
                               / counters["moe_slots"])
    return out


def breakdown(steps: Sequence[Sequence[Interval]], full: Sequence[bool]
              ) -> Dict[str, Dict[str, float]]:
    """Each span name's time a step, summed over the step's layers: the
    median and 95th percentile over the instrumented steps (ms)."""
    whole = [iv for iv, f in zip(steps, full) if f]
    names = sorted({n for iv in whole for n, _, _ in iv})
    return {n: {"median": statistics.median(summed(iv, n) for iv in whole),
                "p95": stats.percentile([summed(iv, n) for iv in whole],
                                        95)}
            for n in names}


class Events:
    """The program's spans and counters over the steps or prefills
    between :meth:`start` and :meth:`stop`, on ``device``. Decode steps
    take turns: the instrumented graph, its spans read back, then the plain
    graph, timed as a whole."""

    def __init__(self, device: torch.device) -> None:
        from repro_torch.core.telemetry import MetricRegistry
        self.registry = MetricRegistry()
        self.device = device
        self.steps: List[List[Interval]] = []
        self.full: List[bool] = []
        self.prefills: List[List[Interval]] = []
        self.counters: Dict[str, float] = {}
        self._trace = self._timeline = None

    def capture(self, step, batch: int, cache_len: int) -> None:
        """Captures the instrumented graph of ``step`` ahead (set-up)."""
        from repro_torch.runtime.spans import Timeline
        if hasattr(step, "capture"):
            with self.registry.trace("capture"), Timeline(self.device):
                step.capture(batch, cache_len)

    def start(self) -> None:
        from repro_torch.runtime.spans import Timeline
        self._trace = self.registry.trace("events")
        self._trace.__enter__()
        self._timeline = Timeline(self.device).__enter__()

    def after_step(self) -> None:
        """Reads the step just delivered, and turns the next one to the
        other graph."""
        tl = self._timeline
        self.steps.append(tl.read())
        self.full.append(tl.layers)
        tl.layers = not tl.layers

    def after_prefill(self) -> None:
        self.prefills.append(self._timeline.read())

    def stop(self) -> None:
        self._timeline.__exit__(None, None, None)
        self._trace.__exit__(None, None, None)
        self.counters = self.registry.counter_values()

    def summary(self) -> Dict[str, float]:
        return reduce(self.steps, self.full, self.prefills, self.counters)
