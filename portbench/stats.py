"""The benchmark's arithmetic over samples and device intervals."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every sample, linear between
    the closest ranks (numpy's default); never over medians of chunks."""
    if not values:
        raise ValueError("no samples")
    xs = sorted(values)
    at = (len(xs) - 1) * q / 100.0
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as disjoint sorted intervals:
    operations that overlap count once."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of [lo, hi) that the union of ``intervals`` covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The parts of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def quartile_spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
