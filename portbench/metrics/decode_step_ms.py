"""Median of the gaps ``itl_p95_ms`` takes its tail from: a decode step
(``GraphedServeStep``) and the delivery of its tokens."""
import statistics


def read(run):
    s = run.window.step_s
    return statistics.median(s) * 1e3 if s else None
