"""Median of the host clock's time from a batch's submission until its
first tokens are on the host (``make_prefill`` and the argmax)."""
import statistics


def read(run):
    s = run.window.prefill_s
    return statistics.median(s) * 1e3 if s else None
