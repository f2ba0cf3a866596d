"""The share of a traced whole batch (its prefill and its decode steps)
in which no device operation runs, from the trace alone: 1 - busy_s /
window_s, busy_s the union of the device operations' intervals over the
traced window, in percent. The profiler's own delay of the host's
launches counts here as idle."""


def read(run):
    trace = run.window.trace
    if trace is None or run.traffic["trace"]["phase"] != "batch":
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
