"""The share of the traced decode steps in which no device operation
runs, from the trace alone: 1 - busy_s / window_s, busy_s the union of
the device operations' intervals over the traced window, in percent.
Under the profiler a graph replay starts some milliseconds later than
without it (CUPTI traces every node), and that delay counts here as
idle."""


def read(run):
    trace = run.window.trace
    if trace is None or run.traffic["trace"]["phase"] != "decode":
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
