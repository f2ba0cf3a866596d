"""95th percentile, over every decode step of the window, of the host
clock's gap between a sequence's successive token deliveries (each step
delivers one token to every sequence of the batch)."""
from portbench.stats import percentile


def read(run):
    s = run.window.step_s
    return percentile(s, 95) * 1e3 if s else None
