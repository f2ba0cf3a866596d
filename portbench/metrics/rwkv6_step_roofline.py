"""``rwkv6_step``'s share of its bound: a call's bytes from its shapes
(``count.rwkv6.rwkv6_step_bytes``) over the card's bandwidth, over the
kernel's mean device time a launch, found by name in the trace; in
percent."""
from portbench.count import PEAK_HBM_BYTES_PER_S
from portbench.count.rwkv6 import rwkv6_step_bytes


def read(run):
    trace = run.window.trace
    if trace is None or run.config["family"] != "rwkv6":
        return None
    calls = [(s, n) for name, (s, n) in trace["ops"].items()
             if "rwkv6_step" in name]
    seconds, launches = sum(c[0] for c in calls), sum(c[1] for c in calls)
    if not launches:
        return None
    cfg = run.config
    least = rwkv6_step_bytes(run.window.prefill_batch, cfg["n_heads"],
                             cfg["head_dim"]) / PEAK_HBM_BYTES_PER_S
    return 100.0 * least / (seconds / launches)
