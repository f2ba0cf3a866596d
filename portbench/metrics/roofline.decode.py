"""The decode steps' least time, each step's max(FLOPs / peak, bytes /
bandwidth) from the configuration's shapes, over the steps' measured
time, in percent."""
from portbench.count import least_seconds


def read(run):
    w = run.window
    if not w.step_s:
        return None
    B, cfg, c = w.prefill_batch, run.config, run.count
    least = sum(least_seconds(c.decode_flops(cfg, B, pos),
                              c.decode_bytes(cfg, B, pos))
                for pos in w.step_pos)
    return 100.0 * least / sum(w.step_s)
