"""Model FLOPs of the window's decode steps (``count/``, from the
configuration's shapes) over their seconds times the card's bf16 peak,
in percent."""
from portbench.count import PEAK_BF16_FLOPS


def read(run):
    w = run.window
    if not w.step_s:
        return None
    flops = sum(run.count.decode_flops(run.config, w.prefill_batch, pos)
                for pos in w.step_pos)
    return 100.0 * flops / (sum(w.step_s) * PEAK_BF16_FLOPS)
