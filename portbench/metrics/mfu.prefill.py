"""Model FLOPs of the window's prefills (``count/``: the head over the
served last position only) over their seconds times the card's bf16 peak,
in percent."""
from portbench.count import PEAK_BF16_FLOPS


def read(run):
    w = run.window
    if not w.prefill_s:
        return None
    flops = run.count.prefill_flops(run.config, w.prefill_batch,
                                    w.prefill_len) * len(w.prefill_s)
    return 100.0 * flops / (sum(w.prefill_s) * PEAK_BF16_FLOPS)
