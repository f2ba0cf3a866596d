"""Model FLOPs and least bytes, from a configuration's shapes alone, and
the card's peaks they are held against.

Each family's module gives, for a batch of ``batch`` sequences:

* ``decode_flops(cfg, batch, pos)`` / ``decode_bytes(cfg, batch, pos)``:
  one decode step that feeds the token at position ``pos`` (the cache
  then holds positions 0..pos);
* ``prefill_flops(cfg, batch, prompt)``: a prefill of ``prompt`` tokens a
  sequence, the head over the last position only (the one it serves);
* ``parameters(cfg)``: the weights' count.

FLOPs are the model's: 2 a multiply-add of every product the shapes ask
for (a mixture of experts: the experts each token is routed to), plus
attention's scores and sums, plus the recurrences; not what an
implementation runs. Bytes count what these inputs need: each weight the
step uses read once (the embedding: the rows looked up; a mixture of
experts: the experts the step's tokens reach), the state or cache read and
written once, the tokens in and out.
"""
from __future__ import annotations

import importlib

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def family(name: str):
    """The count module of a model family."""
    return importlib.import_module(f"{__name__}.{name}")


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
