"""The general traffic generator: a closed loop of one client.

A traffic mix (``traffic/<name>.json``) gives ``batch`` (B), ``prompt``
(P), ``generate`` (G): the client submits B prompts of P token ids, reads
each of the G tokens a sequence is served as it comes (the first from the
prefill, then one a decode step), and submits the next B as soon as a
batch ends. Token ids are uniform over the vocabulary, drawn from the
run's seed and the batch's index, so every seed sends the same shapes in
the same order. ``close``: ``"batch"`` keeps the window open until the
batch in flight at its end has finished (a mix whose batches are few and
long, whose rate would jump by a batch at the edge), else it closes at
the first delivery at or past its end. ``trace`` says which part of the
window a traced run
profiles (``"decode"``: ``steps`` decode steps of the first batch from
``from_step``; ``"batch"``: the whole first batch), ``check`` how many of
the finished requests the reference judges (``Session.picks``);
``smoke``, the small sizes the CPU tests run. ``source`` names the public
figures the lengths stand for and ``shape`` what the generator fixes; the
generator reads neither.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from .weights import subseed

HERE = Path(__file__).resolve().parent


def load(name: str, smoke: bool = False) -> Dict:
    """Traffic mix ``name``; ``smoke``: with its small sizes (``smoke``
    in the file) for the CPU tests."""
    with open(HERE / "traffic" / f"{name}.json") as f:
        t = json.load(f)
    return {**t, **t["smoke"]} if smoke else t


def prompts(traffic: Dict, vocab: int, seed: int, batch_index: int
            ) -> np.ndarray:
    """Batch ``batch_index``'s prompts: (B, P) int64 token ids."""
    rng = np.random.Generator(np.random.Philox(
        subseed(seed, "prompts", batch_index)))
    return rng.integers(0, vocab, size=(traffic["batch"], traffic["prompt"]),
                        dtype=np.int64)

