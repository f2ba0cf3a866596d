"""Deterministic, resumable, sharded token pipeline.

Properties a 1000-node run needs, all tested:

* **determinism**: batch(step, shard) is a pure function of (seed, step,
  shard) — any host can recompute any shard's batch (this is also what
  makes redundant-shard straggler mitigation sound, runtime/fault.py);
* **resumability**: the pipeline state is one integer (next step); restart
  from a checkpoint replays the exact token stream;
* **sharding**: host h draws only its shard of the global batch.

The synthetic stream is a seeded Markov-ish token generator; swap
``_tokens_for`` for a tokenized-corpus reader in production.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineState:
    next_step: int = 0


class DataPipeline:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 n_shards: int = 1, seed: int = 0) -> None:
        assert global_batch % n_shards == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.n_shards = n_shards
        self.seed = seed
        self.state = PipelineState()

    # -- pure batch function -------------------------------------------------
    def _tokens_for(self, step: int, shard: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        b = self.global_batch // self.n_shards
        base = rng.integers(0, self.vocab, (b, self.seq_len), dtype=np.int32)
        # inject local structure so models can actually learn: token t+1
        # correlates with token t half the time
        shift = np.roll(base, 1, axis=1)
        mask = rng.random((b, self.seq_len)) < 0.5
        return np.where(mask, (shift + 1) % self.vocab, base)

    def batch_for(self, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
        toks = self._tokens_for(step, shard)
        labels = np.concatenate(
            [toks[:, 1:], np.full((toks.shape[0], 1), -100, np.int32)],
            axis=1)
        return {"tokens": toks, "labels": labels}

    # -- stateful iteration (resumable) ----------------------------------------
    def next_batch(self, shard: int = 0) -> Dict[str, np.ndarray]:
        b = self.batch_for(self.state.next_step, shard)
        self.state.next_step += 1
        return b

    def checkpoint(self) -> dict:
        return {"next_step": self.state.next_step, "seed": self.seed}

    def restore(self, snap: dict) -> None:
        assert snap["seed"] == self.seed, "seed mismatch on restore"
        self.state.next_step = snap["next_step"]
