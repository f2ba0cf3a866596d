"""Serving steps: prefill (prompt -> cache) and decode (one token/step).

The port's :class:`~repro_torch.models.Model` holds its parameters, so the
steps take no ``params`` argument, and it serves no arch that needs the
reference's ``extras``; otherwise they are the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.transformer import Cache


def make_serve_step(model):
    """serve_step(cache, tokens (B,1), pos) -> (next (B,1) i32, cache)."""

    def serve_step(cache: Cache, tokens: torch.Tensor, pos: int
                   ) -> Tuple[torch.Tensor, Cache]:
        logits, new_cache = model.decode_step(cache, tokens, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], new_cache

    return serve_step


def make_prefill(model, cache_len: int):
    """prefill(tokens) -> (last-token logits (B, V), cache)."""

    def prefill(tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        logits, cache = model.prefill(tokens, cache_len)
        return logits[:, -1, :].clone(), cache

    return prefill
