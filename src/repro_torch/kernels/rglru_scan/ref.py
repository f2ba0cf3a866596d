"""Plain PyTorch version of the RG-LRU recurrence.

The semantics authority the CUDA kernel is held to, on any device:
``h_t = exp(log_a_t) * h_{t-1} + b_t``, walked in order over t. Each step
rounds as three separate f32 operations (exp, multiply, add), which the
kernel repeats, so on the card the two agree bit for bit.
"""
from __future__ import annotations

import torch


def rglru_ref(log_a: torch.Tensor, b: torch.Tensor,
              h0: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t, sequentially.

    log_a, b: (B, S, R) f32; h0: (B, R). Returns h: (B, S, R).
    """
    out = torch.empty_like(b)
    h = h0
    for t in range(b.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        out[:, t] = h
    return out
