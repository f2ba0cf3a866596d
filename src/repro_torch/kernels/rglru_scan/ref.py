"""Plain PyTorch versions of the RG-LRU recurrence and its gradient.

The semantics authority the CUDA kernels are held to, on any device:
``h_t = exp(log_a_t) * h_{t-1} + b_t``, walked in order over t, and its
gradient walked back. Each step rounds as separate f32 operations (exp,
multiply, add) in the order the kernels repeat, so on the card the two
agree bit for bit.
"""
from __future__ import annotations

from typing import Tuple

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


def rglru_bwd_ref(log_a: torch.Tensor, h: torch.Tensor, gh: torch.Tensor,
                  h0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rglru_ref`, walked from t = S-1 down to 0.

    log_a, h (the forward's output), gh (the gradient of h): (B, S, R) f32;
    h0: (B, R). With a_t = exp(log_a_t) and the carry c = a_{t+1} g_{t+1}
    (0 at the last step): g_t = gh_t + c, db_t = g_t, c = g_t a_t,
    dlog_a_t = c h_{t-1} (h_{-1} = h0), and dh0 = c after t = 0.
    Returns (dlog_a, db, dh0).
    """
    dlog_a = torch.empty_like(log_a)
    db = torch.empty_like(gh)
    c = torch.zeros_like(h0)
    for t in range(log_a.shape[1] - 1, -1, -1):
        g = gh[:, t] + c
        db[:, t] = g
        c = g * torch.exp(log_a[:, t])
        dlog_a[:, t] = c * (h[:, t - 1] if t > 0 else h0)
    return dlog_a, db, c
