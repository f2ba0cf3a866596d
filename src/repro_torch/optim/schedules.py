"""Learning-rate schedules (the reference's ``optim/schedules.py``).

The schedule is computed in f32 on the count's device, as the reference
computes it (``count.astype(float32)``, then f32 arithmetic): in Python's
f64 the rate would differ by an ulp at some counts, and bf16 parameters
would flip at rounding boundaries.
"""
from __future__ import annotations

import math

import torch


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def sched(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        warm = peak * c / max(1, warmup_steps)
        prog = torch.clamp((c - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup_steps, warm, cos)
    return sched
