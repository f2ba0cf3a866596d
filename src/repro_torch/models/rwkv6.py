"""RWKV-6 "Finch" time-mix and channel-mix (data-dependent decay), in
PyTorch (the reference's ``models/rwkv6.py``).

Recurrence per head (key-dim i, value-dim j):

    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
    y_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])

Sequence processing uses the chunked linear-attention form, as the
reference does in plain JAX: within a chunk of length C the intra-chunk
part is an O(C^2 hd) masked product, the inter-chunk part applies the
carried state; every decay exponent that appears is a difference
lw_a - lw_b with a >= b along time, hence <= 0 and safe to exponentiate
(clamped at 0 as well). ``wkv_chunked`` is the port's ``wkv_chunked`` op
and the decode step ``wkv_step`` its ``rwkv6_step`` op: each the
hand-written CUDA kernel on the card, its plain version on the CPU.
``wkv_ref`` loops the step as the O(S) oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.rwkv6_step import ops as rwkv6_ops
from ..kernels.wkv_chunked import ops as wkv_ops


def wkv_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. r,k,v,w: (B,H,hd); u: (H,hd); state: (B,H,hd,hd).

    Returns (y (B,H,hd), new_state). All f32.
    """
    return rwkv6_ops.rwkv6_step(r, k, v, w, u, state)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lw: torch.Tensor, u: torch.Tensor,
                state: Optional[torch.Tensor] = None, chunk: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence form. r,k,v: (B,S,H,hd) f32; lw: (B,S,H,hd) log-decay (<=0);
    u: (H,hd). Returns (y (B,S,H,hd), final_state (B,H,hd,hd)).
    ``chunk``: the plain version's tiling (S a multiple of it); the kernel
    takes any S.
    """
    return wkv_ops.wkv_chunked(r, k, v, lw, u, state, chunk)


def wkv_ref(r, k, v, lw, u, state=None):
    """O(S) serial oracle (a loop of ``wkv_step``; tiny shapes only)."""
    B, S, H, hd = r.shape
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    ys = []
    for t in range(S):
        y, state = wkv_step(r[:, t], k[:, t], v[:, t],
                            torch.exp(lw[:, t]), u, state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Previous-token features: shift right by one along S. x: (B,S,D)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    else:
        last = last[:, None, :]
    return torch.cat([last, x[:, :-1, :]], dim=1)


def ddlerp(x: torch.Tensor, xprev: torch.Tensor, mu: torch.Tensor,
           a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """RWKV6 data-dependent lerp for one channel group.

    x, xprev: (B,S,D); mu: (D,); a: (D,L); b: (L,D).
    mix = x + (mu + tanh((xprev-x) @ a) @ b) * (xprev - x)
    """
    dx = xprev - x
    dyn = torch.tanh(dx @ a) @ b
    return x + (mu + dyn) * dx
