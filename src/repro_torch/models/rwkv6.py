"""RWKV-6 "Finch" time-mix and channel-mix (data-dependent decay), in
PyTorch (the reference's ``models/rwkv6.py``).

Recurrence per head (key-dim i, value-dim j):

    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
    y_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])

Sequence processing uses the chunked linear-attention form in plain
PyTorch, as the reference does in plain JAX: within a chunk of length C the
intra-chunk part is an O(C^2 hd) masked product, the inter-chunk part
applies the carried state; every decay exponent that appears is a
difference lw_a - lw_b with a >= b along time, hence <= 0 and safe to
exponentiate (clamped at 0 as well). The decode step ``wkv_step`` is the
port's ``rwkv6_step`` op: the hand-written CUDA kernel on the card, its
plain version on the CPU. ``wkv_ref`` loops it as the O(S) oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.rwkv6_step import ops as rwkv6_ops


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
    """
    B, S, H, hd = r.shape
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    if S % chunk:
        raise ValueError(f"S={S} must divide chunk={chunk}")
    n = S // chunk
    tri_lt = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)  # s < t
    ys = []
    s_prev = state
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, lwc = r[:, sl], k[:, sl], v[:, sl], lw[:, sl]  # (B,C,H,hd)
        cum = torch.cumsum(lwc, dim=1)                   # lw_1..t inclusive
        cum_prev = cum - lwc                             # lw up to t-1
        # inter-chunk: y_t += (r_t * exp(cum_prev_t)) @ S_prev
        r_dec = rc * torch.exp(cum_prev)
        y_inter = torch.einsum("bthi,bhij->bthj", r_dec, s_prev)
        # intra-chunk: A[t,s] = sum_i r[t,i] k[s,i] exp(cum_prev[t]-cum[s]),
        # s < t
        expo = cum_prev[:, :, None] - cum[:, None, :, :, :]  # (B,t,s,H,hd)
        expo = torch.clamp(expo, max=0.0)
        a = torch.einsum("bthi,btshi->btsh", rc,
                         kc[:, None] * torch.exp(expo))
        a = torch.where(tri_lt[None, :, :, None], a,
                        torch.zeros((), device=a.device))
        # current-token bonus term: A[t,t] = sum_i r[t,i] u[i] k[t,i]
        diag = torch.einsum("bthi,hi,bthi->bth", rc, u, kc)
        y_intra = torch.einsum("btsh,bshj->bthj", a, vc) + \
            diag[..., None] * vc
        # state update: S = diag(exp(cum_C)) S_prev
        #                   + sum_s (k_s exp(cum_C - cum_s)) v_s
        cum_end = cum[:, -1:, :, :]                      # (B,1,H,hd)
        k_dec = kc * torch.exp(torch.clamp(cum_end - cum, max=0.0))
        s_prev = torch.exp(cum_end[:, 0])[..., None] * s_prev + \
            torch.einsum("bshi,bshj->bhij", k_dec, vc)
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1), s_prev


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
