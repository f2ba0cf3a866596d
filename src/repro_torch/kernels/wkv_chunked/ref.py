"""Plain PyTorch version of RWKV6's chunked sequence form (what
``models.rwkv6.wkv_chunked`` ran before the kernel, unchanged).

The semantics authority the CUDA kernel is held to, on any device: within
a chunk of length ``chunk`` the intra-chunk part is an O(C^2 hd) masked
product through a (B, C, C, H, hd) f32 exponent tensor, the inter-chunk
part applies the carried state; every decay exponent that appears is a
difference lw_a - lw_b with a >= b along time, hence <= 0 and safe to
exponentiate (clamped at 0 as well). S must be a multiple of ``chunk``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
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
