"""Plain PyTorch version of decode attention: ``models.components.
attention``'s direct path at one query position, op for op.

The semantics authority the CUDA kernel is held to, on any device. K and V
are repeated to every query head (query head h reads KV head h // G) and
taken to f32, q is taken to f32 and scaled, the scores get the optional
softcap and the mask (``kv_pos < 0`` an empty slot, ``causal``, the
``window``) as -1e30, and the softmax runs over the whole row at once: a
row with every position masked gives zeros. On the CPU its results equal
``attention``'s bit for bit (``tests/test_torch_decode_attention.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         logit_softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k, v: (B, L, K, hd) with H = K * G; q_pos: (1,);
    kv_pos: (L,), -1 for an empty slot. ``scale`` defaults to 1 /
    sqrt(hd). Returns (B, 1, H, hd) in q's dtype."""
    H, K = q.shape[2], k.shape[2]
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float() * scale
    s = torch.einsum("bqhd,bchd->bhqc", qf, k.float())
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    m = kv_pos[None, :] >= 0
    if causal:
        m = m & (kv_pos[None, :] <= q_pos[:, None])
    if window:
        m = m & (kv_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(m[None, None, :, :], s,
                    torch.full((), NEG, device=s.device))
    mx = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    p = torch.where(s > 0.5 * NEG, p, torch.zeros((), device=p.device))
    denom = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqc,bchd->bqhd", p, v.float())
    o = o / denom.clamp(min=1e-20).permute(0, 2, 1, 3)
    return o.to(q.dtype)
