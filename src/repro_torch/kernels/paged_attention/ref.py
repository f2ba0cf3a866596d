"""Plain PyTorch version of paged decode attention.

The semantics authority the CUDA kernel is held to, on any device: one
query token per sequence attends over that sequence's K/V pages, reached
through its page table. It gathers the pages, serves each KV head to its G
query heads (query head h reads KV head h // G, the interleaving of the
reference's ``jnp.repeat``; the heads are split as (K, G) rather than
copied G times, which keeps the gathered K/V at their own size), masks
positions at or past the length and pages with id -1, and takes a
max-subtracted softmax in f32 (positions masked to -1e30 give exactly 0,
and an empty row divides by 1e-20, so it outputs zeros, never NaN). It
returns q's dtype.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q:          (B, H, hd)            one query token per sequence
    k_pages:    (n_pages, P, K, hd)   global page pool (P = page size)
    v_pages:    (n_pages, P, K, hd)
    page_table: (B, max_pages) int   page ids per sequence, -1 = unused
    lengths:    (B,) int              tokens in each sequence's cache
    Returns (B, H, hd) in q's dtype. GQA: H = K * G, and query head h
    reads KV head h // G.
    """
    B, H, hd = q.shape
    n_pages, P, K, _ = k_pages.shape
    G = H // K
    max_pages = page_table.shape[1]
    page_table = page_table.long()

    # gather each sequence's pages -> contiguous (B, max_pages*P, K, hd)
    safe_ids = page_table.clamp(min=0)
    k_seq = k_pages[safe_ids].reshape(B, max_pages * P, K, hd)
    v_seq = v_pages[safe_ids].reshape(B, max_pages * P, K, hd)

    pos = torch.arange(max_pages * P, device=q.device)[None, :]
    page_valid = (page_table >= 0).repeat_interleave(P, dim=1)
    valid = (pos < lengths.to(q.device).long()[:, None]) & page_valid

    qg = (q.float() / math.sqrt(float(hd))).reshape(B, K, G, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k_seq.float())
    s = s.reshape(B, H, max_pages * P)
    s = torch.where(valid[:, None, :], s, torch.tensor(-1e30, device=s.device))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    p = torch.where(s > -0.5e30, p, torch.zeros((), device=p.device))
    o = torch.einsum("bkgl,blkd->bkgd", p.reshape(B, K, G, -1),
                     v_seq.float()).reshape(B, H, hd)
    return (o / p.sum(-1)[..., None].clamp(min=1e-20)).to(q.dtype)
