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
returns q's dtype. ``split_partials_ref`` and ``combine_ref`` mirror the
CUDA kernel's split of the page axis and its combine, for the tests.
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


# -- the kernel's split, in plain PyTorch (for the tests) --------------------


def split_slots(page_table: torch.Tensor, lengths: torch.Tensor,
                n_pages: int, page_size: int,
                pages_per_split: int) -> torch.Tensor:
    """(B, n_splits, pages_per_split) long: the table slots of each split's
    pages, -1 past a sequence's readable pages. A page is readable when its
    id lies in [0, n_pages) and its start under the length; split s holds
    readable pages s * pages_per_split .. (s + 1) * pages_per_split - 1,
    counted in table order, and n_splits = max(1, ceil(max_pages /
    pages_per_split)) depends on the table's width alone."""
    B, max_pages = page_table.shape
    n_splits = max(1, -(-max_pages // pages_per_split))
    width = n_splits * pages_per_split
    start = torch.arange(max_pages, device=page_table.device) * page_size
    readable = ((page_table >= 0) & (page_table < n_pages)
                & (start[None, :] < lengths.to(page_table.device).long()[
                    :, None]))
    rank = readable.long().cumsum(1) - 1
    rank = torch.where(readable, rank, torch.full_like(rank, width))
    slots = torch.full((B, width + 1), -1, dtype=torch.long,
                       device=page_table.device)
    slot_ids = torch.arange(max_pages, device=page_table.device)
    slots.scatter_(1, rank, slot_ids.expand(B, -1).contiguous())
    return slots[:, :width].reshape(B, n_splits, pages_per_split)


def split_partials_ref(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor,
                       pages_per_split: int) -> torch.Tensor:
    """Each split's (m, l, acc[hd]) per query head, as the split kernel
    writes them: (B, H, n_splits, hd + 2) f32. Within a split the rows of
    its pages are gathered in page order, masked rows and cut scores weigh
    0, m = max(-1e30, the split's scores), l = sum e^(s - m) and acc =
    sum e^(s - m) v; a split with no readable page is (-1e30, 0, 0). Sums
    run over the gathered rows only, so a hole or another sequence in the
    batch does not change a split's bits."""
    B, H, hd = q.shape
    n_pages, P, K, _ = k_pages.shape
    G = H // K
    slots = split_slots(page_table, lengths, n_pages, P, pages_per_split)
    n_splits = slots.shape[1]
    ids = page_table.long().gather(1, slots.clamp(min=0).reshape(B, -1))
    ids = ids.clamp(min=0)
    # rows (B, n_splits, pages_per_split * P) and their validity
    pos = slots[..., None] * P + torch.arange(P, device=q.device)
    valid = (slots[..., None] >= 0) & (
        pos < lengths.to(q.device).long()[:, None, None, None])
    valid = valid.reshape(B, n_splits, -1)
    k = k_pages[ids].reshape(B, n_splits, -1, K, hd).float()
    v = v_pages[ids].reshape(B, n_splits, -1, K, hd).float()
    qg = (q.float() / math.sqrt(float(hd))).reshape(B, 1, 1, K, G, hd)
    # (B, n_splits, rows, K, G): each score one product and one sum over hd
    s = (qg * k[:, :, :, :, None, :]).sum(-1)
    s = torch.where(valid[..., None, None], s,
                    torch.tensor(-1e30, device=s.device))
    m = s.amax(dim=2)                                  # (B, S, K, G)
    p = torch.exp(s - m[:, :, None])
    p = torch.where(s > -0.5e30, p, torch.zeros((), device=p.device))
    l = p.sum(dim=2)
    acc = (p[..., None] * v[:, :, :, :, None, :]).sum(dim=2)  # B,S,K,G,hd
    part = torch.cat([m[..., None], l[..., None], acc], dim=-1)
    return part.reshape(B, n_splits, H, hd + 2).transpose(1, 2).contiguous()


def combine_ref(partials: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The combine kernel's merge of (B, H, n_splits, hd + 2) partials, in
    split order: M = max m_s, out = sum e^(m_s - M) acc_s /
    max(sum e^(m_s - M) l_s, 1e-20), returned in ``dtype``."""
    m, l, acc = partials[..., 0], partials[..., 1], partials[..., 2:]
    w = torch.exp(m - m.amax(-1, keepdim=True))
    total = torch.zeros_like(l[..., 0])
    out = torch.zeros_like(acc[..., 0, :])
    for s in range(partials.shape[2]):
        total = total + w[..., s] * l[..., s]
        out = out + w[..., s, None] * acc[..., s, :]
    return (out / total.clamp(min=1e-20)[..., None]).to(dtype)
