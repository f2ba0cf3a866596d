"""Public paged-attention op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors, and nothing else.

``use_kernel=None`` picks by the device of ``q``. ``use_kernel=True`` on a
CPU tensor raises (there is no kernel to run there) and so does
``use_kernel=False`` on a CUDA tensor: the plain version serves CPU tensors
only here (call ``ref.paged_attention_ref`` directly to run it on the
card).

The page table and lengths are built on the host by the serving engine, so
they may come as numpy arrays or CPU tensors: they are checked there with
numpy and cross to ``q``'s device in one copy that does not wait for the
card (CUDA stages a small pageable host-to-device copy at once).
Only they cross per call; the K/V pools stay where they are.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._launches import kernel_for
from .kernel import paged_attention_cuda
from .ref import paged_attention_ref

__all__ = ["paged_attention"]


def _host(x, name: str) -> np.ndarray:
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"{name} must hold integers, got {a.dtype}")
    return a


def _tables(page_table, lengths, n_pages: int, device: torch.device):
    """(page_table, lengths) as contiguous i32 tensors on ``device``, page
    ids checked to lie in [-1, n_pages)."""
    if all(isinstance(t, torch.Tensor) and t.device == device
           for t in (page_table, lengths)):
        for name, t in (("page_table", page_table), ("lengths", lengths)):
            if t.dtype.is_floating_point or t.dtype.is_complex \
                    or t.dtype == torch.bool:
                raise TypeError(f"{name} must hold integers, got {t.dtype}")
        if page_table.numel() and bool(
                ((page_table < -1) | (page_table >= n_pages)).any()):
            raise ValueError(f"page_table holds ids outside [-1, {n_pages})")
        return (page_table.to(torch.int32).contiguous(),
                lengths.to(torch.int32).contiguous())
    pt, ln = _host(page_table, "page_table"), _host(lengths, "lengths")
    if pt.size and ((pt < -1) | (pt >= n_pages)).any():
        raise ValueError(f"page_table holds ids outside [-1, {n_pages})")
    buf = torch.from_numpy(np.concatenate(
        [pt.ravel(), ln.ravel()]).astype(np.int32, copy=False))
    buf = buf.to(device, non_blocking=True)
    return buf[:pt.size].view(pt.shape), buf[pt.size:]


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table, lengths,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q: (B, H, hd); pages: (n_pages, P, K, hd), f32 or bf16; page_table:
    (B, max_pages) ints, -1 = unused; lengths: (B,) ints (numpy arrays or
    tensors on the CPU or on ``q``'s device). Returns (B, H, hd) in q's
    dtype. Page ids below -1 or at or above n_pages raise (a table already
    on the card is checked there, which waits for it).
    """
    kernel = kernel_for(q.device, use_kernel, "paged_attention",
                        "ref.paged_attention_ref")
    page_table, lengths = _tables(page_table, lengths, k_pages.shape[0],
                                  q.device)
    if kernel:
        return paged_attention_cuda(q.contiguous(), k_pages.contiguous(),
                                    v_pages.contiguous(), page_table,
                                    lengths)
    return paged_attention_ref(q, k_pages, v_pages, page_table, lengths)
