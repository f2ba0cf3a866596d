"""Paged KV storage: fixed-size pages in a global pool + per-seq tables.

The pool is the "OST" of the serving tier: a bounded device-memory region
whose usage the policy engine watches. Pages are the catalog's entries.
The K/V pools are tensors on the card (the hot tier); a page leaves it as
host numpy copies (the cold tier is host DRAM) and comes back from them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class SequencePages:
    seq_id: int
    page_ids: List[int] = dataclasses.field(default_factory=list)
    length: int = 0          # tokens written

    def table(self, max_pages: int) -> np.ndarray:
        t = np.full(max_pages, -1, np.int32)
        t[: len(self.page_ids)] = self.page_ids
        return t


class PagePool:
    """(n_pages, page_size, K, hd) K/V pool with a free list.

    ``k``/``v`` are contiguous tensors on ``device`` (the CUDA card unless
    the caller passes ``device="cpu"``); ``write_token`` and ``free`` write
    them in place. Released pages live on the host as numpy arrays; numpy
    has no bfloat16, so a bf16 page leaves as an int16 view of its bits
    and comes back through the same view, every bit kept.
    """

    def __init__(self, n_pages: int, page_size: int, n_kv: int,
                 head_dim: int, dtype=torch.float32, device=None) -> None:
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_kv = n_kv
        self.head_dim = head_dim
        self.device = resolve_device(device)
        shape = (n_pages, page_size, n_kv, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))

    # -- allocation ------------------------------------------------------------
    def alloc(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def free(self, page_id: int) -> None:
        self.k[page_id] = 0
        self.v[page_id] = 0
        self._free.append(page_id)

    @property
    def used(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def usage_pct(self) -> float:
        return 100.0 * self.used / self.n_pages

    # -- data ---------------------------------------------------------------------
    def write_token(self, page_id: int, slot: int, k, v) -> None:
        """``k``/``v``: (K, hd) tensors (on any device) or numpy arrays."""
        self.k[page_id, slot] = torch.as_tensor(k)
        self.v[page_id, slot] = torch.as_tensor(v)

    def read_page(self, page_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of a page's K and V (int16 bit views for bf16)."""
        return self._host(self.k[page_id]), self._host(self.v[page_id])

    def write_page(self, page_id: int, k: np.ndarray, v: np.ndarray) -> None:
        """Writes back what :meth:`read_page` returned."""
        self.k[page_id] = self._from_host(k)
        self.v[page_id] = self._from_host(v)

    def _host(self, page: torch.Tensor) -> np.ndarray:
        page = page.to("cpu", copy=True)
        if page.dtype == torch.bfloat16:
            page = page.view(torch.int16)
        return page.numpy()

    def _from_host(self, a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(a)
        if self.k.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        return t
