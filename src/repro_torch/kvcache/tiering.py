"""HSM-style KV-cache tiering driven by the Robinhood policy engine.

Mapping (DESIGN.md SS2): the hot :class:`PagePool` is an OST (bounded HBM);
host DRAM is the HSM backend; each page is a catalog entry whose atime is
its last attention access; purge-on-watermark reproduces the paper's
per-OST release policy — when the hot pool crosses ``high_wm`` the engine
archives+releases least-recently-used pages until ``low_wm``; touching a
released page restores it transparently (like Lustre reads on released
files). O(1) residency stats come from the same StatsAggregator.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.catalog import Catalog
from ..core.policy import parse_expr
from ..core.policy_engine import (PolicyDefinition, PolicyEngine,
                                  UsageWatermarkTrigger)
from ..core.stats import StatsAggregator
from ..core.types import Entry, FsType, HsmState
from .paged import PagePool, SequencePages


class TieredKvCache:
    """Two-tier paged KV cache with policy-driven migration."""

    def __init__(self, pool: PagePool, high_wm: float = 80.0,
                 low_wm: float = 50.0,
                 clock: Callable[[], float] = time.time) -> None:
        self.pool = pool
        self.clock = clock
        self.cold: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}  # fid->k,v
        self.catalog = Catalog(n_shards=2)
        self.stats = StatsAggregator(self.catalog.strings)
        self.catalog.add_delta_hook(self.stats.on_delta)
        self.engine = PolicyEngine(self.catalog, clock=clock,
                                   device=pool.device)
        self.sequences: Dict[int, SequencePages] = {}
        self._page_fid: Dict[Tuple[int, int], int] = {}   # (seq, idx)->fid
        self._fid_info: Dict[int, dict] = {}              # fid -> info
        self._next_fid = 1
        self._pinned: set = set()       # fids immune to eviction (in use)
        self.restores = 0
        self.page_bytes = (pool.page_size * pool.n_kv * pool.head_dim
                           * 2 * pool.k.element_size())

        def do_release(e: Entry, params: dict) -> bool:
            return self._release_page(e.fid)

        self.engine.register(PolicyDefinition.from_config(
            name="kv_release", action=do_release,
            scope="type == file",
            rules=[("resident_pages", "status == 'hot'", {})],
            sort_by="atime",            # LRU, like the paper's purge
        ))
        self.engine.add_watermark_trigger(
            "kv_release",
            UsageWatermarkTrigger(
                usage_fn=lambda: [("hot_pool", self.pool.used * self.page_bytes,
                                   self.pool.n_pages * self.page_bytes)],
                high_pct=high_wm, low_pct=low_wm,
                restrict_fn=lambda key: parse_expr("status == 'hot'")))

    # -- catalog plumbing --------------------------------------------------------
    def _register_page(self, seq_id: int, idx: int, page_id: int) -> int:
        fid = self._next_fid
        self._next_fid += 1
        self._page_fid[(seq_id, idx)] = fid
        self._fid_info[fid] = {"seq": seq_id, "idx": idx, "page": page_id}
        now = self.clock()
        self.catalog.upsert(Entry(
            fid=fid, name=f"seq{seq_id}/page{idx}", path=f"/kv/{seq_id}/{idx}",
            type=FsType.FILE, size=self.page_bytes, blocks=self.page_bytes,
            owner=f"seq{seq_id}", status="hot", atime=now, mtime=now,
            ctime=now))
        return fid

    # -- serving-side API ---------------------------------------------------------
    def admit(self, seq_id: int) -> SequencePages:
        sp = SequencePages(seq_id)
        self.sequences[seq_id] = sp
        return sp

    def append_token(self, seq_id: int, k, v) -> None:
        """Write one token's K/V; allocates (possibly evicting) as needed.

        ``k``/``v``: (K, hd) tensors on the pool's device, or numpy arrays.
        """
        sp = self.sequences[seq_id]
        slot = sp.length % self.pool.page_size
        if slot == 0:
            page = self._alloc_with_pressure()
            idx = len(sp.page_ids)
            sp.page_ids.append(page)
            self._register_page(seq_id, idx, page)
        idx = sp.length // self.pool.page_size
        self._ensure_resident(seq_id, idx)
        page = sp.page_ids[idx]
        self.pool.write_token(page, slot, k, v)
        sp.length += 1
        self._touch(seq_id, idx)

    def page_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Resident page table for attention; restores released pages.

        Pages of ``seq_id`` are pinned while the table is live so restoring
        page N cannot evict freshly-restored page M of the same sequence.
        """
        sp = self.sequences[seq_id]
        self._pinned = {self._page_fid[(seq_id, i)]
                        for i in range(len(sp.page_ids))}
        for idx in range(len(sp.page_ids)):
            self._ensure_resident(seq_id, idx)
            self._touch(seq_id, idx)
        return sp.table(max_pages)

    def unpin(self) -> None:
        self._pinned = set()

    def finish(self, seq_id: int) -> None:
        """Request completed: free everything it held."""
        sp = self.sequences.pop(seq_id, None)
        if sp is None:
            return
        for idx, page in enumerate(sp.page_ids):
            fid = self._page_fid.pop((seq_id, idx), None)
            if fid is None:
                continue
            info = self._fid_info.pop(fid)
            if fid in self.cold:
                del self.cold[fid]
            e = self.catalog.get(fid)
            if e is not None and e.status == "hot":
                self.pool.free(info["page"])
            self.catalog.remove(fid)

    # -- tier movement ------------------------------------------------------------
    def _touch(self, seq_id: int, idx: int) -> None:
        fid = self._page_fid[(seq_id, idx)]
        self.catalog.update_fields(fid, atime=self.clock())

    def _alloc_with_pressure(self) -> int:
        page = self.pool.alloc()
        if page is None:
            self.engine.check_triggers()
            page = self.pool.alloc()
        if page is None:
            # hard fallback: force-release the LRU hot page
            self.engine.run("kv_release",
                            target_volume=self.page_bytes)
            page = self.pool.alloc()
        if page is None:
            raise MemoryError("hot KV pool exhausted")
        return page

    def _release_page(self, fid: int) -> bool:
        """hot -> cold: archive payload to host then free the hot slot."""
        if fid in self._pinned:
            return False                 # in use by a live page table
        info = self._fid_info.get(fid)
        if info is None:
            return False
        e = self.catalog.get(fid)
        if e is None or e.status != "hot":
            return False
        k, v = self.pool.read_page(info["page"])
        self.cold[fid] = (k, v)
        self.pool.free(info["page"])
        self.catalog.update_fields(fid, status="cold",
                                   hsm_state=HsmState.RELEASED, blocks=0)
        return True

    def _ensure_resident(self, seq_id: int, idx: int) -> None:
        """cold -> hot restore on access (transparent, like Lustre-HSM)."""
        fid = self._page_fid.get((seq_id, idx))
        if fid is None:
            return
        e = self.catalog.get(fid)
        if e is None or e.status == "hot":
            return
        page = self._alloc_with_pressure()
        k, v = self.cold.pop(fid)
        self.pool.write_page(page, k, v)
        self._fid_info[fid]["page"] = page
        self.sequences[seq_id].page_ids[idx] = page
        self.catalog.update_fields(fid, status="hot",
                                   hsm_state=HsmState.ARCHIVED,
                                   blocks=self.page_bytes)
        self.restores += 1

    def maybe_run_policies(self) -> None:
        """Periodic trigger check (call between decode steps)."""
        self.engine.check_triggers()

    # -- O(1) stats (rbh-report for the cache) --------------------------------------
    def residency_report(self, seq_id: int) -> List[dict]:
        return self.stats.report_user(f"seq{seq_id}")

    def tier_report(self) -> Dict[str, dict]:
        cols = self.catalog.arrays()
        hot_code = self.catalog.strings.code_of("hot")
        cold_code = self.catalog.strings.code_of("cold")
        hot = int((cols["status"] == hot_code).sum()) if hot_code is not None else 0
        cold = int((cols["status"] == cold_code).sum()) if cold_code is not None else 0
        return {"hot_pages": hot, "cold_pages": cold,
                "hot_usage_pct": self.pool.usage_pct,
                "restores": self.restores}
