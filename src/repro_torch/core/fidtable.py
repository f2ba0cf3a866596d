"""Fid-keyed parallel numpy columns with O(1) upsert/remove.

Shared storage primitive behind the policy engine's incremental match
state (cached match table + age-flip schedule) and the profile cube's
per-shard entry table (bucket membership + age-rollover schedule).

Row addressing is a **sorted base + overlay**: ``bulk_load`` keeps a
sorted copy of the loaded fids so lookups are one vectorized
``searchsorted`` (no million-insert python dict on the bulk path — the
dict build used to dominate full rebuilds); rows upserted after the load
live in a small dict overlay that is consulted only when non-empty.
Rows are tombstoned on removal and the storage compacts itself once the
dead fraction dominates; ``live()`` snapshots the surviving rows in
arbitrary order (callers impose a total order by sorting on content).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class FidTable:
    """Fid-keyed parallel numpy columns with O(1) upsert/remove."""

    def __init__(self, specs: Sequence[Tuple[str, type]], cap: int = 1024
                 ) -> None:
        self._specs = tuple(specs)
        self._reset(cap)

    def _reset(self, cap: int) -> None:
        cap = max(1, cap)
        self._fids = np.zeros(cap, dtype=np.int64)
        self._cols = {name: np.zeros(cap, dtype=dt)
                      for name, dt in self._specs}
        self._alive = np.zeros(cap, dtype=bool)
        self._n = 0                               # high-water row count
        self._count = 0                           # live row count
        self._sorted_fids = np.zeros(0, dtype=np.int64)
        self._sorted_rows = np.zeros(0, dtype=np.int64)
        self._overlay: Dict[int, int] = {}        # post-load fid -> row

    def __len__(self) -> int:
        return self._count

    def _grow(self, need: int) -> None:
        cap = len(self._alive)
        while cap < need:
            cap *= 2
        for name in self._cols:
            col = np.zeros(cap, dtype=self._cols[name].dtype)
            col[: self._n] = self._cols[name][: self._n]
            self._cols[name] = col
        fids = np.zeros(cap, dtype=np.int64)
        fids[: self._n] = self._fids[: self._n]
        self._fids = fids
        alive = np.zeros(cap, dtype=bool)
        alive[: self._n] = self._alive[: self._n]
        self._alive = alive

    def _lookup(self, fid_arr: np.ndarray, fid_list: List[int]
                ) -> np.ndarray:
        """Rows for the given fids, -1 where absent/dead. Sorted-base
        search is fully vectorized; the overlay loop only runs when rows
        were upserted since the last bulk load (churn-sized)."""
        rows = np.full(len(fid_list), -1, dtype=np.int64)
        if self._sorted_fids.size:
            pos = np.searchsorted(self._sorted_fids, fid_arr)
            pos_c = np.clip(pos, 0, self._sorted_fids.size - 1)
            base = self._sorted_rows[pos_c]
            hit = (self._sorted_fids[pos_c] == fid_arr) & self._alive[base]
            rows = np.where(hit, base, rows)
        if self._overlay:
            get = self._overlay.get
            for i, f in enumerate(fid_list):
                r = get(f)
                if r is not None:
                    rows[i] = r
        return rows

    def bulk_load(self, fids: np.ndarray, **cols: np.ndarray) -> None:
        """Replace the whole table with the given rows."""
        fids = np.asarray(fids, dtype=np.int64)
        n = len(fids)
        # 25% headroom: the first churn after a bulk load upserts into the
        # overlay without an immediate full grow-copy
        self._reset(max(1024, n + (n >> 2)))
        self._fids[:n] = fids
        for name, vals in cols.items():
            self._cols[name][:n] = vals
        self._alive[:n] = True
        self._n = n
        self._count = n
        order = np.argsort(fids, kind="stable")
        self._sorted_fids = fids[order]
        self._sorted_rows = order

    def upsert_many(self, fids: List[int], **cols: np.ndarray) -> None:
        if not len(fids):
            return
        fid_arr = np.asarray(fids, dtype=np.int64)
        fid_list = fid_arr.tolist()
        pos = self._lookup(fid_arr, fid_list)
        missing = np.nonzero(pos < 0)[0]
        for i in missing.tolist():
            f = fid_list[i]
            # a duplicate fid earlier in this call may have allocated
            # already — reuse its row (last write wins, like the lookup)
            p = self._overlay.get(f)
            if p is None:
                if self._n >= len(self._alive):
                    self._grow(self._n + 1)
                p = self._n
                self._n += 1
                self._count += 1
                self._overlay[f] = p
                self._fids[p] = f
                self._alive[p] = True
            pos[i] = p
        for name, vals in cols.items():
            self._cols[name][pos] = vals

    def remove_many(self, fids: Iterable[int]) -> None:
        fid_list = list(fids)
        if not fid_list:
            return
        pos = self._lookup(np.asarray(fid_list, dtype=np.int64), fid_list)
        for f, p in zip(fid_list, pos.tolist()):
            if p >= 0:
                self._alive[p] = False
                self._count -= 1
                self._overlay.pop(f, None)

    def maybe_compact(self) -> None:
        dead = self._n - self._count
        if dead > 1024 and dead > self._count:
            fids, cols = self.live()
            self.bulk_load(fids, **cols)

    def live(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        idx = np.nonzero(self._alive[: self._n])[0]
        return (self._fids[idx].copy(),
                {name: col[idx].copy() for name, col in self._cols.items()})

    def gather(self, fids: Sequence[int]
               ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Row values for specific fids: (present mask, column dict).

        Absent fids read 0 with ``present[i] == False`` — the signed-delta
        analogue of :meth:`Catalog.column_slice`, but over the derived
        table instead of the catalog itself.
        """
        fid_list = list(fids)
        idx = self._lookup(np.asarray(fid_list, dtype=np.int64), fid_list)
        present = idx >= 0
        safe = np.where(present, idx, 0)
        cols = {name: np.where(present, col[safe], col.dtype.type(0))
                for name, col in self._cols.items()}
        return present, cols

    def select_le(self, col: str, val: float) -> np.ndarray:
        """Fids of live rows whose ``col`` value is <= ``val``."""
        sel = self._alive[: self._n] & (self._cols[col][: self._n] <= val)
        return self._fids[: self._n][sel]

    def min_col(self, col: str) -> float:
        """Minimum of ``col`` over live rows (+inf when empty) — lets
        callers cache a due-threshold and skip full scans."""
        vals = self._cols[col][: self._n][self._alive[: self._n]]
        return float(vals.min()) if vals.size else float("inf")
