"""Columnar, sharded metadata catalog — the paper's "database" (C1).

The paper stores the filesystem-metadata mirror in MySQL and observes
(SIII-B) that a single DB host becomes the bottleneck once DNE spreads the
namespace over several MDSes; it names catalog *sharding* as the way out.
This implementation builds that future directly:

* entries live in N independent **shards** (hash of fid), each with its own
  lock, so concurrent changelog streams (one per MDT) never contend;
* each shard is **columnar** (struct-of-arrays, numpy): policy predicates and
  report aggregations run as vectorized column masks — the in-process
  analogue of a DB table scan, and the exact memory layout consumed by the
  ``policy_scan`` CUDA kernel on the GPU;
* durability is sqlite WAL (optional): a batch of updates is committed to
  sqlite *before* the changelog reader acks, preserving the paper's
  transactional contract (SII-C2).

Strings (owner, group, pool, status) are interned to int32 codes in a shared
:class:`StringTable`, which is what makes vectorized/accelerator predicate
evaluation possible.
"""
from __future__ import annotations

import os
import sqlite3
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .telemetry import MetricRegistry, counter_attr
from .types import Entry, FsType, HsmState

# Stats/alert hooks receive these light tuples instead of full Entries.
# (fid, owner_code, group_code, type, size, blocks, hsm_state, atime) —
# everything the pre-aggregated stats and the profile cube need to apply a
# signed bucket update without re-reading the shard.
Delta = Tuple[int, int, int, int, int, int, int, float]

_NUMERIC_COLUMNS: Tuple[Tuple[str, np.dtype], ...] = (
    ("fid", np.int64),
    ("parent_fid", np.int64),
    ("type", np.int8),
    ("size", np.int64),
    ("blocks", np.int64),
    ("mode", np.int32),
    ("nlink", np.int32),
    ("atime", np.float64),
    ("mtime", np.float64),
    ("ctime", np.float64),
    ("ost_idx", np.int16),
    ("hsm_state", np.int8),
    ("archive_id", np.int32),
    ("owner", np.int32),     # interned code
    ("group", np.int32),     # interned code
    ("pool", np.int32),      # interned code
    ("status", np.int32),    # interned code (v3 generic-policy status)
    ("dirty", np.int8),
)
_STRING_FIELDS = ("owner", "group", "pool", "status")

# Enum instance caches: Enum.__call__ is surprisingly hot when a batch fetch
# rebuilds tens of thousands of entries.
_FSTYPE = {int(t): t for t in FsType}
_HSMSTATE = {int(s): s for s in HsmState}


class _StringSnapshot:
    """Frozen view of one shard's name/path lists + its valid row indices."""

    __slots__ = ("idx", "names", "paths")

    def __init__(self, idx: np.ndarray, names: List[str],
                 paths: List[str]) -> None:
        self.idx = idx
        self.names = names
        self.paths = paths

    def gather(self, attr: str) -> List[str]:
        src = self.paths if attr == "_paths" else self.names
        return [src[i] for i in self.idx]


class LazyColumns(dict):
    """Column dict whose expensive keys materialize on first access.

    ``Catalog.arrays()`` returns numeric columns eagerly (cheap vectorized
    copies) but defers the per-row ``_paths``/``_names`` python lists —
    only host-side glob predicates and path reports consume them, and
    building them dominates columnar matching cost on large catalogs.
    """

    def __init__(self, data: Dict[str, np.ndarray],
                 loaders: Dict[str, Callable[[], list]]) -> None:
        super().__init__(data)
        self._loaders = loaders

    def __missing__(self, key):
        fn = self._loaders.get(key)
        if fn is None:
            raise KeyError(key)
        val = fn()
        self[key] = val
        return val

    def __contains__(self, key) -> bool:
        return super().__contains__(key) or key in self._loaders


class ColumnBatch:
    """Entry-free columnar view of a set of catalog rows.

    The zero-materialization contract of the batched action path: a
    ``ColumnBatch`` carries every numeric column (fid/size/blocks/hsm_state/
    owner-code/... as numpy arrays aligned with the requested fid order)
    plus a ``present`` mask, WITHOUT constructing a single Python ``Entry``.
    Batch actions consume it directly; the few that genuinely need full
    ``Entry`` objects declare ``needs_entries = True`` (see
    ``core.plugins``) and the engine materializes for them alone.

    * numeric columns: attribute access (``batch.size``, ``batch.fid``) or
      ``batch.col(name)``;
    * interned string columns: ``batch.decode("owner")`` lazily decodes the
      int32 codes through the shared :class:`StringTable` (cached);
    * ``take(idx)`` slices a sub-batch (used for per-rule action groups);
    * ``entries()`` is the materializing escape hatch — one
      :meth:`Catalog.get_batch` call, cached; only ``needs_entries``
      plugins and the legacy benchmark path pay it.
    """

    __slots__ = ("cols", "present", "strings", "_catalog", "_decoded",
                 "_entries")

    def __init__(self, cols: Dict[str, np.ndarray], present: np.ndarray,
                 strings: "StringTable", catalog=None) -> None:
        self.cols = cols
        self.present = present
        self.strings = strings
        self._catalog = catalog
        self._decoded: Dict[str, list] = {}
        self._entries = None

    def __len__(self) -> int:
        return len(self.present)

    @property
    def fids(self) -> np.ndarray:
        return self.cols["fid"]

    def col(self, name: str) -> np.ndarray:
        return self.cols[name]

    def __getattr__(self, name: str):
        try:
            return self.cols[name]
        except KeyError:
            raise AttributeError(name) from None

    def decode(self, name: str) -> List[str]:
        """Lazily decode an interned string column (owner/group/pool/status)
        to a list of strings; absent rows decode to ''."""
        out = self._decoded.get(name)
        if out is None:
            lookup = self.strings.lookup
            out = [lookup(c) for c in self.cols[name].tolist()]
            self._decoded[name] = out
        return out

    def take(self, idx) -> "ColumnBatch":
        """Sub-batch at the given positions (int indices or bool mask)."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        idx = idx.astype(np.int64)
        pos = idx.tolist()
        cols = {k: (v[idx] if isinstance(v, np.ndarray)
                    else [v[i] for i in pos])           # _names/_paths lists
                for k, v in self.cols.items()}
        sub = ColumnBatch(cols, self.present[idx], self.strings,
                          self._catalog)
        if self._entries is not None:
            sub._entries = [self._entries[i] for i in idx.tolist()]
        return sub

    def entries(self) -> List[Optional[Entry]]:
        """Materialize full Entry objects (cached; the cost this view
        exists to avoid — only ``needs_entries`` actions trigger it)."""
        if self._entries is None:
            if self._catalog is None:
                raise RuntimeError("ColumnBatch has no catalog attached")
            self._entries = self._catalog.get_batch(self.fids.tolist())
        return self._entries

    @classmethod
    def from_entries(cls, entries: Sequence[Optional[Entry]],
                     strings: "StringTable", catalog=None) -> "ColumnBatch":
        """Build a batch from already-materialized entries (the legacy
        Entry-first execution path; pure overhead the columnar path skips).
        Absent entries (None) read 0 with ``present=False``."""
        n = len(entries)
        cols = {name: np.zeros(n, dtype=dt) for name, dt in _NUMERIC_COLUMNS}
        present = np.zeros(n, dtype=bool)
        for i, e in enumerate(entries):
            if e is None:
                continue
            present[i] = True
            cols["fid"][i] = e.fid
            cols["parent_fid"][i] = e.parent_fid
            cols["type"][i] = int(e.type)
            cols["size"][i] = e.size
            cols["blocks"][i] = e.blocks
            cols["mode"][i] = e.mode
            cols["nlink"][i] = e.nlink
            cols["atime"][i] = e.atime
            cols["mtime"][i] = e.mtime
            cols["ctime"][i] = e.ctime
            cols["ost_idx"][i] = e.ost_idx
            cols["hsm_state"][i] = int(e.hsm_state)
            cols["archive_id"][i] = e.archive_id
            cols["owner"][i] = strings.intern(e.owner)
            cols["group"][i] = strings.intern(e.group)
            cols["pool"][i] = strings.intern(e.pool)
            cols["status"][i] = strings.intern(e.status)
            cols["dirty"][i] = 1 if e.dirty else 0
        batch = cls(cols, present, strings, catalog)
        batch._entries = list(entries)
        return batch


class StringTable:
    """Bidirectional string<->int32 interning table (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._to_code: Dict[str, int] = {}
        self._to_str: List[str] = []
        self.intern("")  # code 0 is always the empty string

    def intern(self, s: str) -> int:
        with self._lock:
            code = self._to_code.get(s)
            if code is None:
                code = len(self._to_str)
                self._to_code[s] = code
                self._to_str.append(s)
            return code

    def lookup(self, code: int) -> str:
        return self._to_str[code]

    def code_of(self, s: str) -> Optional[int]:
        return self._to_code.get(s)

    def __len__(self) -> int:
        return len(self._to_str)


class CatalogShard:
    """One catalog shard: columnar entry store with amortized growth."""

    _INITIAL = 1024

    def __init__(self, shard_id: int, strings: StringTable) -> None:
        self.shard_id = shard_id
        self.strings = strings
        # per-shard change tick: bumped (under the shard lock) by every
        # mutation that lands in THIS shard, so per-shard derived caches
        # (Reports' path index, profile cubes) rebuild only the shards
        # that actually churned — Catalog.version stays the global tick.
        self.version = 0
        self.lock = threading.RLock()
        self._rows: Dict[int, int] = {}          # fid -> row index
        self._free: List[int] = []
        self._n = 0                               # high-water row count
        self._cols: Dict[str, np.ndarray] = {
            name: np.zeros(self._INITIAL, dtype=dt) for name, dt in _NUMERIC_COLUMNS
        }
        self._valid = np.zeros(self._INITIAL, dtype=bool)
        self._names: List[str] = [""] * self._INITIAL
        self._paths: List[str] = [""] * self._INITIAL
        self._xattrs: List[Optional[dict]] = [None] * self._INITIAL
        self._stripes: List[tuple] = [()] * self._INITIAL

    # -- storage management -------------------------------------------------
    def _grow(self) -> None:
        cap = len(self._valid)
        new_cap = cap * 2
        for name in self._cols:
            col = np.zeros(new_cap, dtype=self._cols[name].dtype)
            col[:cap] = self._cols[name]
            self._cols[name] = col
        valid = np.zeros(new_cap, dtype=bool)
        valid[:cap] = self._valid
        self._valid = valid
        self._names.extend([""] * cap)
        self._paths.extend([""] * cap)
        self._xattrs.extend([None] * cap)
        self._stripes.extend([()] * cap)

    def _alloc_row(self) -> int:
        if self._free:
            return self._free.pop()
        if self._n >= len(self._valid):
            self._grow()
        row = self._n
        self._n += 1
        return row

    # -- entry operations ---------------------------------------------------
    def _row_delta(self, row: int) -> Delta:
        c = self._cols
        return (int(c["fid"][row]), int(c["owner"][row]),
                int(c["group"][row]), int(c["type"][row]),
                int(c["size"][row]), int(c["blocks"][row]),
                int(c["hsm_state"][row]), float(c["atime"][row]))

    def _upsert_locked(self, e: Entry) -> Tuple[Optional[Delta], Delta]:
        row = self._rows.get(e.fid)
        old: Optional[Delta] = None
        if row is None:
            row = self._alloc_row()
            self._rows[e.fid] = row
            self._valid[row] = True
        else:
            old = self._row_delta(row)
        c = self._cols
        c["fid"][row] = e.fid
        c["parent_fid"][row] = e.parent_fid
        c["type"][row] = int(e.type)
        c["size"][row] = e.size
        c["blocks"][row] = e.blocks
        c["mode"][row] = e.mode
        c["nlink"][row] = e.nlink
        c["atime"][row] = e.atime
        c["mtime"][row] = e.mtime
        c["ctime"][row] = e.ctime
        c["ost_idx"][row] = e.ost_idx
        c["hsm_state"][row] = int(e.hsm_state)
        c["archive_id"][row] = e.archive_id
        c["owner"][row] = self.strings.intern(e.owner)
        c["group"][row] = self.strings.intern(e.group)
        c["pool"][row] = self.strings.intern(e.pool)
        c["status"][row] = self.strings.intern(e.status)
        c["dirty"][row] = 1 if e.dirty else 0
        self._names[row] = e.name
        self._paths[row] = e.path
        self._xattrs[row] = dict(e.xattrs) if e.xattrs else None
        self._stripes[row] = tuple(e.stripe_osts)
        self.version += 1
        return old, self._row_delta(row)

    def upsert(self, e: Entry) -> Tuple[Optional[Delta], Delta]:
        """Insert or update an entry; returns (old_delta|None, new_delta)."""
        with self.lock:
            return self._upsert_locked(e)

    def upsert_many(self, entries: Sequence[Entry]
                    ) -> List[Tuple[Optional[Delta], Delta]]:
        """Upsert a batch under ONE lock acquisition (the columnar ingest
        commit path) — same per-entry semantics as :meth:`upsert`."""
        with self.lock:
            return [self._upsert_locked(e) for e in entries]

    def update_fields(self, fid: int, **fields) -> Optional[Tuple[Delta, Delta]]:
        """Patch a subset of attributes; returns (old, new) deltas or None."""
        with self.lock:
            row = self._rows.get(fid)
            if row is None:
                return None
            old = self._row_delta(row)
            c = self._cols
            for k, v in fields.items():
                if k in ("name",):
                    self._names[row] = v
                elif k in ("path",):
                    self._paths[row] = v
                elif k == "xattrs":
                    self._xattrs[row] = dict(v) if v else None
                elif k == "stripe_osts":
                    self._stripes[row] = tuple(v)
                elif k in _STRING_FIELDS:
                    c[k][row] = self.strings.intern(v)
                elif k == "hsm_state":
                    c[k][row] = int(v)
                elif k == "type":
                    c[k][row] = int(v)
                elif k == "dirty":
                    c[k][row] = 1 if v else 0
                else:
                    c[k][row] = v
            self.version += 1
            return old, self._row_delta(row)

    def _remove_locked(self, fid: int) -> Optional[Delta]:
        row = self._rows.pop(fid, None)
        if row is None:
            return None
        old = self._row_delta(row)
        self._valid[row] = False
        self._names[row] = self._paths[row] = ""
        self._xattrs[row] = None
        self._stripes[row] = ()
        self._free.append(row)
        self.version += 1
        return old

    def remove(self, fid: int) -> Optional[Delta]:
        with self.lock:
            return self._remove_locked(fid)

    def remove_many(self, fids: Sequence[int]) -> List[Optional[Delta]]:
        """Remove a batch under one lock acquisition; absent fids yield
        ``None`` (a same-batch CREAT→UNLNK annihilation lands here)."""
        with self.lock:
            return [self._remove_locked(f) for f in fids]

    def get(self, fid: int) -> Optional[Entry]:
        with self.lock:
            row = self._rows.get(fid)
            if row is None:
                return None
            return self._entry_at(row)

    def _entry_at(self, row: int) -> Entry:
        c = self._cols
        return Entry(
            fid=int(c["fid"][row]), parent_fid=int(c["parent_fid"][row]),
            name=self._names[row], path=self._paths[row],
            type=FsType(int(c["type"][row])), size=int(c["size"][row]),
            blocks=int(c["blocks"][row]), mode=int(c["mode"][row]),
            nlink=int(c["nlink"][row]), atime=float(c["atime"][row]),
            mtime=float(c["mtime"][row]), ctime=float(c["ctime"][row]),
            ost_idx=int(c["ost_idx"][row]),
            stripe_osts=self._stripes[row],
            pool=self.strings.lookup(int(c["pool"][row])),
            hsm_state=HsmState(int(c["hsm_state"][row])),
            archive_id=int(c["archive_id"][row]),
            owner=self.strings.lookup(int(c["owner"][row])),
            group=self.strings.lookup(int(c["group"][row])),
            status=self.strings.lookup(int(c["status"][row])),
            xattrs=self._xattrs[row] or {},
            dirty=bool(c["dirty"][row]),
        )

    def get_batch(self, fids: Sequence[int]) -> List[Optional[Entry]]:
        """Fetch many entries under a single lock acquisition.

        Columns are gathered vectorized (one fancy-index + tolist per
        column) instead of one scalar read per field per row — the policy
        engine's execution hot path.
        """
        with self.lock:
            rows = [self._rows.get(f) for f in fids]
            hit = [r for r in rows if r is not None]
            if not hit:
                return [None] * len(fids)
            idx = np.asarray(hit, dtype=np.int64)
            c = {name: self._cols[name][idx].tolist() for name in self._cols}
            lookup = self.strings.lookup
            new = Entry.__new__
            entries = []
            for i, row in enumerate(hit):
                # bulk construction bypasses dataclass __init__ (hot path)
                e = new(Entry)
                e.__dict__ = {
                    "fid": c["fid"][i], "parent_fid": c["parent_fid"][i],
                    "name": self._names[row], "path": self._paths[row],
                    "type": _FSTYPE[c["type"][i]], "size": c["size"][i],
                    "blocks": c["blocks"][i], "owner": lookup(c["owner"][i]),
                    "group": lookup(c["group"][i]), "mode": c["mode"][i],
                    "nlink": c["nlink"][i], "atime": c["atime"][i],
                    "mtime": c["mtime"][i], "ctime": c["ctime"][i],
                    "ost_idx": c["ost_idx"][i],
                    "stripe_osts": self._stripes[row],
                    "pool": lookup(c["pool"][i]),
                    "hsm_state": _HSMSTATE[c["hsm_state"][i]],
                    "archive_id": c["archive_id"][i],
                    "status": lookup(c["status"][i]),
                    "xattrs": self._xattrs[row] or {},
                    "dirty": bool(c["dirty"][i]),
                }
                entries.append(e)
        out: List[Optional[Entry]] = []
        it = iter(entries)
        for r in rows:
            out.append(next(it) if r is not None else None)
        return out

    _DELTA_COLS = ("fid", "owner", "group", "type", "size", "blocks",
                   "hsm_state", "atime")
    # fields the vectorized patch can broadcast: plain numeric columns
    # (string-interned / per-row python fields fall back to the scalar loop)
    _VECTOR_FIELDS = frozenset(
        name for name, _ in _NUMERIC_COLUMNS) - frozenset(_STRING_FIELDS)

    def update_fields_batch(self, fids: Sequence[int], fields: dict
                            ) -> List[Optional[Tuple[Delta, Delta]]]:
        """Patch the same field subset on many entries under one lock.

        When every field is a plain numeric column (the dirty-tag path:
        ``dirty=1``), the patch is **vectorized**: one fancy-index
        assignment per field over the present rows instead of a per-fid
        scalar write — and the old/new :class:`Delta` tuples are gathered
        with one fancy-index per delta column. Mixed patches (names,
        paths, xattrs, interned strings) keep the scalar loop.
        """
        if not all(k in self._VECTOR_FIELDS for k in fields):
            with self.lock:
                return [self.update_fields(f, **fields) for f in fids]
        with self.lock:
            rows = [self._rows.get(f) for f in fids]
            hit = [r for r in rows if r is not None]
            if not hit:
                return [None] * len(fids)
            idx = np.asarray(hit, dtype=np.int64)
            c = self._cols
            old_cols = [c[name][idx] for name in self._DELTA_COLS]
            for k, v in fields.items():
                if k == "hsm_state" or k == "type":
                    v = int(v)
                elif k == "dirty":
                    v = 1 if v else 0
                c[k][idx] = v
            new_cols = [c[name][idx] for name in self._DELTA_COLS]
            self.version += 1
            olds = list(zip(*(col.tolist() for col in old_cols)))
            news = list(zip(*(col.tolist() for col in new_cols)))
        out: List[Optional[Tuple[Delta, Delta]]] = []
        it = iter(zip(olds, news))
        for r in rows:
            out.append(next(it) if r is not None else None)
        return out

    # -- vectorized access ----------------------------------------------------
    def snapshot(self, names: Optional[Sequence[str]] = None,
                 with_strings: bool = True
                 ) -> Tuple[Dict[str, np.ndarray],
                            Optional["_StringSnapshot"]]:
        """Consistent columnar snapshot under one lock acquisition.

        Numeric columns are copied (restricted to ``names`` when given —
        aggregation consumers like the profile cube skip the other ~half
        of the column stack); ``_paths``/``_names`` are captured as
        shallow list copies (a C-level pointer copy — cheap) so the
        expensive per-row gather can happen lazily later while staying
        consistent with the numeric rows (in-place shard mutations after
        the snapshot cannot be observed). ``with_strings=False`` skips
        even the pointer copies (the snapshot returns ``None`` strings —
        purely numeric consumers).
        """
        with self.lock:
            valid = self._valid[: self._n]
            cols = {name: self._cols[name][: self._n][valid].copy()
                    for name in (names if names is not None else self._cols)}
            if not with_strings:
                return cols, None
            snap = _StringSnapshot(np.nonzero(valid)[0],
                                   list(self._names), list(self._paths))
            return cols, snap

    def arrays(self) -> Dict[str, np.ndarray]:
        """Columnar views (copies) limited to valid rows, for vector queries."""
        out, snap = self.snapshot()
        out["_paths"] = snap.gather("_paths")   # type: ignore
        out["_names"] = snap.gather("_names")   # type: ignore
        return out

    def _gather(self, fids: Sequence[int], names: Sequence[str]
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Lock-held core of the fid-keyed gathers: (cols, safe_idx, present);
        absent fids read row 0 masked to the column dtype's zero."""
        idx = np.array([self._rows.get(f, -1) for f in fids], dtype=np.int64)
        present = idx >= 0
        safe = np.where(present, idx, 0)
        cols = {name: np.where(present, self._cols[name][safe],
                               self._cols[name].dtype.type(0))
                for name in names}
        return cols, safe, present

    def column_slice(self, fids: Sequence[int], names: Sequence[str]
                     ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Gather columns for specific fids without building Entry objects.

        Returns (cols, present): ``cols[name][i]`` is the value for
        ``fids[i]`` (0 where absent) and ``present[i]`` says whether the fid
        exists in this shard.
        """
        with self.lock:
            cols, _safe, present = self._gather(fids, names)
            return cols, present

    def row_slice(self, fids: Sequence[int], with_strings: bool = True
                  ) -> Tuple[Dict[str, np.ndarray], List[str], List[str],
                             np.ndarray]:
        """Full-row gather keyed by fid: every numeric column plus (when
        ``with_strings``) the name/path strings, under one lock acquisition.

        Returns (cols, names, paths, present) aligned with ``fids``; absent
        fids read 0 / "". This is the incremental-match analogue of
        :meth:`column_slice` — dirty rows are re-evaluated from it without
        touching the other ~N rows of the shard.
        """
        with self.lock:
            cols, safe, present = self._gather(fids, list(self._cols))
            if not with_strings:
                return cols, [], [], present
            names = [self._names[i] if p else ""
                     for i, p in zip(safe.tolist(), present.tolist())]
            paths = [self._paths[i] if p else ""
                     for i, p in zip(safe.tolist(), present.tolist())]
            return cols, names, paths, present

    def count(self) -> int:
        with self.lock:
            return len(self._rows)

    def fids(self) -> List[int]:
        with self.lock:
            return list(self._rows.keys())


class Catalog:
    """Sharded catalog facade: routing, hooks, persistence, vector queries."""

    # how often the full host column concat was asked for — the
    # mesh-resident report/profile paths assert this stays flat on warm
    # queries (tests/core/test_mesh_reports.py)
    arrays_calls = counter_attr(
        "catalog_arrays_calls", "full host column concatenations")

    def __init__(self, n_shards: int = 4, db_path: Optional[str] = None,
                 telemetry: Optional[MetricRegistry] = None) -> None:
        # the catalog anchors the deployment's telemetry plane: everything
        # attached to it (device store, reports, engine, pipeline) lands
        # series in this registry, disambiguated by instance labels
        self.telemetry = telemetry if telemetry is not None \
            else MetricRegistry()
        self._tlabels = {"catalog": self.telemetry.instance("catalog")}
        self.strings = StringTable()
        self.shards = [CatalogShard(i, self.strings) for i in range(n_shards)]
        self.n_shards = n_shards
        self._hooks: List[Callable[[Optional[Delta], Optional[Delta]], None]] = []
        self._batch_hooks: Dict[Callable, Callable] = {}
        self._entry_hooks: List[Callable[[Entry], None]] = []
        self.db_path = db_path
        self._db: Optional[sqlite3.Connection] = None
        self._db_lock = threading.Lock()
        self._version = 0
        self._version_lock = threading.Lock()
        self._arrays_cache: Optional[Tuple[int, "LazyColumns"]] = None
        self._arrays_lock = threading.Lock()
        self.arrays_calls = 0
        if db_path:
            self._open_db(db_path)

    # -- change tick ----------------------------------------------------------
    @property
    def version(self) -> int:
        """Monotonic change tick: bumped by every mutating operation.

        Readers (e.g. ``Reports``' sorted path index) cache derived
        structures keyed by it and rebuild only after the catalog changed.
        """
        return self._version

    def _bump(self) -> None:
        # Called AFTER a mutation is applied: a reader that caches under the
        # new version is then guaranteed to have seen the new data (a reader
        # racing the mutation itself caches under the old version and
        # rebuilds on its next check — one redundant rebuild, never stale).
        with self._version_lock:
            self._version += 1

    def sidecar_path(self, suffix: str) -> Optional[str]:
        """Path for a derived artifact stored beside the sqlite mirror
        (``<db_path>.<suffix>``) — e.g. the device store's packed warm
        segments — or ``None`` for an in-memory catalog (callers then
        keep the artifact in host memory instead)."""
        if not self.db_path:
            return None
        return f"{self.db_path}.{suffix}"

    # -- persistence ----------------------------------------------------------
    _SCHEMA = (
        "CREATE TABLE IF NOT EXISTS entries ("
        "fid INTEGER PRIMARY KEY, parent_fid INTEGER, name TEXT, path TEXT,"
        "type INTEGER, size INTEGER, blocks INTEGER, owner TEXT, grp TEXT,"
        "mode INTEGER, nlink INTEGER, atime REAL, mtime REAL, ctime REAL,"
        "ost_idx INTEGER, pool TEXT, hsm_state INTEGER, archive_id INTEGER,"
        "status TEXT, dirty INTEGER)"
    )

    def _open_db(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(self._SCHEMA)
        self._db.commit()

    def _persist(self, entries: Sequence[Entry], removed: Sequence[int]) -> None:
        if self._db is None:
            return
        with self._db_lock:
            if entries:
                self._db.executemany(
                    "INSERT OR REPLACE INTO entries VALUES "
                    "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    [(e.fid, e.parent_fid, e.name, e.path, int(e.type), e.size,
                      e.blocks, e.owner, e.group, e.mode, e.nlink, e.atime,
                      e.mtime, e.ctime, e.ost_idx, e.pool, int(e.hsm_state),
                      e.archive_id, e.status, int(e.dirty)) for e in entries],
                )
            if removed:
                self._db.executemany("DELETE FROM entries WHERE fid=?",
                                     [(f,) for f in removed])
            self._db.commit()   # durable before changelog ack

    def load_from_db(self) -> int:
        """Crash recovery: repopulate shards from sqlite. Returns #entries."""
        if self._db is None:
            return 0
        n = 0
        with self._db_lock:
            cur = self._db.execute("SELECT * FROM entries")
            rows = cur.fetchall()
        for r in rows:
            e = Entry(fid=r[0], parent_fid=r[1], name=r[2], path=r[3],
                      type=FsType(r[4]), size=r[5], blocks=r[6], owner=r[7],
                      group=r[8], mode=r[9], nlink=r[10], atime=r[11],
                      mtime=r[12], ctime=r[13], ost_idx=r[14], pool=r[15],
                      hsm_state=HsmState(r[16]), archive_id=r[17],
                      status=r[18], dirty=bool(r[19]))
            self.upsert(e, persist=False)
            n += 1
        return n

    # -- hooks (stats aggregators, alerts) -------------------------------------
    def add_delta_hook(self, fn: Callable[[Optional[Delta], Optional[Delta]], None],
                       batch: Optional[Callable[[List[Tuple[Optional[Delta],
                                                            Optional[Delta]]]],
                                                None]] = None) -> None:
        """Register a delta consumer. ``fn(old, new)`` fires per mutation
        on the scalar paths; a consumer that also passes ``batch`` gets
        the whole committed batch in **one** call (``batch(pairs)``) on
        the batched paths instead of N scalar invocations — the single
        fan-out contract of the columnar ingest plane. Consumers without
        a batch variant still see every mutation (the batch dispatcher
        loops their scalar hook), so the two registration styles are
        behaviorally identical, batch-aware ones just pay one call."""
        self._hooks.append(fn)
        if batch is not None:
            self._batch_hooks[fn] = batch

    def remove_delta_hook(self, fn: Callable[[Optional[Delta], Optional[Delta]], None]) -> None:
        """Unregister a delta hook (no-op if absent) — long-lived catalogs
        must not keep feeding consumers that were replaced (e.g. a
        detached DeviceColumnStore)."""
        try:
            self._hooks.remove(fn)
        except ValueError:
            pass
        self._batch_hooks.pop(fn, None)

    def add_entry_hook(self, fn: Callable[[Entry], None]) -> None:
        """Entry-level hook (alerts need names/paths, not just deltas)."""
        self._entry_hooks.append(fn)

    def _fire(self, old: Optional[Delta], new: Optional[Delta]) -> None:
        for fn in self._hooks:
            fn(old, new)

    def _fire_batch(self, pairs: List[Tuple[Optional[Delta],
                                            Optional[Delta]]]) -> None:
        """Dispatch one committed batch to every delta consumer: one call
        for batch-registered hooks, a scalar loop for the rest."""
        if not pairs:
            return
        for fn in self._hooks:
            batch_fn = self._batch_hooks.get(fn)
            if batch_fn is not None:
                batch_fn(pairs)
            else:
                for old, new in pairs:
                    fn(old, new)

    # -- routing ----------------------------------------------------------------
    def _shard_id(self, fid: int) -> int:
        """Single routing authority — every scalar and batch path uses it."""
        return fid % self.n_shards

    def _shard_ids(self, fids: np.ndarray) -> np.ndarray:
        """Vectorized counterpart of :meth:`_shard_id` (same formula)."""
        return fids % self.n_shards

    def shard_of(self, fid: int) -> CatalogShard:
        return self.shards[self._shard_id(fid)]

    # -- operations ---------------------------------------------------------------
    def upsert(self, e: Entry, persist: bool = True) -> None:
        old, new = self.shard_of(e.fid).upsert(e)
        self._bump()
        self._fire(old, new)
        for fn in self._entry_hooks:
            fn(e)
        if persist:
            self._persist([e], [])

    def upsert_batch(self, entries: Sequence[Entry]) -> None:
        """Apply a batch then durably commit — callers ack changelog after."""
        for e in entries:
            old, new = self.shard_of(e.fid).upsert(e)
            self._fire(old, new)
            for fn in self._entry_hooks:
                fn(e)
        self._bump()
        self._persist(entries, [])

    def commit_delta_batch(self, entries: Sequence[Entry],
                           removed: Sequence[int]) -> int:
        """Commit one folded delta batch: shard-grouped upserts and
        removals (one lock acquisition per shard group), ONE durable
        sqlite commit, ONE version bump, and ONE delta fan-out call
        carrying the whole batch (:meth:`add_delta_hook`'s ``batch``
        consumers get a single invocation; scalar hooks still see every
        pair). This is the columnar ingest plane's apply primitive — the
        scalar equivalent (`upsert_batch` + a remove loop) costs N hook
        dispatches and N+1 version bumps for the same state change.

        Removals of absent fids (same-batch CREAT→UNLNK annihilations)
        are no-ops and fire nothing, matching the scalar path. Returns
        the number of removals that actually hit.
        """
        pairs: List[Tuple[Optional[Delta], Optional[Delta]]] = []
        by_shard: Dict[int, List[Entry]] = {}
        for e in entries:
            by_shard.setdefault(self._shard_id(e.fid), []).append(e)
        for sid, group in by_shard.items():
            pairs.extend(self.shards[sid].upsert_many(group))
        rm_by_shard: Dict[int, List[int]] = {}
        for fid in removed:
            rm_by_shard.setdefault(self._shard_id(fid), []).append(fid)
        hit = 0
        removed_present: List[int] = []
        for sid, fids in rm_by_shard.items():
            for fid, old in zip(fids, self.shards[sid].remove_many(fids)):
                if old is not None:
                    pairs.append((old, None))
                    removed_present.append(fid)
                    hit += 1
        self._bump()
        self._persist(entries, removed_present)
        self._fire_batch(pairs)
        if self._entry_hooks:
            for e in entries:
                for fn in self._entry_hooks:
                    fn(e)
        return hit

    def update_fields(self, fid: int, **fields) -> bool:
        res = self.shard_of(fid).update_fields(fid, **fields)
        if res is None:
            return False
        self._bump()
        self._fire(res[0], res[1])
        if self._db is not None:
            e = self.get(fid)
            if e is not None:
                self._persist([e], [])
        return True

    def remove(self, fid: int, persist: bool = True) -> bool:
        old = self.shard_of(fid).remove(fid)
        if old is None:
            return False
        self._bump()
        self._fire(old, None)
        if persist:
            self._persist([], [fid])
        return True

    def get(self, fid: int) -> Optional[Entry]:
        return self.shard_of(fid).get(fid)

    def get_batch(self, fids: Sequence[int]) -> List[Optional[Entry]]:
        """Fetch many entries, grouped by shard so each shard lock is taken
        once per call instead of once per fid. Result aligns with ``fids``."""
        out: List[Optional[Entry]] = [None] * len(fids)
        by_shard: Dict[int, List[int]] = {}
        for pos, fid in enumerate(fids):
            by_shard.setdefault(self._shard_id(fid), []).append(pos)
        for sid, positions in by_shard.items():
            got = self.shards[sid].get_batch([fids[p] for p in positions])
            for p, e in zip(positions, got):
                out[p] = e
        return out

    def update_fields_batch(self, fids: Sequence[int], **fields) -> List[int]:
        """Patch the same fields on many entries; one lock + one durable
        commit per shard group. Fires delta hooks per entry. Returns the
        fids actually updated (present in the catalog)."""
        by_shard: Dict[int, List[int]] = {}
        for fid in fids:
            by_shard.setdefault(self._shard_id(fid), []).append(fid)
        updated: List[int] = []
        pairs: List[Tuple[Optional[Delta], Optional[Delta]]] = []
        for sid, group in by_shard.items():
            results = self.shards[sid].update_fields_batch(group, fields)
            for fid, res in zip(group, results):
                if res is not None:
                    pairs.append(res)
                    updated.append(fid)
        self._fire_batch(pairs)
        if updated:
            self._bump()
        if self._db is not None and updated:
            entries = [e for e in self.get_batch(updated) if e is not None]
            self._persist(entries, [])
        return updated

    def remove_batch(self, fids: Sequence[int]) -> int:
        """Remove many entries; one lock acquisition per shard group, one
        durable commit and one hook fan-out for the whole batch."""
        by_shard: Dict[int, List[int]] = {}
        for fid in fids:
            by_shard.setdefault(self._shard_id(fid), []).append(fid)
        removed: List[int] = []
        pairs: List[Tuple[Optional[Delta], Optional[Delta]]] = []
        for sid, group in by_shard.items():
            for fid, old in zip(group, self.shards[sid].remove_many(group)):
                if old is not None:
                    pairs.append((old, None))
                    removed.append(fid)
        self._fire_batch(pairs)
        if removed:
            self._bump()
            self._persist([], removed)
        return len(removed)

    def column_slice(self, fids: Sequence[int], names: Sequence[str]
                     ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Columnar gather for specific fids (no Entry materialization).

        Returns (cols, present) aligned with ``fids``; absent fids have
        value 0 and ``present[i] == False``.
        """
        n = len(fids)
        out = {name: np.zeros(n, dtype=dict(_NUMERIC_COLUMNS)[name])
               for name in names}
        present = np.zeros(n, dtype=bool)
        by_shard: Dict[int, List[int]] = {}
        for pos, fid in enumerate(fids):
            by_shard.setdefault(self._shard_id(fid), []).append(pos)
        for sid, positions in by_shard.items():
            cols, pres = self.shards[sid].column_slice(
                [fids[p] for p in positions], names)
            idx = np.array(positions, dtype=np.int64)
            present[idx] = pres
            for name in names:
                out[name][idx] = cols[name]
        return out, present

    def gather_rows(self, fids: Sequence[int], with_strings: bool = True
                    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Full-row columnar gather for specific fids (policy re-evaluation
        over dirty rows — no Entry materialization).

        Returns (cols, present) aligned with ``fids``: every numeric column
        plus (when ``with_strings``) ``_names``/``_paths`` string lists,
        shaped like :meth:`arrays` output restricted to the requested fids,
        so ``Expr.mask`` runs on it unchanged (glob predicates included).
        Callers whose criteria hold no glob predicate pass
        ``with_strings=False`` and skip the per-row string gather. Absent
        fids read 0 / "" with ``present[i] == False``.
        """
        n = len(fids)
        fid_arr = np.asarray(fids, dtype=np.int64)
        out: Dict[str, np.ndarray] = {
            name: np.zeros(n, dtype=dt) for name, dt in _NUMERIC_COLUMNS}
        names: List[str] = [""] * n
        paths: List[str] = [""] * n
        present = np.zeros(n, dtype=bool)
        sids = self._shard_ids(fid_arr)
        for sid in range(self.n_shards):
            idx = np.nonzero(sids == sid)[0]
            if not idx.size:
                continue
            cols, snames, spaths, pres = self.shards[sid].row_slice(
                fid_arr[idx].tolist(), with_strings=with_strings)
            present[idx] = pres
            for name, _ in _NUMERIC_COLUMNS:
                out[name][idx] = cols[name]
            if with_strings:
                for p, nm, pth in zip(idx.tolist(), snames, spaths):
                    names[p] = nm
                    paths[p] = pth
        if with_strings:
            out["_names"] = names   # type: ignore[assignment]
            out["_paths"] = paths   # type: ignore[assignment]
        return out, present

    def column_batch(self, fids: Sequence[int], with_strings: bool = False
                     ) -> ColumnBatch:
        """Entry-free row fetch: a :class:`ColumnBatch` over every numeric
        column for the given fids (one lock acquisition per shard group, no
        ``Entry.__init__``). The policy engine's columnar execution path and
        incremental re-evaluation both flow through this.

        ``with_strings=True`` additionally gathers the per-row name/path
        lists (host-side glob predicates need them); interned columns are
        always present as int32 codes and decode lazily via
        :meth:`ColumnBatch.decode`.
        """
        cols, present = self.gather_rows(fids, with_strings=with_strings)
        return ColumnBatch(cols, present, self.strings, catalog=self)

    def __len__(self) -> int:
        return sum(s.count() for s in self.shards)

    def entries(self) -> Iterator[Entry]:
        for s in self.shards:
            for fid in s.fids():
                e = s.get(fid)
                if e is not None:
                    yield e

    # -- vectorized queries ----------------------------------------------------
    def arrays(self) -> Dict[str, np.ndarray]:
        """Concatenate all shards' columns (the full 'table').

        ``_paths``/``_names`` are **lazy**: the per-row python-list gather
        is only paid when a host-side glob predicate or path report
        actually indexes them. The snapshot is still consistent — each
        shard's string lists are pointer-copied under the same lock as its
        numeric columns.

        The result is **cached per catalog version** (invalidated by
        ``_bump``): two calls with no intervening mutation return the SAME
        object, so the numpy evaluator, reports and plugins stop paying a
        full per-run shard concat on a quiet catalog. Callers must treat
        the returned columns as read-only. The version is read *before*
        the snapshot, so a racing mutation caches newer data under an
        older version — one redundant rebuild later, never a stale serve.
        """
        self.arrays_calls += 1
        with self._arrays_lock:
            cached = self._arrays_cache
        version = self._version
        if cached is not None and cached[0] == version:
            return cached[1]
        cols_and_snaps = [s.snapshot() for s in self.shards]
        out: Dict[str, np.ndarray] = {}
        for name, _ in _NUMERIC_COLUMNS:
            out[name] = np.concatenate([c[name] for c, _s in cols_and_snaps]) \
                if cols_and_snaps else np.zeros(0)
        # keep only the string snapshots alive, not the per-shard numerics
        snaps = [s for _c, s in cols_and_snaps]

        def _loader(attr: str) -> Callable[[], list]:
            def load() -> list:
                parts: list = []
                for snap in snaps:
                    parts.extend(snap.gather(attr))
                return parts
            return load

        result = LazyColumns(out, {"_paths": _loader("_paths"),
                                   "_names": _loader("_names")})
        with self._arrays_lock:
            self._arrays_cache = (version, result)
        return result

    def query_fids(self, mask_fn: Callable[[Dict[str, np.ndarray]], np.ndarray]) -> np.ndarray:
        """Vectorized query: mask_fn(columns)->bool mask; returns matching fids."""
        cols = self.arrays()
        mask = mask_fn(cols)
        return cols["fid"][mask]
