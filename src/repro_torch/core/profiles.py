"""On-device analytics subsystem: the incremental **profile cube** (C6).

The paper's second pillar is "a synthetic understanding of file systems
contents ... overall statistics about data ownership, age and size
profiles". :class:`ProfileCube` holds exactly that as one dense tensor

    ``cube[measure, group, size_bucket, age_bucket]`` (int64)

where *measure* is count / volume / spc_used, *group* is a dense code for
one (owner, group, type, hsm_state) combination (:class:`GroupIndex`),
*size_bucket* follows robinhood's file-size profile ranges and
*age_bucket* the age-profile ranges (``core.types``). Every ``rbh-report``
query — per-user, per-group, per-type, per-HSM-state, size profile, age
profile, top users — is a small masked reduction over the cube instead of
a scalar dict fold per entry per dimension.

Maintenance is **incremental and shard-partitioned**:

* each catalog shard owns a partial cube plus a per-entry
  :class:`~repro_torch.core.fidtable.FidTable` (bucket membership + age-rollover
  schedule); partial cubes are merged on query, so churn in one shard
  never touches the others' state;
* catalog delta hooks buffer signed updates per shard; queries flush the
  buffer **vectorized** (dedup per fid, one ``np.add.at`` per phase) —
  the cube never recomputes on query;
* age buckets drift with wall-clock time without any delta arriving: each
  entry schedules its next bucket-boundary instant (``atime + edge``),
  mirroring the policy engine's age-flip machinery, and queries move only
  the **due** rows to their new bucket before answering;
* full rebuilds run per shard from a columnar snapshot — host groupby
  (exact int64, the default) or the fused ``profile_cube`` CUDA kernel
  (:mod:`repro_torch.kernels.profile_cube`) which bucketizes and
  segment-reduces the whole column stack in a single launch (opt-in:
  cells rounded to f32, see :attr:`ProfileCube.use_kernel`);
* cubes persist beside the catalog's sqlite mirror
  (``<db>.profiles.npz``) for restart, and :meth:`record_trend` appends
  compact time-series snapshots for capacity trending.

The scalar :class:`~repro_torch.core.stats.StatsAggregator` fold survives as
the differential oracle; pass ``cube=`` to it to serve its reports from
here instead.

**Shared delta fan-out contract.** A ProfileCube consumes exactly ONE
delta feed, claimed via :meth:`ProfileCube.claim_delta_feed`. Three
mutually exclusive wirings exist: (a) :meth:`ProfileCube.attach` hooks
the catalog directly; (b) a cube-backed ``StatsAggregator`` forwards its
own hook; (c) :meth:`ProfileCube.attach_device_store` hands maintenance
to the device column store cube plane —
the store's single catalog hook then fans one dirty batch out to the
resident columns, the partial cubes, and the plane mirrors in the same
scatter pass, and :meth:`ProfileCube.on_delta` becomes a no-op so a fid
dirtied in a pipeline batch is applied exactly once.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from .fidtable import FidTable
from .telemetry import counter_attr
from .types import (AGE_PROFILE_EDGES, AGE_PROFILE_LABELS, FsType, HsmState,
                    SIZE_PROFILE_EDGES, SIZE_PROFILE_LABELS)

N_MEASURES = 3                        # count, volume, spc_used
S = len(SIZE_PROFILE_LABELS)          # size-profile buckets
A = len(AGE_PROFILE_LABELS)           # age-profile buckets

_SIZE_EDGES = np.asarray(SIZE_PROFILE_EDGES, dtype=np.int64)
_AGE_EDGES = np.asarray(AGE_PROFILE_EDGES, dtype=np.float64)
# next bucket-boundary age per bucket; the last bucket never flips again
_FLIP_EDGES = np.append(_AGE_EDGES[1:], np.inf)


def size_buckets_np(size: np.ndarray) -> np.ndarray:
    """Vectorized ``core.types.size_profile_bucket`` (identical results)."""
    return np.clip(np.searchsorted(_SIZE_EDGES, size, side="right") - 1,
                   0, S - 1)


def age_buckets_np(age: np.ndarray) -> np.ndarray:
    """Vectorized ``core.types.age_profile_bucket`` (identical results)."""
    return np.clip(np.searchsorted(_AGE_EDGES, age, side="right") - 1,
                   0, A - 1)


HOT_AGE_BUCKETS = 2   # leading age buckets counted as "hot" for placement


def hot_volume_fraction(ab: np.ndarray, sizes: np.ndarray) -> float:
    """Fraction of total volume sitting in the young age buckets — the
    ProfileCube side of the device store's placement signal (recently
    accessed bytes predict upcoming policy work on the group)."""
    total = float(np.asarray(sizes, np.float64).sum())
    if total <= 0.0:
        return 0.0
    hot = float(np.asarray(sizes, np.float64)[
        np.asarray(ab) < HOT_AGE_BUCKETS].sum())
    return hot / total


def _bincount_i64(flat: np.ndarray, vals: np.ndarray, k: int,
                  counts: np.ndarray) -> np.ndarray:
    """Exact int64 weighted bincount.

    ``np.bincount`` accumulates weights in float64 (exact only to 2**53
    per cell); splitting each value into 32-bit halves keeps both partial
    sums exact whenever no cell aggregates more than 2**21 rows, which
    ``counts`` (the already-computed per-cell row counts) certifies —
    beyond that the slow-but-exact ``np.add.at`` path runs instead.
    """
    if counts.size and int(counts.max()) >= (1 << 21):
        out = np.zeros(k, dtype=np.int64)
        np.add.at(out, flat, vals)
        return out
    lo = np.bincount(flat, weights=(vals & 0xffffffff).astype(np.float64),
                     minlength=k)[:k]
    hi = np.bincount(flat, weights=(vals >> 32).astype(np.float64),
                     minlength=k)[:k]
    return (hi.astype(np.int64) << 32) + lo.astype(np.int64)


class GroupIndex:
    """Dense gid <-> (owner_code, group_code, type, hsm_state) (append-only).

    Shared across shards so per-shard partial cubes merge by plain array
    addition. Thread-safe; ``columns()`` caches the key matrix as numpy
    arrays for vectorized report masks (invalidated on growth).
    """

    FIELDS = ("owner", "group", "type", "hsm")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gids: Dict[Tuple[int, int, int, int], int] = {}
        self._keys: List[Tuple[int, int, int, int]] = []
        self._cols: Optional[Dict[str, np.ndarray]] = None

    def __len__(self) -> int:
        return len(self._keys)

    def get_or_add(self, key: Tuple[int, int, int, int]) -> int:
        with self._lock:
            gid = self._gids.get(key)
            if gid is None:
                gid = len(self._keys)
                self._gids[key] = gid
                self._keys.append(key)
                self._cols = None
            return gid

    def get_or_add_many(self, owners: np.ndarray, groups: np.ndarray,
                        types: np.ndarray, hsms: np.ndarray) -> np.ndarray:
        """Vectorized gid assignment: unique combos first (few), then a
        dense LUT gather — no per-row dict lookup.

        Keys pack into one int64 with per-call bases (an int sort is ~10x
        an ``np.unique(axis=1)`` void sort); astronomically large interned
        code spaces fall back to the axis unique.
        """
        o = np.asarray(owners, np.int64)
        g = np.asarray(groups, np.int64)
        t = np.asarray(types, np.int64)
        h = np.asarray(hsms, np.int64)
        if o.size == 0:
            return np.zeros(0, dtype=np.int64)
        kg = int(g.max()) + 1
        kt = int(t.max()) + 1
        kh = int(h.max()) + 1
        if (((int(o.max()) + 1) * kg) * kt) * kh < (1 << 62):
            packed = ((o * kg + g) * kt + t) * kh + h
            _uniq, first, inv = np.unique(packed, return_index=True,
                                          return_inverse=True)
        else:
            mat = np.stack([o, g, t, h])
            _uniq, first, inv = np.unique(mat, axis=1, return_index=True,
                                          return_inverse=True)
        lut = np.array([self.get_or_add((int(o[j]), int(g[j]), int(t[j]),
                                         int(h[j]))) for j in first.tolist()],
                       dtype=np.int64)
        return lut[inv.reshape(-1)]

    def columns(self) -> Dict[str, np.ndarray]:
        """Key matrix as parallel arrays: ``{"owner"|"group"|"type"|"hsm":
        (B,) int64}`` — the mask side of every report reduction."""
        with self._lock:
            if self._cols is None:
                mat = (np.array(self._keys, dtype=np.int64).reshape(-1, 4)
                       if self._keys else np.zeros((0, 4), np.int64))
                self._cols = {f: mat[:, i].copy()
                              for i, f in enumerate(self.FIELDS)}
            return self._cols

    def export(self) -> np.ndarray:
        with self._lock:
            return (np.array(self._keys, dtype=np.int64).reshape(-1, 4)
                    if self._keys else np.zeros((0, 4), np.int64))

    def restore(self, mat: np.ndarray) -> None:
        with self._lock:
            self._keys = [tuple(row) for row in mat.astype(np.int64).tolist()]
            self._gids = {k: i for i, k in enumerate(self._keys)}
            self._cols = None


class _ShardCube:
    """One shard's partial cube + per-entry table + pending delta buffer.

    All methods expect :attr:`lock` held by the caller (``ProfileCube``
    routes every access through it). ``ref_now`` is the age reference of
    the cube's A axis: every row's stored age bucket is its bucket *as of*
    ``ref_now``; :meth:`sweep` advances it, moving only the rows whose
    scheduled boundary instant passed.
    """

    _TABLE_SPECS = (("gid", np.int64), ("sb", np.int64), ("ab", np.int64),
                    ("size", np.int64), ("blocks", np.int64),
                    ("stamp", np.float64), ("flip", np.float64))

    def __init__(self, ref_now: float) -> None:
        self.lock = threading.Lock()
        self.cube = np.zeros((N_MEASURES, 0, S, A), dtype=np.int64)
        self.table = FidTable(self._TABLE_SPECS)
        self.pending: List[Tuple[int, Optional[tuple]]] = []
        self.ref_now = float(ref_now)
        # earliest scheduled rollover instant (lower bound — removals may
        # leave it stale-low): sweeps before it skip the due scan entirely
        self.min_flip = np.inf

    # -- storage -------------------------------------------------------------
    def ensure_groups(self, b: int) -> None:
        cur = self.cube.shape[1]
        if b <= cur:
            return
        cap = max(b, cur * 2, 8)
        cube = np.zeros((N_MEASURES, cap, S, A), dtype=np.int64)
        cube[:, :cur] = self.cube
        self.cube = cube

    def apply_signed(self, sign: int, gid: np.ndarray, sb: np.ndarray,
                     ab: np.ndarray, size: np.ndarray, blocks: np.ndarray
                     ) -> None:
        """Vectorized signed bucket update: one ``np.add.at`` per measure."""
        flat = (gid * S + sb) * A + ab
        c = self.cube.reshape(N_MEASURES, -1)
        np.add.at(c[0], flat, sign)
        np.add.at(c[1], flat, sign * size)
        np.add.at(c[2], flat, sign * blocks)

    # -- incremental maintenance ----------------------------------------------
    def push(self, fid: int, new: Optional[tuple]) -> None:
        self.pending.append((fid, new))

    def flush(self, groups: GroupIndex) -> None:
        """Fold buffered deltas, deduped per fid, in two vector phases.

        Subtract uses the **stored** table row (the exact cells the cube
        holds for that fid — by construction consistent even when several
        deltas for one fid collapsed in the buffer), then the last new
        state per fid is bucketized at ``ref_now`` and added.
        """
        if not self.pending:
            return
        items, self.pending = self.pending, []
        last: Dict[int, Optional[tuple]] = {}
        for fid, new in items:
            last[fid] = new
        fids = list(last)
        present, rows = self.table.gather(fids)
        if present.any():
            self.apply_signed(-1, rows["gid"][present], rows["sb"][present],
                              rows["ab"][present], rows["size"][present],
                              rows["blocks"][present])
            # only true deletions release their rows; updates keep theirs
            # and are overwritten in place by the add phase below
            gone = [f for f, p in zip(fids, present.tolist())
                    if p and last[f] is None]
            if gone:
                self.table.remove_many(gone)
        adds = [(f, t) for f, t in last.items() if t is not None]
        if adds:
            n = len(adds)
            owners = np.fromiter((t[1] for _, t in adds), np.int64, n)
            grps = np.fromiter((t[2] for _, t in adds), np.int64, n)
            types = np.fromiter((t[3] for _, t in adds), np.int64, n)
            sizes = np.fromiter((t[4] for _, t in adds), np.int64, n)
            blocks = np.fromiter((t[5] for _, t in adds), np.int64, n)
            hsms = np.fromiter((t[6] for _, t in adds), np.int64, n)
            stamps = np.fromiter((t[7] for _, t in adds), np.float64, n)
            gids = groups.get_or_add_many(owners, grps, types, hsms)
            sb = size_buckets_np(sizes)
            ab = age_buckets_np(self.ref_now - stamps)
            flips = stamps + _FLIP_EDGES[ab]
            self.ensure_groups(int(gids.max()) + 1)
            self.apply_signed(+1, gids, sb, ab, sizes, blocks)
            self.table.upsert_many([f for f, _ in adds], gid=gids, sb=sb,
                                   ab=ab, size=sizes, blocks=blocks,
                                   stamp=stamps, flip=flips)
            if np.isfinite(flips).any():
                self.min_flip = min(self.min_flip, float(flips.min()))
        self.table.maybe_compact()

    def sweep(self, now: float, groups: GroupIndex) -> int:
        """Advance the age reference to ``now``: fold pending deltas, then
        move only the rows whose next bucket boundary passed. Returns the
        number of rolled-over rows. Before the cached ``min_flip`` instant
        nothing can be due, so the common no-rollover query skips the
        table scan entirely."""
        self.flush(groups)
        if now <= self.ref_now:
            return 0
        moved = 0
        if now >= self.min_flip:
            due = self.table.select_le("flip", now)
            if due.size:
                fids = due.tolist()
                _present, rows = self.table.gather(fids)
                new_ab = age_buckets_np(now - rows["stamp"])
                self.apply_signed(-1, rows["gid"], rows["sb"], rows["ab"],
                                  rows["size"], rows["blocks"])
                self.apply_signed(+1, rows["gid"], rows["sb"], new_ab,
                                  rows["size"], rows["blocks"])
                self.table.upsert_many(
                    fids, ab=new_ab, flip=rows["stamp"] + _FLIP_EDGES[new_ab])
                moved = int(due.size)
            # re-derive the exact bound (clears staleness from removals)
            self.min_flip = self.table.min_col("flip")
        self.ref_now = now
        return moved

    # -- bulk load (full rebuild / restore) -----------------------------------
    def load(self, fids: np.ndarray, gids: np.ndarray, sizes: np.ndarray,
             blocks: np.ndarray, stamps: np.ndarray, now: float,
             cube: Optional[np.ndarray] = None) -> None:
        """Replace this shard's state from per-row arrays; ``cube=None``
        aggregates on the host (exact int64 groupby)."""
        sb = size_buckets_np(sizes)
        ab = age_buckets_np(now - stamps)
        b = int(gids.max()) + 1 if gids.size else 0
        if cube is not None:
            # a prebuilt cube may span the full global group axis even
            # when this shard's rows use fewer gids
            b = max(b, cube.shape[1])
        self.cube = np.zeros((N_MEASURES, 0, S, A), dtype=np.int64)
        self.ensure_groups(b)
        if cube is not None:
            self.cube[:, : cube.shape[1]] = cube
        elif gids.size:
            flat = (gids * S + sb) * A + ab
            k = self.cube.shape[1] * S * A
            c = self.cube.reshape(N_MEASURES, -1)
            c[0, :] = np.bincount(flat, minlength=k)[:k]
            c[1, :] = _bincount_i64(flat, sizes, k, c[0])
            c[2, :] = _bincount_i64(flat, blocks, k, c[0])
        flips = stamps + _FLIP_EDGES[ab]
        self.table.bulk_load(fids, gid=gids, sb=sb, ab=ab, size=sizes,
                             blocks=blocks, stamp=stamps, flip=flips)
        finite = np.isfinite(flips)
        self.min_flip = float(flips[finite].min()) if finite.any() \
            else np.inf
        self.ref_now = now


class ProfileCube:
    """Incremental, shard-partitioned ownership/age/size profile cube."""

    rollovers = counter_attr(
        "cube_rollovers", "age-bucket moves served (host sweeps, or the "
        "device store's on-device count when one is attached)")

    def __init__(self, catalog, clock=time.time,
                 use_kernel: bool = False, device=None) -> None:
        self.catalog = catalog
        self.strings = catalog.strings
        self.clock = clock
        self.telemetry = catalog.telemetry
        self._tlabels = {"cube": catalog.telemetry.instance("cube")}
        # True: full rebuilds run through the profile_cube op on
        # ``device`` (the CUDA kernel on the card; its plain PyTorch
        # version when the cube runs on device="cpu", as the differential
        # tests do). Cells come back as f32 — exact only while per-cell
        # sums stay below 2**24 — so the DEFAULT is the int64 host groupby;
        # opt in for on-device builds where that precision envelope holds
        # (or approximate trends are acceptable).
        self.use_kernel = use_kernel
        # the profile_cube op runs here: "cuda" unless told otherwise,
        # raising when there is no usable card (never a silent CPU run)
        self.device = resolve_device(device)
        self.groups = GroupIndex()
        now = float(clock())
        self._shards = [_ShardCube(now) for _ in range(catalog.n_shards)]
        self.rollovers = 0            # age-bucket moves served (observability)
        # a cube consumes exactly ONE delta feed: either attach() hooks it
        # to the catalog directly, or a cube-backed StatsAggregator
        # forwards its hook — never both (updates would double-count)
        self._attached = False
        # mesh-resident serving: attach_device_store() hands maintenance
        # to the DeviceColumnStore's cube plane (same dirty-row scatter
        # path that refreshes the resident columns); cube() then answers
        # from the on-device partials and this object's per-shard host
        # cubes go quiet
        self.device_store = None
        # multi-tenant scoping: attach_grants() wires the shared
        # GrantTable; report methods then accept subject= and serve a
        # per-subject cube (store-backed via the permissions plane, or
        # the host grant-filtered fold)
        self.grants = None
        # scoped-cube burst cache: one subject typically reads several
        # reports in a row (report_user, report_types, ...) off the SAME
        # scoped cube — cache it per subject, keyed on every input that
        # can change it (time, catalog tick, grant set, group-axis width)
        self._scoped_cache: Dict[str, Tuple[tuple, np.ndarray]] = {}

    # -- wiring ---------------------------------------------------------------
    def attach(self, resume: bool = False, path: Optional[str] = None
               ) -> "ProfileCube":
        """Subscribe to catalog deltas and build the initial cube.

        The hook is registered *before* the rebuild/restore snapshots each
        shard: a delta racing the snapshot is re-folded from the buffer,
        and the table-based subtract phase makes that replay a no-op.

        ``resume=True`` tries :meth:`load` first (restart resumes the
        saved cube instead of a cold rebuild — mutations applied while the
        process was down must be replayed through the catalog, e.g. via a
        durable changelog subscriber, exactly like the engine's
        ``.incstate.npz`` contract); a missing/mismatched snapshot falls
        back to the rebuild.

        Raises when this cube already consumes a delta feed (a second
        subscription would double-count every mutation).
        """
        self.claim_delta_feed("ProfileCube.attach")
        self.catalog.add_delta_hook(self.on_delta, batch=self.on_delta_batch)
        if resume:
            try:
                if self.load(path):
                    return self
            except ValueError:
                pass                      # no state path: cold rebuild
        if len(self.catalog):
            self.rebuild()
        return self

    def attach_device_store(self, store) -> "ProfileCube":
        """Serve this cube from a :class:`~.device_store.DeviceColumnStore`.

        Claims this cube's single delta feed (shared fan-out contract:
        the store's catalog hook is the one consumer — its warm-scatter
        refresh updates resident columns, the cube partials, and the
        plane mirrors from the same dirty batch, so no mutation ever
        folds twice). After attaching, :meth:`cube` answers from the
        mesh-resident partial cubes (``store.analytics_cube``) and every
        report method rides on it — host columns are never re-read.
        """
        if store.catalog is not self.catalog:
            raise ValueError("device store is bound to a different catalog")
        self.claim_delta_feed("ProfileCube.attach_device_store")
        store.enable_cube_plane(self.groups, self.clock)
        self.device_store = store
        if self.grants is not None:
            store.enable_permissions_plane(self.grants)
        return self

    def attach_grants(self, grants) -> "ProfileCube":
        """Wire a :class:`~repro_torch.core.grants.GrantTable` so reports accept
        ``subject=``. With a device store attached this enables its
        permissions plane (scoped cubes run as one fused
        ``mesh_scoped_cube`` launch); without one the scoped queries fold
        the grant-filtered host columns."""
        self.grants = grants
        if self.device_store is not None:
            self.device_store.enable_permissions_plane(grants)
        return self

    def claim_delta_feed(self, who: str) -> None:
        """Mark this cube's single delta feed as taken (attach() or a
        cube-backed StatsAggregator); a second claim raises."""
        if self._attached:
            raise ValueError(
                f"{who}: this ProfileCube already consumes a delta feed — "
                "wire either attach() or one cube-backed StatsAggregator, "
                "never both (every mutation would fold twice)")
        self._attached = True

    def on_delta(self, old: Optional[tuple], new: Optional[tuple]) -> None:
        """Catalog delta hook: buffer a signed update on the owning shard."""
        if self.device_store is not None:
            return            # store's refresh path maintains the cube plane
        src = new if new is not None else old
        if src is None:
            return
        fid = src[0]
        shard = self._shards[self.catalog._shard_id(fid)]
        with shard.lock:
            shard.push(fid, new)

    def on_delta_batch(self, pairs) -> None:
        """Single fan-out arm: buffer one committed delta batch with one
        lock acquisition per *touched* shard instead of one per mutation
        (``Catalog.add_delta_hook(..., batch=...)`` routes batched
        commits here; scalar mutations still arrive via
        :meth:`on_delta`)."""
        if self.device_store is not None:
            return
        shard_id = self.catalog._shard_id
        by_shard: Dict[int, list] = {}
        for old, new in pairs:
            src = new if new is not None else old
            if src is None:
                continue
            by_shard.setdefault(shard_id(src[0]), []).append((src[0], new))
        for sid, items in by_shard.items():
            shard = self._shards[sid]
            with shard.lock:
                push = shard.push
                for fid, new in items:
                    push(fid, new)

    # -- full rebuild ----------------------------------------------------------
    def rebuild(self, now: Optional[float] = None,
                use_kernel: Optional[bool] = None) -> None:
        """Per-shard full recompute from columnar shard snapshots.

        Each shard aggregates independently (numeric columns only — no
        path/name gather): host ``np.bincount`` groupby (exact int64, the
        default), or the fused CUDA kernel when opted in (f32 cells —
        see :attr:`use_kernel` for the precision envelope). Buffered
        deltas are kept; the next flush reconciles anything that raced
        the snapshot.
        """
        if self.device_store is not None:
            # store-backed cube: a "rebuild" is just an invalidation — the
            # next query re-launches mesh_profile_cube over the resident
            # blocks (host columns are never re-read)
            self.device_store.invalidate_cube()
            return
        now = float(self.clock()) if now is None else float(now)
        use_kernel = self.use_kernel if use_kernel is None else use_kernel
        kernel_fn = None
        max_groups = 0
        if use_kernel:
            from ..kernels.profile_cube.ops import MAX_GROUPS, profile_cube
            kernel_fn = profile_cube
            max_groups = MAX_GROUPS
        needed = ("fid", "owner", "group", "type", "hsm_state", "size",
                  "blocks", "atime")
        for sid, shard in enumerate(self._shards):
            with shard.lock:
                cols, _snap = self.catalog.shards[sid].snapshot(
                    names=needed, with_strings=False)
                gids = self.groups.get_or_add_many(
                    cols["owner"], cols["group"], cols["type"],
                    cols["hsm_state"])
                cube = None
                if kernel_fn is not None and gids.size \
                        and len(self.groups) <= max_groups:
                    # bucket indices computed host-side (exact — matching
                    # the int64 entry tables); the kernel does the fused
                    # segment reduction
                    age = now - cols["atime"]
                    cube_f = kernel_fn(
                        gids, cols["size"], cols["blocks"], age,
                        sb=size_buckets_np(cols["size"]),
                        ab=age_buckets_np(age), n_groups=len(self.groups),
                        device=self.device)
                    cube = np.rint(cube_f).astype(np.int64)
                shard.load(np.asarray(cols["fid"], np.int64), gids,
                           np.asarray(cols["size"], np.int64),
                           np.asarray(cols["blocks"], np.int64),
                           np.asarray(cols["atime"], np.float64), now,
                           cube=cube)

    # -- query ----------------------------------------------------------------
    def _scoped_cube_host(self, now: float, subject: str) -> np.ndarray:
        """Grant-filtered host fold: the scalar oracle for ``subject=``
        scoping — bins only the rows the subject may see into the shared
        group axis (exact int64, same bucket tables as the shard cubes).
        Serves host-only scoped queries and the store's PolicyError
        fallback; the differential suite pins the device path to it."""
        if self.grants is None:
            raise RuntimeError(
                "subject= scoping needs attach_grants(GrantTable)")
        cols = self.catalog.arrays()
        vis = self.grants.visible_mask(subject, cols, self.strings)
        idx = np.nonzero(vis)[0]
        gids = self.groups.get_or_add_many(
            cols["owner"][idx], cols["group"][idx], cols["type"][idx],
            cols["hsm_state"][idx])
        b = len(self.groups)
        out = np.zeros((N_MEASURES, b, S, A), dtype=np.int64)
        if not idx.size:
            return out
        sizes = np.asarray(cols["size"], np.int64)[idx]
        blocks = np.asarray(cols["blocks"], np.int64)[idx]
        sb = size_buckets_np(sizes)
        ab = age_buckets_np(now - np.asarray(cols["atime"],
                                             np.float64)[idx])
        flat = (gids * S + sb) * A + ab
        k = b * S * A
        c = out.reshape(N_MEASURES, -1)
        c[0, :] = np.bincount(flat, minlength=k)[:k]
        c[1, :] = _bincount_i64(flat, sizes, k, c[0])
        c[2, :] = _bincount_i64(flat, blocks, k, c[0])
        return out

    def cube(self, now: Optional[float] = None,
             subject: Optional[str] = None) -> np.ndarray:
        """Merged (N_MEASURES, B, S, A) int64 cube as of ``now``.

        Flushes each shard's pending deltas and processes due age-bucket
        rollovers first; merging is plain per-shard array addition. With
        a device store attached the merge is served entirely from the
        mesh-resident partial cubes instead. ``subject=`` returns the
        per-subject scoped cube (store permissions plane when available,
        the grant-filtered host fold otherwise)."""
        now = float(self.clock()) if now is None else float(now)
        if subject is not None:
            gver = self.grants.version if self.grants is not None else -1
            key = (now, self.catalog.version, gver, len(self.groups))
            hit = self._scoped_cache.get(subject)
            if hit is not None and hit[0] == key:
                return hit[1].copy()          # burst: one compute, N reports
            cube = None
            if self.device_store is not None:
                from .policy import PolicyError
                try:
                    cube = self.device_store.analytics_cube(
                        now, subject=subject)
                    self.rollovers = self.device_store.rollovers
                except PolicyError:
                    pass              # plane not enabled: host fold below
            if cube is None:
                cube = self._scoped_cube_host(now, subject)
            # the fold itself may have grown the group axis; catalog/grant
            # versions stay the PRE-compute ones, so a mutation racing the
            # fold forces a miss (never a stale hit) on the next call
            key = (now, key[1], gver, len(self.groups))
            self._scoped_cache[subject] = (key, cube.copy())
            return cube
        if self.device_store is not None:
            cube = self.device_store.analytics_cube(now)
            self.rollovers = self.device_store.rollovers
            return cube
        for shard in self._shards:            # sweeps may grow the index
            with shard.lock:
                self.rollovers += shard.sweep(now, self.groups)
        b = len(self.groups)
        out = np.zeros((N_MEASURES, b, S, A), dtype=np.int64)
        for shard in self._shards:
            with shard.lock:
                sb = min(shard.cube.shape[1], b)
                out[:, :sb] += shard.cube[:, :sb]
        return out

    # -- rbh-report queries (dict-identical to the scalar StatsAggregator) ----
    def _cube_and_cols(self, now: Optional[float],
                       subject: Optional[str] = None
                       ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Merged cube + group key columns, sliced to one consistent group
        axis: a concurrent flush may grow the index between the two reads,
        and a group born after this cube merged has no cells in it."""
        cube = self.cube(now, subject=subject)
        b = cube.shape[1]
        cols = {k: v[:b] for k, v in self.groups.columns().items()}
        return cube, cols

    def _acc_dict(self, cube: np.ndarray, mask: np.ndarray) -> dict:
        cnt = int(cube[0][mask].sum())
        vol = int(cube[1][mask].sum())
        spc = int(cube[2][mask].sum())
        return {"count": cnt, "volume": vol, "spc_used": spc,
                "avg_size": vol / cnt if cnt else 0.0}

    def _report_by(self, field: str, code: int, label_key: str,
                   label: str, now: Optional[float],
                   subject: Optional[str] = None) -> List[dict]:
        cube, cols = self._cube_and_cols(now, subject)
        out = []
        for t in sorted(FsType, key=int):
            mask = (cols[field] == code) & (cols["type"] == int(t))
            if not mask.any():
                continue
            d = self._acc_dict(cube, mask)
            if not d["count"]:
                continue
            d[label_key] = label
            d["type"] = t.name.lower()
            out.append(d)
        return out

    def report_user(self, user: str, now: Optional[float] = None,
                    subject: Optional[str] = None) -> List[dict]:
        """`rbh-report -u user`: per-type count/volume/avg from the cube.
        ``subject=`` restricts every measure to that subject's grants."""
        code = self.strings.code_of(user)
        if code is None:
            return []
        return self._report_by("owner", code, "user", user, now, subject)

    def report_group(self, grp: str, now: Optional[float] = None,
                     subject: Optional[str] = None) -> List[dict]:
        code = self.strings.code_of(grp)
        if code is None:
            return []
        return self._report_by("group", code, "group", grp, now, subject)

    def report_types(self, now: Optional[float] = None,
                     subject: Optional[str] = None) -> Dict[str, dict]:
        cube, cols = self._cube_and_cols(now, subject)
        out = {}
        for t in sorted(FsType, key=int):
            mask = cols["type"] == int(t)
            if mask.any():
                d = self._acc_dict(cube, mask)
                if d["count"]:
                    out[t.name.lower()] = d
        return out

    def report_hsm(self, now: Optional[float] = None,
                   subject: Optional[str] = None) -> Dict[str, dict]:
        cube, cols = self._cube_and_cols(now, subject)
        out = {}
        for h in sorted(HsmState, key=int):
            mask = cols["hsm"] == int(h)
            if mask.any():
                d = self._acc_dict(cube, mask)
                if d["count"]:
                    out[h.name.lower()] = d
        return out

    def user_size_profile(self, user: str, now: Optional[float] = None,
                          subject: Optional[str] = None) -> Dict[str, int]:
        out = {lbl: 0 for lbl in SIZE_PROFILE_LABELS}
        code = self.strings.code_of(user)
        if code is None:
            return out
        cube, cols = self._cube_and_cols(now, subject)
        mask = (cols["owner"] == code) & (cols["type"] == int(FsType.FILE))
        if mask.any():
            per_s = cube[0][mask].sum(axis=(0, 2))         # (S,)
            for i, lbl in enumerate(SIZE_PROFILE_LABELS):
                out[lbl] += int(per_s[i])
        return out

    def age_profile(self, user: Optional[str] = None,
                    now: Optional[float] = None,
                    subject: Optional[str] = None) -> Dict[str, dict]:
        """The paper's data-age profile: per age bucket count/volume/spc
        (optionally restricted to one user) — new over the scalar path."""
        cube, cols = self._cube_and_cols(now, subject)
        mask = np.ones(cube.shape[1], dtype=bool)
        if user is not None:
            code = self.strings.code_of(user)
            mask &= (cols["owner"] == code) if code is not None else False
        sub = cube[:, mask].sum(axis=(1, 2))               # (3, A)
        return {lbl: {"count": int(sub[0, i]), "volume": int(sub[1, i]),
                      "spc_used": int(sub[2, i])}
                for i, lbl in enumerate(AGE_PROFILE_LABELS)}

    def top_users(self, by: str = "volume", k: int = 10,
                  type_: FsType = FsType.FILE,
                  now: Optional[float] = None,
                  subject: Optional[str] = None) -> List[dict]:
        cube, cols = self._cube_and_cols(now, subject)
        tmask = cols["type"] == int(type_)
        rows = []
        for code in np.unique(cols["owner"][tmask]).tolist():
            d = self._acc_dict(cube, tmask & (cols["owner"] == code))
            if not d["count"]:
                continue
            d["user"] = self.strings.lookup(code)
            rows.append(d)
        rows.sort(key=lambda d: d.get(by, 0), reverse=True)
        return rows[:k]

    def totals(self) -> Tuple[int, int, int]:
        """(count, volume, spc_used) over the whole cube."""
        cube = self.cube()
        return (int(cube[0].sum()), int(cube[1].sum()), int(cube[2].sum()))

    # -- persistence + trend snapshots ----------------------------------------
    def _state_path(self, path: Optional[str], suffix: str) -> str:
        if path is not None:
            return path
        if self.catalog.db_path:
            return self.catalog.db_path + suffix
        raise ValueError("no profile-state path: pass one explicitly or "
                         "attach a sqlite mirror to the catalog")

    def save(self, path: Optional[str] = None) -> str:
        """Serialize the cube state beside the sqlite mirror (atomic).

        Default path ``<catalog.db_path>.profiles.npz`` — the analytics
        sibling of the engine's ``.incstate.npz``. Pending deltas are
        flushed first so the snapshot is self-consistent.
        """
        path = self._state_path(path, ".profiles.npz")
        for shard in self._shards:            # flushes may grow the index
            with shard.lock:
                shard.flush(self.groups)
        payload: Dict[str, np.ndarray] = {
            "groups": self.groups.export(),
            "n_shards": np.array([len(self._shards)], np.int64),
        }
        for sid, shard in enumerate(self._shards):
            with shard.lock:
                fids, cols = shard.table.live()
                payload[f"s{sid}::cube"] = shard.cube
                payload[f"s{sid}::ref_now"] = np.array([shard.ref_now])
                payload[f"s{sid}::fids"] = fids
                for name, arr in cols.items():
                    payload[f"s{sid}::{name}"] = arr
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
        return path

    def load(self, path: Optional[str] = None) -> bool:
        """Restore a saved cube (restart resumes incrementally instead of a
        cold rebuild). Returns False on missing file / shard-count mismatch
        (caller then falls back to :meth:`rebuild`)."""
        path = self._state_path(path, ".profiles.npz")
        if not os.path.exists(path):
            return False
        with np.load(path, allow_pickle=False) as z:
            if int(z["n_shards"][0]) != len(self._shards):
                return False
            self.groups.restore(z["groups"])
            for sid, shard in enumerate(self._shards):
                with shard.lock:
                    fids = z[f"s{sid}::fids"].astype(np.int64)
                    gids = z[f"s{sid}::gid"].astype(np.int64)
                    shard.load(fids, gids, z[f"s{sid}::size"],
                               z[f"s{sid}::blocks"], z[f"s{sid}::stamp"],
                               float(z[f"s{sid}::ref_now"][0]),
                               cube=z[f"s{sid}::cube"])
        return True

    def record_trend(self, path: Optional[str] = None,
                     now: Optional[float] = None) -> str:
        """Append a compact time-series snapshot (totals + per-age volume +
        per-size counts + per-type counts) — capacity trending across
        restarts without retaining full cubes."""
        path = self._state_path(path, ".profiles.trend.npz")
        now = float(self.clock()) if now is None else float(now)
        cube, cols = self._cube_and_cols(now)
        type_counts = np.array([int(cube[0][cols["type"] == int(t)].sum())
                                for t in sorted(FsType, key=int)], np.int64)
        row = {
            "time": np.array([now]),
            "count": np.array([int(cube[0].sum())], np.int64),
            "volume": np.array([int(cube[1].sum())], np.int64),
            "spc_used": np.array([int(cube[2].sum())], np.int64),
            "age_volume": cube[1].sum(axis=(0, 1))[None, :],      # (1, A)
            "size_count": cube[0].sum(axis=(0, 2))[None, :],      # (1, S)
            "type_count": type_counts[None, :],
        }
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                row = {k: np.concatenate([z[k], v]) for k, v in row.items()}
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **row)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load_trend(path: str) -> Dict[str, np.ndarray]:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k].copy() for k in z.files}
