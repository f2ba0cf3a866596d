"""Device-resident sharded column store for policy matching on one card.

The paper's core scaling claim (SII-B1, SIII-B) is that policy runs over
billions of entries must never re-read the namespace. The engine's kernel
path violates that in two ways every run: ``Catalog.arrays()``
concatenates every shard's columns on the host, and ``match_programs``
re-stacks and re-uploads the full f32 column stack host→device. This
module keeps the kernel's column stacks *resident* on the device and
maintains them by deltas, so a warm policy run uploads only the rows that
actually churned.

Residency model
---------------
Catalog shards are folded onto ``groups`` **shard groups**: shard ``s``
belongs to group ``s % groups``, and each group's rows (the concatenation
of its member shards' valid-row snapshots) live as an ``(n_cols+1, Rp)``
float32 block — ``KERNEL_COLUMNS`` in kernel order plus a trailing 0/1
row-validity column. Every group is padded to the same ``Rp`` (a multiple
of ``tile``, allocated with growth headroom), and the blocks are the
slices of ONE ``(D, n_cols+1, Rp)`` tensor on the store's device (D =
``groups``) — the operand
:func:`~repro_torch.kernels.policy_scan.ops.mesh_policy_scan_batch`
consumes, one kernel launch over every group on the card. Matching
therefore moves **no column data at all**: only the (R, P) programs go
up, and only the program-0 mask, the first-match-wins rule attribution,
and the (R, N_AGG) aggregates summed over the groups come back.

Beside each block the store keeps a **host mirror** of the group: the
row-aligned ``fid`` array plus every kernel column in its native dtype.
The mirror is what translates matched local row indices back to fids and
serves exact int64/float64 ``size``/sort-key values to the engine's
planner — it is maintained by the same deltas as the device block, so no
post-match catalog gather is needed.

Version keying and refresh
--------------------------
Freshness is keyed by the existing per-shard change ticks
(:attr:`CatalogShard.version`): a group is *stale* when any member shard's
tick moved past the value recorded at its last upload, or when delta hooks
flagged pending changes. The store registers a
:meth:`Catalog.add_delta_hook` at attach time and classifies every delta:

* in-place update (old and new both present)  -> the fid joins the group's
  **dirty set**; refresh scatters just those rows — one
  :meth:`Catalog.gather_rows` host gather, the ``(n_cols+1, k)`` values
  sent up in one copy, and one ``index_copy_`` into the group's slice on
  the device (row positions are stable under pure updates, so the scatter
  is exact);
* insert or remove (``old is None`` / ``new is None``) -> the group is
  flagged **structural** and falls back to a full re-upload (snapshot →
  restack → one host→device copy into its slice), because row positions
  shift;
* dirty set larger than ``refresh_frac`` of the group's rows -> full
  re-upload too (documented churn threshold: past it one contiguous upload
  beats that many scattered rows);
* shard tick moved with *no* recorded deltas (store attached late, hooks
  bypassed) -> full re-upload, never a stale serve.

Version ticks are read *before* the snapshot/gather (the catalog's own
``_bump`` discipline), so a racing mutation can only make the next refresh
redundant, never leave the device block stale. A group whose row count
outgrows ``Rp`` re-pads the capacity, but only the grown group re-uploads:
the wider tensor is allocated and every other clean group is copied into
it device to device (``device_pads`` counts these). During that re-pad
the old tensor and the new one are both held: peak device memory is their
sum.

Not ported yet
--------------
The reference store also carries the reports and cube planes (ROADMAP.md
queue 1 item 5), the permissions plane and ``subject=`` scoping (item 6)
and tiered residency under ``hbm_budget_rows`` (item 7). Their entry
points here raise ``NotImplementedError`` naming the item;
:meth:`DeviceColumnStore.tiering_counters` reports every group resident.

Shared delta fan-out contract
-----------------------------
One catalog mutation fans out to every derived structure through
*independent* :meth:`Catalog.add_delta_hook` subscriptions, and each
consumer must apply it **exactly once**: this store's hook feeds the
per-group dirty sets, and a refresh drains a dirty *set* (duplicate
updates to one fid collapse) in one scatter. The policy engine's
incremental state consumes the same deltas via ``note_touched``; a full
scan over the store primes that cache through
:meth:`MeshMatch.cache_arrays` (mirror-served, no catalog re-read).

f32 envelope
------------
Device blocks are float32, exactly like the single-launch kernel path:
sizes above 2**24 bytes land on the nearest representable f32 (~one part
in 16M — entries within one ulp of a size cutoff may flip vs the int64
numpy path) and epoch-second timestamps carry ~64 s resolution. The host
mirror keeps native dtypes, so fids, budget sizes and sort keys returned
to the planner are exact; only predicate evaluation lives in the f32
envelope. Differential tests pin the envelope with f32-exact catalogs.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .catalog import Catalog, Delta
from .policy import KERNEL_COLUMNS, PolicyError, compile_programs
from .telemetry import counter_attr

_VALID_COL = len(KERNEL_COLUMNS)          # trailing 0/1 row-validity column

# columns the host mirror serves to the planner (fids + kernel columns);
# a policy sorting by anything else (e.g. parent_fid) cannot plan from the
# store and raises PolicyError -> the engine falls back to a host scan
PLAN_COLUMNS = ("fid",) + KERNEL_COLUMNS

_TILE = 1024                              # default padding step (a kernel tile)


class _RepadNeeded(Exception):
    """Internal: a group's snapshot outgrew the padded row capacity
    mid-refresh (concurrent inserts); refresh() re-pads and retries."""

    def __init__(self, rows: int) -> None:
        super().__init__(rows)
        self.rows = rows


def _not_ported(what: str, item: int, plane: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item {item}, "
        f"{plane}")


class MeshMatch:
    """Result of one program-batch evaluation over the store.

    Holds the per-group matched local row indices (already nonzero'd on the
    host from the program-0 mask) plus the store's host mirrors; ``plan``
    gathers the planner arrays without touching the catalog. A delta
    refresh mutates the mirrors in place, so ``plan`` takes the store lock
    and raises :class:`PolicyError` when the store refreshed since this
    match (a stale plan would mix pre-churn masks with post-churn values)
    — call it before the next refresh, as the engine does.
    """

    def __init__(self, store: "DeviceColumnStore", epoch: int,
                 mirrors: List[Tuple[np.ndarray, Dict[str, np.ndarray]]],
                 group_idx: List[np.ndarray], group_rule: List[np.ndarray],
                 agg: dict, reval: int) -> None:
        self._store = store
        self._epoch = epoch                # store mutation tick at match
        self._mirrors = mirrors            # per group: (fids, cols) refs
        self._group_idx = group_idx        # per group: matched local rows
        self._group_rule = group_rule      # per group: rule idx at those rows
        self.agg = agg
        self.reval = reval                 # valid rows evaluated on-device

    @property
    def matched(self) -> int:
        return int(sum(ix.size for ix in self._group_idx))

    def plan(self, sort_by: str) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
        """(fids, sizes, sort_keys, rule_idx) of matched rows, native
        dtypes from the host mirror (exact budgets/ordering)."""
        if sort_by not in PLAN_COLUMNS:
            raise PolicyError(
                f"sort_by {sort_by!r} is not in the device-store host "
                f"mirror (available: fid + kernel columns)")
        with self._store._lock:
            if self._store._epoch != self._epoch:
                raise PolicyError(
                    "stale MeshMatch: the device store refreshed since "
                    "this match — re-match before planning")
            return self._plan_locked(sort_by)

    def _plan_locked(self, sort_by: str) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray]:
        fids, sizes, keys, rules = [], [], [], []
        for (gfids, gcols), idx, rl in zip(self._mirrors, self._group_idx,
                                           self._group_rule):
            fids.append(gfids[idx])
            sizes.append(gcols["size"][idx])
            keys.append(np.asarray(gcols[sort_by][idx], dtype=np.float64))
            rules.append(rl)
        return (np.concatenate(fids) if fids else np.zeros(0, np.int64),
                np.concatenate(sizes) if sizes else np.zeros(0, np.int64),
                np.concatenate(keys) if keys else np.zeros(0),
                np.concatenate(rules) if rules else np.zeros(0, np.int32))

    def cache_arrays(self, sort_by: str, age_preds, now: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray, np.ndarray]:
        """Plan arrays + the age-flip schedule that primes the engine's
        incremental match cache from this full scan.

        Returns ``(fids, sizes, sort_keys, rule_idx, flip_fids, flips)``:
        the first four are :meth:`plan`'s exact output; the last two cover
        **every** mirrored row whose age predicates flip at a finite
        future instant (``time_col + threshold``, boundary kept — the
        same semantics as ``policy_engine._next_flips`` over a host
        snapshot), so a currently-unmatched row that ages into scope is
        still re-evaluated on time. Everything is served from the host
        mirrors — the catalog columns are never touched.
        """
        if sort_by not in PLAN_COLUMNS:
            raise PolicyError(
                f"sort_by {sort_by!r} is not in the device-store host "
                f"mirror (available: fid + kernel columns)")
        with self._store._lock:
            if self._store._epoch != self._epoch:
                raise PolicyError(
                    "stale MeshMatch: the device store refreshed since "
                    "this match — re-match before planning")
            fids, sizes, keys, rules = self._plan_locked(sort_by)
            ffids, flips = [], []
            for gfids, gcols in self._mirrors:
                if not gfids.size or not age_preds:
                    continue
                nxt = np.full(gfids.size, np.inf)
                for time_col, thr in age_preds:
                    cand = np.asarray(gcols[time_col],
                                      dtype=np.float64) + thr
                    np.minimum(nxt, np.where(cand >= now, cand, np.inf),
                               out=nxt)
                keep = np.isfinite(nxt)
                ffids.append(gfids[keep])
                flips.append(nxt[keep])
            return (fids, sizes, keys, rules,
                    np.concatenate(ffids) if ffids
                    else np.zeros(0, np.int64),
                    np.concatenate(flips) if flips else np.zeros(0))


class _ShardGroup:
    """One shard group's slice of the catalog: host mirror + freshness."""

    __slots__ = ("gid", "shard_ids", "fids", "cols", "rows", "versions",
                 "dirty", "structural", "uploaded", "_order")

    def __init__(self, gid: int, shard_ids: List[int]) -> None:
        self.gid = gid
        self.shard_ids = shard_ids
        self.fids = np.zeros(0, np.int64)
        self.cols: Dict[str, np.ndarray] = {}
        self.rows = 0                      # valid rows (<= Rp)
        self.versions: Dict[int, int] = {}  # shard id -> tick at last upload
        self.dirty: set = set()
        self.structural = False
        self.uploaded = False
        self._order: Optional[np.ndarray] = None   # argsort(fids), lazy

    def locate(self, fids: np.ndarray) -> Optional[np.ndarray]:
        """Local row index per fid; None when any fid is not in the mirror
        (caller falls back to a full re-upload)."""
        if not self.rows:
            return None
        if self._order is None:
            self._order = np.argsort(self.fids, kind="stable")
        sorted_fids = self.fids[self._order]
        pos = np.searchsorted(sorted_fids, fids)
        pos = np.clip(pos, 0, sorted_fids.size - 1)
        rows = self._order[pos]
        if not (self.fids[rows] == fids).all():
            return None
        return rows


class DeviceColumnStore:
    """Per-shard-group kernel column stacks held resident on one device.

    See the module docstring for the residency / refresh / envelope
    contracts. Construction registers a delta hook on the catalog and
    uploads lazily: the first :meth:`refresh` (or :meth:`match`) pays the
    cold full upload, warm calls scatter only churned rows. The tensor
    lies on ``device`` (the CUDA card unless ``"cpu"`` is asked for, where
    the plain PyTorch matcher runs). On the card ``tile`` must be a
    multiple of 4 (the kernel's store form takes groups of 4k rows).
    """

    # refresh-mode counters (benchmarks / tests assert the mode taken) —
    # registry-backed, read/written through the old int attribute API
    full_uploads = counter_attr(
        "store_full_uploads", "cold whole-block uploads")
    delta_refreshes = counter_attr(
        "store_delta_refreshes", "warm dirty-row scatter refreshes")
    rows_scattered = counter_attr(
        "store_rows_scattered", "rows moved by dirty scatters")
    device_pads = counter_attr(
        "store_device_pads", "on-device re-pads (no re-upload)")

    def __init__(self, catalog: Catalog, groups: int = 1, device=None,
                 refresh_frac: float = 0.25, tile: int = 0,
                 headroom: float = 1.25,
                 hbm_budget_rows: Optional[int] = None,
                 window_rows: int = 0,
                 demote_async: bool = False) -> None:
        if hbm_budget_rows is not None or window_rows or demote_async:
            raise _not_ported("tiered residency (hbm_budget_rows, "
                              "window_rows, demote_async)", 7,
                              "tiered residency")
        if int(groups) < 1:
            raise PolicyError(f"device store needs groups >= 1, got "
                              f"{groups}")
        self.device = resolve_device(device)
        self.catalog = catalog
        self.n_groups = int(groups)
        self.refresh_frac = refresh_frac
        self.tile = tile or _TILE
        if self.device.type == "cuda" and self.tile % 4:
            raise ValueError(f"tile={self.tile}: on the card the store "
                             "pads groups to a multiple of 4 rows")
        self.headroom = headroom
        self._lock = threading.RLock()
        self._groups = [
            _ShardGroup(g, [s for s in range(catalog.n_shards)
                            if s % self.n_groups == g])
            for g in range(self.n_groups)]
        self._rp = 0                        # padded rows per group block
        self._buf: Optional[torch.Tensor] = None   # (D, C+1, Rp) f32
        self._epoch = 0                     # bumped by every mirror mutation
        # refresh counters: registry-backed series on the catalog's
        # telemetry plane (instance label keeps several stores sharing one
        # catalog distinct); the zeroing writes below create the series so
        # they export as 0 before first use
        self.telemetry = catalog.telemetry
        self._tlabels = {"store": catalog.telemetry.instance("store")}
        self.full_uploads = 0
        self.delta_refreshes = 0
        self.rows_scattered = 0
        self.device_pads = 0                # device-to-device re-pads
        catalog.add_delta_hook(self._on_delta, batch=self._on_delta_batch)

    # -- planes not ported yet -------------------------------------------------
    def enable_reports_plane(self) -> None:
        raise _not_ported("the reports plane", 5, "the store's reports and "
                          "cube planes")

    def enable_cube_plane(self, groups, clock) -> None:
        raise _not_ported("the cube plane", 5, "the store's reports and "
                          "cube planes")

    def enable_permissions_plane(self, grants) -> None:
        raise _not_ported("the permissions plane", 6, "the permissions "
                          "plane")

    def find_paths(self, expr, now: float, limit: int = 0,
                   subject: Optional[str] = None):
        raise _not_ported("find_paths", 5, "the store's reports and cube "
                          "planes")

    def top_files(self, by: str = "size", k: int = 10, desc: bool = True,
                  subject: Optional[str] = None):
        raise _not_ported("top_files", 5, "the store's reports and cube "
                          "planes")

    def du(self, path_prefix: str, subject: Optional[str] = None) -> dict:
        raise _not_ported("du", 5, "the store's reports and cube planes")

    def analytics_cube(self, now: Optional[float] = None,
                       subject: Optional[str] = None):
        raise _not_ported("analytics_cube", 5, "the store's reports and "
                          "cube planes")

    def invalidate_cube(self) -> None:
        raise _not_ported("invalidate_cube", 5, "the store's reports and "
                          "cube planes")

    @property
    def rollovers(self) -> int:
        raise _not_ported("rollovers", 5, "the store's reports and cube "
                          "planes")

    def drain_demotions(self, timeout: Optional[float] = None) -> None:
        raise _not_ported("drain_demotions", 7, "tiered residency")

    def tiering_counters(self) -> Dict[str, int]:
        """The reference's tiering counters with every group resident, so
        ``RunReport.tiering`` reads alike. Nothing demotes, promotes or
        streams until tiered residency is ported, so those keys read 0."""
        with self._lock:
            return {
                **dict.fromkeys(("demotions", "promotions",
                                 "segments_streamed", "windows_streamed",
                                 "window_stalls", "segment_repacks",
                                 "demote_races"), 0),
                "device_pads": self.device_pads,
                "resident_groups": self.n_groups,
                "demoted_groups": 0,
            }

    def _drop_device_state(self) -> None:
        """Invalidate every resident block: the next refresh re-uploads.
        Lock held."""
        self._buf = None
        self._epoch += 1
        for group in self._groups:
            group.uploaded = False

    def detach(self) -> None:
        """Unregister from the catalog's delta hooks and drop the device
        tensor. A store that is replaced (re-attach) must be detached, or
        the long-lived catalog keeps feeding its dirty sets forever. A
        detached store can still match, but without delta intake every
        refresh is a cold full upload (the hook-less version-drift
        fallback) — detach is for decommissioning."""
        self.catalog.remove_delta_hook(self._on_delta)
        with self._lock:
            self._drop_device_state()
            for group in self._groups:
                group.dirty = set()
                group.structural = False
                group.fids = np.zeros(0, np.int64)
                group.cols = {}
                group.rows = 0
            self._rp = 0

    # -- delta intake (catalog mutation hooks) --------------------------------
    def _on_delta(self, old: Optional[Delta], new: Optional[Delta]) -> None:
        ref = new if new is not None else old
        if ref is None:
            return
        fid = int(ref[0])
        group = self._groups[self.catalog._shard_id(fid) % self.n_groups]
        if old is None or new is None:      # insert / remove: rows shift
            group.structural = True
        else:
            group.dirty.add(fid)

    def _on_delta_batch(self, pairs) -> None:
        """Single fan-out arm: classify one committed delta batch in one
        call — same per-pair semantics as :meth:`_on_delta`, with the
        group/shard routing hoisted out of the loop."""
        groups = self._groups
        shard_id = self.catalog._shard_id
        n_groups = self.n_groups
        for old, new in pairs:
            ref = new if new is not None else old
            if ref is None:
                continue
            group = groups[shard_id(int(ref[0])) % n_groups]
            if old is None or new is None:
                group.structural = True
            else:
                group.dirty.add(int(ref[0]))

    # -- freshness ------------------------------------------------------------
    def _shard_versions(self, group: _ShardGroup) -> Dict[int, int]:
        return {s: self.catalog.shards[s].version for s in group.shard_ids}

    def _stale(self, group: _ShardGroup) -> bool:
        if not group.uploaded or group.structural or group.dirty:
            return True
        return self._shard_versions(group) != group.versions

    # -- upload paths ----------------------------------------------------------
    def _snapshot_group(self, group: _ShardGroup
                        ) -> Tuple[Dict[int, int], np.ndarray,
                                   Dict[str, np.ndarray]]:
        """(versions-before, fids, native column dict) for a full upload:
        the group's rows are the concat of its member-shard snapshots."""
        versions = self._shard_versions(group)   # BEFORE the snapshot reads
        names = ("fid",) + KERNEL_COLUMNS
        parts = []
        for s in group.shard_ids:
            cols_s, _snap = self.catalog.shards[s].snapshot(
                names=names, with_strings=False)
            parts.append(cols_s)
        if parts:
            cols = {n: np.concatenate([p[n] for p in parts]) for n in names}
        else:
            cols = {n: np.zeros(0, dtype=np.int64) for n in names}
        # fid stays IN the mirror dict (it is a valid plan sort key)
        cols["fid"] = fids = cols["fid"].astype(np.int64, copy=False)
        return versions, fids, cols

    def _stack_f32(self, group: _ShardGroup, rp: int) -> np.ndarray:
        """(n_cols+1, rp) f32 block staging from the host mirror."""
        out = np.zeros((len(KERNEL_COLUMNS) + 1, rp), dtype=np.float32)
        for i, name in enumerate(KERNEL_COLUMNS):
            out[i, : group.rows] = group.cols[name]
        out[_VALID_COL, : group.rows] = 1.0
        return out

    def _host_refresh(self, group: _ShardGroup) -> None:
        """Bring a group's host mirror to the catalog's current state — the
        snapshot half of a full upload. Lock held."""
        versions, fids, cols = self._snapshot_group(group)
        group.fids, group.cols, group.rows = fids, cols, fids.size
        group._order = None
        group.versions = versions
        group.dirty = set()
        group.structural = False

    def _stage_upload(self, group: _ShardGroup, rp: int) -> None:
        """Stack the (fresh) host mirror and copy the block into the
        group's slice of the tensor, one host->device copy."""
        if group.rows > rp:
            # a concurrent insert grew the group past the capacity check
            # at the top of refresh(): re-pad and retry instead of serving
            # a truncated block (or crashing the stack staging)
            raise _RepadNeeded(group.rows)
        stack = self._stack_f32(group, rp)
        self._buf[group.gid].copy_(torch.from_numpy(stack))
        group.uploaded = True
        self._epoch += 1
        self.full_uploads += 1
        self._bytes_moved("full", stack.nbytes)

    def _full_upload(self, group: _ShardGroup, rp: int) -> None:
        self._host_refresh(group)
        self._stage_upload(group, rp)

    def _delta_refresh(self, group: _ShardGroup) -> bool:
        """Scatter just the dirty rows into the resident block; returns
        False when the group needs the full-upload fallback instead."""
        # swap the dirty set out BEFORE reading versions: a hook landing
        # after the swap goes to the fresh set and keeps the group stale
        # (re-scattered next refresh), so a concurrent mutation can delay
        # a row's upload by one refresh but never lose it — and the
        # fromiter below never races a growing set
        dirty_set, group.dirty = group.dirty, set()
        versions = self._shard_versions(group)   # BEFORE the row gather
        dirty = np.fromiter(dirty_set, dtype=np.int64, count=len(dirty_set))
        rows = group.locate(dirty)
        if rows is None:
            group.dirty |= dirty_set
            return False                    # unseen fid: rows shifted
        cols, present = self.catalog.gather_rows(dirty.tolist(),
                                                 with_strings=False)
        if not bool(present.all()):
            group.dirty |= dirty_set
            return False                    # raced a remove: restack
        vals = np.zeros((len(KERNEL_COLUMNS) + 1, dirty.size),
                        dtype=np.float32)
        for i, name in enumerate(KERNEL_COLUMNS):
            group.cols[name][rows] = cols[name]      # host mirror first
            vals[i] = cols[name]
        vals[_VALID_COL] = 1.0               # pure updates: rows stay valid
        # one copy of the values up, one of the rows, one index_copy_ into
        # the group's slice (the rows are distinct: the dirty set is a set)
        dev = self._buf.device
        self._buf[group.gid].index_copy_(
            1, torch.from_numpy(rows.astype(np.int64)).to(dev),
            torch.from_numpy(vals).to(dev))
        group.versions = versions
        self._epoch += 1
        self.delta_refreshes += 1
        self.rows_scattered += int(dirty.size)
        self._bytes_moved("scatter", vals.nbytes)
        return True

    def _bytes_moved(self, mode: str, nbytes: int) -> None:
        self.telemetry.counter(
            "store_bytes_moved", help="host->device bytes shipped",
            mode=mode, **self._tlabels).inc(int(nbytes))

    def _round_up(self, n: int) -> int:
        return -(-max(n, 1) // self.tile) * self.tile

    def _group_count(self, group: _ShardGroup) -> int:
        return sum(self.catalog.shards[s].count() for s in group.shard_ids)

    def _pad_resident(self) -> int:
        """Bring the tensor to the current ``self._rp`` rows a group. When
        it grows, the wider tensor is allocated and every clean uploaded
        group is copied into it device to device instead of re-uploaded —
        only the grown group pays a full upload; groups already headed for
        a full upload (structural / never uploaded) are left at zeros. Both
        tensors are held during the copy. Returns the number of groups
        copied. Lock held."""
        old = self._buf
        if old is not None and old.shape[2] == self._rp:
            return 0
        new = torch.zeros((self.n_groups, len(KERNEL_COLUMNS) + 1, self._rp),
                          dtype=torch.float32, device=self.device)
        padded = 0
        for group in self._groups:
            if old is None or not group.uploaded or group.structural:
                continue
            new[group.gid, :, : old.shape[2]].copy_(old[group.gid])
            padded += 1
            self.device_pads += 1
        self._buf = new
        if padded:
            self._epoch += 1
        return padded

    def refresh(self) -> Dict[str, int]:
        """Bring every stale shard group up to date; returns counters of
        the refresh modes taken: ``full``/``delta``/``fresh`` groups, plus
        ``padded`` blocks widened on the device by a grown sibling."""
        with self.telemetry.trace("store.refresh", **self._tlabels) as _sp:
            stats = self._refresh_locked()
            _sp.annotate(**stats)
            return stats

    def _refresh_locked(self) -> Dict[str, int]:
        with self._lock:
            stats = {"full": 0, "delta": 0, "fresh": 0, "padded": 0}
            stale = [g for g in self._groups if self._stale(g)]
            stats["fresh"] = len(self._groups) - len(stale)
            if not stale:
                return stats
            # a grown group re-pads the capacity, but siblings keep their
            # blocks: clean groups are copied on the device
            # (_pad_resident), only the grown group re-uploads
            need = max((self._group_count(g) for g in self._groups),
                       default=1)
            if need > self._rp or self._rp == 0:
                self._rp = self._round_up(int(need * self.headroom))
            stats["padded"] += self._pad_resident()
            # bounded retry: a concurrent insert can outgrow the capacity
            # check above (_stage_upload raises _RepadNeeded) — re-pad and
            # retry the still-stale groups, never serve a truncated block
            for _attempt in range(8):
                try:
                    for group in stale:
                        if not self._stale(group):
                            continue        # settled on a prior attempt
                        churn_ok = (group.uploaded and not group.structural
                                    and group.dirty
                                    and len(group.dirty)
                                    <= self.refresh_frac
                                    * max(1, group.rows))
                        if churn_ok and self._delta_refresh(group):
                            stats["delta"] += 1
                        else:
                            self._full_upload(group, self._rp)
                            stats["full"] += 1
                    return stats
                except _RepadNeeded as grown:
                    self._rp = self._round_up(
                        int(grown.rows * self.headroom))
                    stats["padded"] += self._pad_resident()
            raise PolicyError(
                "device store could not settle a refresh: the catalog "
                "grew on every re-pad attempt")

    # -- matching --------------------------------------------------------------
    def match(self, exprs: Sequence, now: float,
              use_kernel: Optional[bool] = None,
              with_agg: bool = True,
              subject: Optional[str] = None) -> MeshMatch:
        """Evaluate ``[combined criteria] + per-rule conditions`` over the
        resident groups; see :class:`MeshMatch`. Raises PolicyError on
        glob (host-only) predicates — callers fall back to the numpy path.
        ``with_agg=False`` skips the fused size-profile aggregation (the
        engine's match path needs only mask + attribution; ``.agg`` then
        reads all-zero). ``use_kernel`` as ``ops.mesh_policy_scan_batch``:
        None picks the kernel on the card and the plain version on the
        CPU. ``subject=`` scoping is not ported yet."""
        if subject is not None:
            raise _not_ported("subject= scoping", 6, "the permissions plane")
        # the lock is held for the WHOLE match (launch and readback): a
        # concurrent refresh would rewrite the resident blocks under the
        # in-flight launch and mutate the host mirrors this match
        # translates through — concurrent matches serialize instead
        with self._lock, \
                self.telemetry.trace("store.match", **self._tlabels) as _sp:
            m = self._match_locked(exprs, now, use_kernel, with_agg)
            _sp.annotate(rows_revaluated=m.reval, scoped=False)
            return m

    def _match_locked(self, exprs: Sequence, now: float,
                      use_kernel: Optional[bool], with_agg: bool
                      ) -> MeshMatch:
        from ..kernels.policy_scan.ops import (_agg_dict, _program_tuples,
                                               merge_agg_partials,
                                               mesh_policy_scan_batch)
        ops, colidx, operands = compile_programs(exprs, self.catalog.strings,
                                                 now)
        ops_t, colidx_t = _program_tuples(ops, colidx)
        self.refresh()
        with self.telemetry.trace("store.match.launch",
                                  groups=self.n_groups, **self._tlabels):
            mask, rule, agg = mesh_policy_scan_batch(
                self._buf, torch.from_numpy(operands).to(self.device),
                ops_t=ops_t, colidx_t=colidx_t,
                size_col=KERNEL_COLUMNS.index("size"),
                blocks_col=KERNEL_COLUMNS.index("blocks"),
                valid_col=_VALID_COL, with_agg=with_agg,
                use_kernel=use_kernel)
        # only mask + attribution cross device→host, never the columns
        with self.telemetry.trace("store.match.combine", **self._tlabels):
            mask_np = mask.cpu().numpy()
            rule_np = rule.cpu().numpy()
            agg_np = agg.cpu().numpy()
        mirrors, group_idx, group_rule = [], [], []
        reval = 0
        for i, g in enumerate(self._groups):
            idx = np.nonzero(mask_np[i, : g.rows] > 0.5)[0]
            mirrors.append((g.fids, g.cols))
            group_idx.append(idx)
            group_rule.append(rule_np[i, idx].astype(np.int32))
            reval += g.rows
        per_rule = merge_agg_partials([agg_np], len(ops_t))
        return MeshMatch(self, self._epoch, mirrors, group_idx, group_rule,
                         _agg_dict(per_rule[0], per_rule), reval)

    def scan(self, expr, now: float, use_kernel: Optional[bool] = None
             ) -> Tuple[np.ndarray, dict]:
        """Single-expression scan: (matching fids, aggregate dict) — the
        device-resident analogue of ``ops.scan_catalog``."""
        match = self.match([expr], now, use_kernel=use_kernel)
        fids, _sizes, _sort, _ridx = match.plan("size")
        return fids, match.agg
