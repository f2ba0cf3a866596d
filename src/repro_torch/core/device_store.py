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

Analytics planes (resident reports + profile cube)
--------------------------------------------------
Beyond the kernel columns, each group's block can carry four **analytics
rows** (``(D, C+1+4, Rp)`` once either plane is on), maintained by the
very same upload/scatter paths:

* **reports plane** (:meth:`DeviceColumnStore.enable_reports_plane`):
  one ``ord`` row — each row's rank in its group's *sorted-path* order.
  ``rbh-du`` becomes two host binary searches into the group's sorted
  path mirror plus one range aggregate on the device
  (:func:`~repro_torch.kernels.policy_scan.ops.mesh_range_aggregate`);
  ``rbh-find`` is one lean store-form launch whose winners translate to
  paths through the mirror; top-N listings run a two-pass top-k on the
  device (:func:`~repro_torch.kernels.policy_scan.ops.mesh_column_topk`
  finds the exact k-th-best threshold, a threshold mask then recovers
  every boundary tie). A *rename* (path change on a pure update) shifts
  the sorted order, so it degrades that group to a full re-upload exactly
  like a structural change.
* **cube plane** (:meth:`DeviceColumnStore.enable_cube_plane`): three
  rows — dense profile group id (``core.profiles.GroupIndex``), size
  bucket and age bucket (bucketized exactly on the host at scatter
  time). The store additionally keeps a flat **partial profile cube** a
  group, ``(D, 3, bp*S*A)`` on the device, built by
  :func:`~repro_torch.kernels.profile_cube.ops.mesh_profile_cube` (one
  ``profile_cube`` launch a group writing its exact sums as f64) and
  maintained by O(dirty) *signed* ``index_add_`` scatter-adds (exact in
  f64, so a cell that shrinks keeps no rounding of its past size) from
  the same delta batches that refresh the columns; queries sum the
  partials on the device
  (:func:`~repro_torch.kernels.profile_cube.ops.mesh_cube_combine`) —
  after the cold build no profile query re-reads host columns. Age
  buckets reference the store-wide ``_cube_ref`` instant; per-row flip
  schedules (mirroring ``core.profiles._ShardCube``) advance only the due
  rows when queries move ``now`` forward.
* **permissions plane**
  (:meth:`DeviceColumnStore.enable_permissions_plane`): per-subject
  visibility pre-materialized as packed 32-bit bitsets over local row
  ids — one ``(D, Sp, Rp/32)`` int32 tensor on the store's device beside
  the column tensor (bit ``b`` of word ``w``, LSB first, covers local row
  ``w*32+b``; the kernels read the words as u32). Visibility comes from a
  :class:`~repro_torch.core.grants.GrantTable`: uid/gid ownership via the
  interned owner/group codes, directory-subtree grants resolved through
  the reports plane's sorted-path mirrors (the same rank-range shape as
  ``du`` — enabling this plane forces the reports plane on). Scoped
  queries (``subject=`` on :meth:`match` / :meth:`scan` /
  :meth:`find_paths` / :meth:`top_files` / :meth:`du` /
  :meth:`analytics_cube`) pass the plane and the subject's id to the ops:
  on the card the store form's scoped variant and the scoped cube AND the
  subject's bit into each row's validity inside the kernel — tenant
  scoping is one fused AND, never a second scan. Maintenance follows the
  column contract: pure updates re-derive only the dirty rows' visibility
  and scatter just the *changed packed words* into the resident tensor
  (one ``index_copy_`` along the word axis); structural churn / renames /
  re-pads invalidate the group's bitset alongside its block, and any
  :attr:`~repro_torch.core.grants.GrantTable.version` tick (new subject or
  grant change) re-materializes on the next scoped query.

Tiered residency (out-of-core catalogs)
---------------------------------------
With ``hbm_budget_rows`` set, the whole column stack no longer needs to
fit on the card. A placement pass at the top of every refresh ranks
shard groups by decayed delta churn (``heat``) and the profile cube's
hot-volume fraction, and keeps the hottest prefix resident under the
budget (``m·Rp + 2·D·Rw <= hbm_budget_rows``: ``2·D·Rw`` rows are the
double-buffered streaming window, reserved when anything is demoted;
residents win exact ties, so placement has hysteresis). The resident
groups are the slices of ONE compact ``(Dr, C+1(+4), Rp)`` tensor, in
gid order (``_slots`` maps a gid to its slice; the permissions plane and
the partial cubes follow the same map). A placement change allocates
the new tensor and copies the kept groups into it device to device, as a
re-pad does: both tensors are held during the copy, so the peak is their
sum; only a promoted group pays an upload. The other groups **demote**:
the group's columns are packed into a host
:class:`~repro_torch.core.segments.PackedSegment` (exact round trip),
saved beside the catalog's sqlite mirror when it has one, and its host
mirrors dropped — the segment *is* the warm copy. ``demote_async=True``
packs on a worker thread from a shadow snapshot without the store lock
(the worker touches no CUDA tensor); the commit re-validates the catalog
versions under the lock (a raced pack is discarded: ``demote_races``),
and the next refresh frees the group's slices. A hot-again group
**promotes**: its segment decodes back into the host mirrors and stages
through the normal upload.

Queries answer over the whole catalog, byte-identical to an unbudgeted
store and the host folds. The resident groups run exactly the launches
of an unbudgeted store. A demoted group **streams**: its segment decodes
into a cached f32 row stack that goes up in windows of ``D·Rw`` rows,
each a ``(1, C+1(+4), D·Rw)`` store-shaped tensor (the reference's
``(D, ·, Rw)`` window with its D slots laid end to end as one group,
so every op — the store form, the scoped cube — is one launch a window,
and a window's rows are the group's rows ``[base, base + D·Rw)`` in
order; rows past the group's end read ``valid = 0``). On the card two
pinned host staging buffers feed two device window buffers by
``copy_(non_blocking=True)`` on a side stream: window k's launch waits
on its copy's event, window k+2's copy waits on window k's compute
event, a staging buffer is rewritten only after its copy's event
completed, and results are consumed one window behind
(``window_stalls`` counts a consume whose compute had not finished). On
the CPU the same generator stages into plain host buffers, no stream.
Per-window partial aggregates merge with the resident ones (sum, max for
``any_match``). Unscoped cube queries never stream: each demoted group
keeps an exact int64 **frozen partial cube**, refrozen from the segment
only when a scheduled age flip passes.

Shared delta fan-out contract
-----------------------------
One catalog mutation fans out to every derived structure through
*independent* :meth:`Catalog.add_delta_hook` subscriptions, and each
consumer must apply it **exactly once**: this store's hook feeds the
per-group dirty sets, and a refresh drains a dirty *set* (duplicate
updates to one fid collapse) in one scatter. The policy engine's
incremental state consumes the same deltas via ``note_touched``; a full
scan over the store primes that cache through
:meth:`MeshMatch.cache_arrays` (mirror-served, no catalog re-read). The
column scatter, the analytics-row scatter and the signed cube move happen
in the same drain; the cube's move subtracts the *mirror* state (what the
resident cube holds) and adds the freshly gathered state, so collapsed
multi-updates net out exactly. A
:class:`~repro_torch.core.profiles.ProfileCube` that attached this store
claims the cube's single delta feed and makes its own hook a no-op.

f32 envelope
------------
Device blocks are float32, exactly like the single-launch kernel path:
sizes above 2**24 bytes land on the nearest representable f32 (~one part
in 16M — entries within one ulp of a size cutoff may flip vs the int64
numpy path) and epoch-second timestamps carry ~64 s resolution. The host
mirror keeps native dtypes, so fids, budget sizes and sort keys returned
to the planner are exact; only predicate evaluation lives in the f32
envelope. The analytics planes are exact where the reference's are
(its partial cubes and ``du`` sums are f32: exact for integer sums below
2**24 times the value granularity) and past that: partial-cube cells are
f64 sums of the f32 block values, rebuilt and scatter-added exactly below
2**53; ``du`` counts in integers and sums bytes in f64 on the device; path
ranks are exact below 2**24 rows a group.
Differential tests pin the envelope with f32-exact catalogs; the host
folds remain the differential oracles.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .catalog import Catalog, Delta
from .policy import KERNEL_COLUMNS, PolicyError, compile_programs
from .segments import PackedSegment
from .telemetry import counter_attr

_VALID_COL = len(KERNEL_COLUMNS)          # trailing 0/1 row-validity column

# analytics rows appended after the validity row when a plane is enabled
# (all four are allocated together; a disabled plane's rows stay zero)
_ORD_COL = _VALID_COL + 1                 # sorted-path rank (reports plane)
_GID_COL = _VALID_COL + 2                 # dense profile group id (cube)
_SB_COL = _VALID_COL + 3                  # size-profile bucket (cube)
_AB_COL = _VALID_COL + 4                  # age bucket as of _cube_ref (cube)
_N_ANALYTICS = 4

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
    """One shard group's slice of the catalog: host mirror + freshness.

    Beside the kernel-column mirror, a group carries the analytics-plane
    mirrors: ``offsets`` (member-shard row starts — find/top-N results
    re-emit in catalog ``arrays()`` order through them), the reports
    plane's row-aligned ``paths`` / sorted ``spaths`` / rank ``ord``, and
    the cube plane's per-row group id / size bucket / age bucket / next
    flip instant (``cgid``/``csb``/``cab``/``cflip``, ``cmin_flip`` the
    cheap due-rollover bound), and the permissions plane's per-subject row
    visibility ``vis`` (``packed``: its words are in the resident tensor).
    A demoted group keeps its ``offsets`` and versions; its warm copy is
    the ``segment`` (see "Tiered residency" in the module doc).
    """

    __slots__ = ("gid", "shard_ids", "fids", "cols", "rows", "versions",
                 "dirty", "structural", "uploaded", "_order",
                 "offsets", "paths", "spaths", "ord",
                 "cgid", "csb", "cab", "cflip", "cmin_flip", "vis",
                 "packed",
                 "resident", "segment", "churn", "heat", "pending_demote",
                 "frozen_cube", "frozen_min_flip", "frozen_ref",
                 "sstack", "sstack_ref", "svis", "svis_ver", "sspaths")

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
        self.offsets = np.zeros(1, np.int64)       # member-shard row starts
        self.paths: Optional[list] = None          # row-aligned (reports)
        self.spaths: Optional[np.ndarray] = None   # sorted paths (reports)
        self.ord: Optional[np.ndarray] = None      # row -> sorted-path rank
        self.cgid: Optional[np.ndarray] = None     # cube: dense group id
        self.csb: Optional[np.ndarray] = None      # cube: size bucket
        self.cab: Optional[np.ndarray] = None      # cube: age bucket @ ref
        self.cflip: Optional[np.ndarray] = None    # cube: next flip instant
        self.cmin_flip = np.inf
        self.vis: Optional[np.ndarray] = None      # perms: (Sp, rows) bool
        self.packed = False                        # perms: words resident
        # tiered residency (see "Tiered residency" in the module doc)
        self.resident = True               # on the card vs warm segment
        self.segment: Optional[PackedSegment] = None
        self.churn = 0                     # deltas since last placement pass
        self.heat = 0.0                    # decayed churn score (placement)
        self.pending_demote = False        # async pack in flight
        self.frozen_cube: Optional[np.ndarray] = None  # (3,b,S,A) i64 @ ref
        self.frozen_min_flip = np.inf      # first age flip that stales it
        self.frozen_ref = 0.0              # age reference it was built at
        # transient streaming caches (dropped on repack / promote)
        self.sstack: Optional[np.ndarray] = None   # decoded f32 row stack
        self.sstack_ref = np.nan                   # _cube_ref of sstack AB
        self.svis: Optional[np.ndarray] = None     # (Sp, rows) bool
        self.svis_ver = -1                         # grants version of svis
        self.sspaths: Optional[np.ndarray] = None  # sorted decoded paths

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
    ``hbm_budget_rows``, ``window_rows`` and ``demote_async`` turn on
    tiered residency (see the module docstring): the budget counts padded
    group rows on the card, windows included; ``window_rows`` (0: 32
    tiles, shrunk to fit the budget) rounds up to a tile multiple.
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
    cube_rebuilds = counter_attr(
        "store_cube_rebuilds", "full partial-cube rebuilds")
    rollovers = counter_attr(
        "store_rollovers", "age-bucket moves served on-device")
    store_queries = counter_attr(
        "store_queries", "report queries served resident")
    perm_materializations = counter_attr(
        "store_perm_materializations", "per-group perm bitset (re)builds")
    perm_word_scatters = counter_attr(
        "store_perm_word_scatters", "warm packed perm-word scatters")
    # tiering counters (RunReport and the tiering phase read these, so a
    # silently resident "streaming" run fails loudly)
    demotions = counter_attr(
        "store_demotions", "groups packed to warm segments")
    promotions = counter_attr(
        "store_promotions", "groups re-uploaded from segments")
    segments_streamed = counter_attr(
        "store_segments_streamed", "warm-segment sweeps executed")
    windows_streamed = counter_attr(
        "store_windows_streamed", "device-window batches uploaded")
    window_stalls = counter_attr(
        "store_window_stalls", "window consume blocked on compute")
    segment_repacks = counter_attr(
        "store_segment_repacks", "stale segments re-encoded")
    demote_races = counter_attr(
        "store_demote_races", "async packs discarded (raced)")

    def __init__(self, catalog: Catalog, groups: int = 1, device=None,
                 refresh_frac: float = 0.25, tile: int = 0,
                 headroom: float = 1.25,
                 hbm_budget_rows: Optional[int] = None,
                 window_rows: int = 0,
                 demote_async: bool = False) -> None:
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
        # tiered residency: total padded group rows the card may hold
        # (None = unlimited, everything stays resident); when any group is
        # demoted, 2*D*window_rows of the budget are reserved for the
        # double-buffered streaming window
        self.hbm_budget_rows = hbm_budget_rows
        # streaming window rows per group slot: 0 -> sized lazily from the
        # budget; explicit values round up to a tile multiple (the perm
        # window packing also needs a multiple of 32, which tile is)
        self._rw = (-(-window_rows // self.tile) * self.tile
                    if window_rows else 0)
        self.demote_async = demote_async
        self._demote_workers: List[threading.Thread] = []
        self._lock = threading.RLock()
        self._groups = [
            _ShardGroup(g, [s for s in range(catalog.n_shards)
                            if s % self.n_groups == g])
            for g in range(self.n_groups)]
        self._rp = 0                        # padded rows per group block
        # (Dr, C+1(+4), Rp) f32: the resident groups in gid order; _slots
        # maps a gid to its slice (and to its slices of _perm_buf and
        # _cube_partials)
        self._buf: Optional[torch.Tensor] = None
        self._slots: Dict[int, int] = {}
        self._staging: Dict[tuple, list] = {}   # pinned window buffers
        self._copy_stream = None            # side stream of window copies
        self._epoch = 0                     # bumped by every mirror mutation
        # analytics planes (see module docstring): off until enabled
        self._plane_reports = False
        self._plane_cube = False
        self._cube_groups = None            # shared core.profiles.GroupIndex
        self._cube_clock = None
        self._cube_ref = 0.0                # age reference of resident cab
        self._cube_bp = 0                   # padded group capacity
        self._cube_partials: Optional[torch.Tensor] = None  # (Dr, 3, bp*S*A) f64
        self._cube_cache = None             # host int64 (3, bp, S, A) cache
        self._cube_stale = True             # partials need a full rebuild
        self._plane_perm = False
        self._grants = None                 # shared core.grants.GrantTable
        self._grants_version = -1           # table version at materialization
        self._perm_sp = 0                   # padded subject capacity
        self._perm_buf: Optional[torch.Tensor] = None  # (Dr, Sp, Rp/32) i32
        # refresh/tiering counters: registry-backed series on the catalog's
        # telemetry plane (instance label keeps several stores sharing one
        # catalog distinct); the zeroing writes below create the series so
        # they export as 0 before first use
        self.telemetry = catalog.telemetry
        self._tlabels = {"store": catalog.telemetry.instance("store")}
        self.full_uploads = 0
        self.delta_refreshes = 0
        self.rows_scattered = 0
        self.device_pads = 0                # device-to-device re-pads
        self.cube_rebuilds = 0
        self.rollovers = 0                  # age-bucket moves served on-device
        self.store_queries = 0              # report queries served resident
        self.perm_materializations = 0      # per-group bitset (re)builds
        self.perm_word_scatters = 0         # warm packed-word scatters
        self.demotions = 0                  # groups packed to warm segments
        self.promotions = 0                 # groups re-uploaded from segments
        self.segments_streamed = 0          # warm-segment sweeps executed
        self.windows_streamed = 0           # window batches uploaded
        self.window_stalls = 0              # consume blocked on compute
        self.segment_repacks = 0            # stale segments re-encoded
        self.demote_races = 0               # async packs discarded (raced)
        catalog.add_delta_hook(self._on_delta, batch=self._on_delta_batch)

    # -- analytics planes ------------------------------------------------------
    def _block_rows(self) -> int:
        """Block row count: kernel columns + validity, plus the analytics
        rows once any plane is enabled."""
        extra = _N_ANALYTICS if (self._plane_reports or self._plane_cube) \
            else 0
        return len(KERNEL_COLUMNS) + 1 + extra

    def enable_reports_plane(self) -> None:
        """Add the sorted-path-rank row + path mirrors to every block so
        ``find``/``top_files``/``du`` serve from the resident tensor.
        Idempotent; the next refresh pays one full re-upload."""
        with self._lock:
            if self._plane_reports:
                return
            self._plane_reports = True
            self._drop_device_state()

    def enable_cube_plane(self, groups, clock) -> None:
        """Add the gid/size-bucket/age-bucket rows plus the per-group
        partial profile cubes. ``groups`` is the shared
        :class:`~repro_torch.core.profiles.GroupIndex` (report masks read
        its key columns) and ``clock`` supplies the age reference.
        Idempotent for the same index; a different index raises."""
        with self._lock:
            if self._plane_cube:
                if groups is not self._cube_groups:
                    raise PolicyError(
                        "cube plane already enabled with a different "
                        "GroupIndex")
                return
            self._plane_cube = True
            self._cube_groups = groups
            self._cube_clock = clock
            self._cube_ref = float(clock())
            self._drop_device_state()

    def enable_permissions_plane(self, grants) -> None:
        """Add the per-subject packed visibility bitsets (multi-tenant
        ``subject=`` scoping). ``grants`` is the shared
        :class:`~repro_torch.core.grants.GrantTable`; subtree grants resolve
        through the sorted-path mirrors, so this forces the reports plane
        on. Idempotent for the same table; a different table raises, and so
        does a tile that is not a multiple of 32 (rows pack into 32-bit
        words)."""
        with self._lock:
            if self._plane_perm:
                if grants is not self._grants:
                    raise PolicyError(
                        "permissions plane already enabled with a "
                        "different GrantTable")
                return
            if self.tile % 32:
                raise PolicyError(
                    "permissions plane packs rows into 32-bit words; the "
                    f"block tile must be a multiple of 32, got {self.tile}")
            self._plane_perm = True
            self._grants = grants
            self._grants_version = -1
            self._plane_reports = True
            self._drop_device_state()

    def _drop_device_state(self) -> None:
        """Invalidate every resident block (block layout changed): the
        next refresh re-uploads at the new row count. Lock held."""
        self._buf = None
        self._slots = {}
        self._cube_partials = None
        self._cube_cache = None
        self._cube_stale = True
        self._perm_buf = None
        self._epoch += 1
        for group in self._groups:
            group.uploaded = False
            group.vis = None
            group.packed = False

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
                group.offsets = np.zeros(1, np.int64)
                group.paths = group.spaths = group.ord = None
                group.cgid = group.csb = group.cab = group.cflip = None
                group.cmin_flip = np.inf
                group.resident = True
                group.segment = None
                group.pending_demote = False
                group.churn = 0
                group.heat = 0.0
                group.frozen_cube = None
                group.frozen_min_flip = np.inf
                group.sstack = group.svis = group.sspaths = None
                group.sstack_ref = np.nan
                group.svis_ver = -1
            self._rp = 0
            self._staging = {}

    # -- delta intake (catalog mutation hooks) --------------------------------
    def _on_delta(self, old: Optional[Delta], new: Optional[Delta]) -> None:
        ref = new if new is not None else old
        if ref is None:
            return
        fid = int(ref[0])
        group = self._groups[self.catalog._shard_id(fid) % self.n_groups]
        group.churn += 1                    # placement heat (resident or not)
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
            group.churn += 1
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
                                   Dict[str, np.ndarray], list, np.ndarray]:
        """(versions-before, fids, native column dict, paths, offsets)
        for a full upload. Paths are gathered only when the reports plane
        is on; ``offsets`` records each member shard's row start (the
        group's row order is the concat of member-shard snapshots, so
        results re-emit in catalog ``arrays()`` order through it)."""
        versions = self._shard_versions(group)   # BEFORE the snapshot reads
        names = ("fid",) + KERNEL_COLUMNS
        with_paths = self._plane_reports
        parts, paths, counts = [], [], []
        for s in group.shard_ids:
            cols_s, snap = self.catalog.shards[s].snapshot(
                names=names, with_strings=with_paths)
            parts.append(cols_s)
            counts.append(cols_s["fid"].size)
            if with_paths:
                paths.extend(snap.gather("_paths"))
        if parts:
            cols = {n: np.concatenate([p[n] for p in parts]) for n in names}
        else:
            cols = {n: np.zeros(0, dtype=np.int64) for n in names}
        # fid stays IN the mirror dict (it is a valid plan sort key)
        cols["fid"] = fids = cols["fid"].astype(np.int64, copy=False)
        offsets = np.concatenate([[0], np.cumsum(np.asarray(counts,
                                                            np.int64))])
        return versions, fids, cols, paths, offsets

    def _cube_codes(self, cols) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
        """(gid, size bucket, age bucket as of ``_cube_ref``, next flip
        instant) of rows with native columns ``cols``, bucketized exactly
        on the host."""
        from .profiles import _FLIP_EDGES, age_buckets_np, size_buckets_np
        gid = self._cube_groups.get_or_add_many(
            cols["owner"], cols["group"], cols["type"], cols["hsm_state"])
        sb = size_buckets_np(np.asarray(cols["size"], np.int64))
        stamps = np.asarray(cols["atime"], np.float64)
        ab = age_buckets_np(self._cube_ref - stamps)
        return gid, sb, ab, stamps + _FLIP_EDGES[ab]

    def _refresh_plane_mirrors(self, group: _ShardGroup,
                               paths: list) -> None:
        """Recompute a group's analytics mirrors after a full snapshot."""
        n = group.rows
        if self._plane_reports:
            group.paths = paths
            parr = np.asarray(paths) if paths else np.zeros(0, dtype="<U1")
            order = np.argsort(parr, kind="stable")
            group.spaths = parr[order]
            rank = np.empty(n, np.int64)
            rank[order] = np.arange(n)
            group.ord = rank
        if self._plane_cube:
            group.cgid, group.csb, group.cab, group.cflip = \
                self._cube_codes(group.cols)
            finite = np.isfinite(group.cflip)
            group.cmin_flip = float(group.cflip[finite].min()) \
                if finite.any() else np.inf

    def _stack_f32(self, group: _ShardGroup, rp: int) -> np.ndarray:
        """(block rows, rp) f32 block staging from the host mirrors."""
        out = np.zeros((self._block_rows(), rp), dtype=np.float32)
        for i, name in enumerate(KERNEL_COLUMNS):
            out[i, : group.rows] = group.cols[name]
        out[_VALID_COL, : group.rows] = 1.0
        if self._plane_reports and group.ord is not None:
            out[_ORD_COL, : group.rows] = group.ord
        if self._plane_cube and group.cgid is not None:
            out[_GID_COL, : group.rows] = group.cgid
            out[_SB_COL, : group.rows] = group.csb
            out[_AB_COL, : group.rows] = group.cab
        return out

    def _host_refresh(self, group: _ShardGroup) -> None:
        """Bring a group's host mirrors (columns + plane mirrors) to the
        catalog's current state — the snapshot half of a full upload,
        shared with segment packing. Lock held (or a thread-private
        shadow group)."""
        versions, fids, cols, paths, offsets = self._snapshot_group(group)
        group.fids, group.cols, group.rows = fids, cols, fids.size
        group._order = None
        group.offsets = offsets
        self._refresh_plane_mirrors(group, paths)
        group.versions = versions
        group.dirty = set()
        group.structural = False

    def _mirror_fresh(self, group: _ShardGroup) -> bool:
        """True when the host mirrors already match the catalog (and hold
        every enabled plane's arrays), so an upload can stage straight
        from them without re-snapshotting. Lock held."""
        if group.dirty or group.structural or not group.cols:
            return False
        if self._plane_reports and group.ord is None:
            return False
        if self._plane_cube and group.cgid is None:
            return False
        return self._shard_versions(group) == group.versions

    def _stage_upload(self, group: _ShardGroup, rp: int) -> None:
        """Stack the (fresh) host mirror and copy the block into the
        group's slice of the tensor, one host->device copy. Row positions
        are whatever the mirrors hold, so callers that changed them must
        invalidate vis/cube themselves."""
        if group.rows > rp:
            # a concurrent insert grew the group past the capacity check
            # at the top of refresh(): re-pad and retry instead of serving
            # a truncated block (or crashing the stack staging)
            raise _RepadNeeded(group.rows)
        stack = self._stack_f32(group, rp)
        self._buf[self._slots[group.gid]].copy_(torch.from_numpy(stack))
        group.uploaded = True
        self._epoch += 1
        self.full_uploads += 1
        self._bytes_moved("full", stack.nbytes)
        if self._plane_perm:
            # the group's packed words describe the old rows: repack
            group.packed = False

    def _full_upload(self, group: _ShardGroup, rp: int) -> None:
        self._host_refresh(group)
        self._stage_upload(group, rp)
        if self._plane_perm:
            # row positions changed: the group's visibility indexes stale
            # local rows — re-materialize on the next scoped query
            group.vis = None
        if self._plane_cube:
            # row positions changed: this group's resident partial cube
            # no longer matches the block — rebuild on next cube query
            self._cube_stale = True
            self._cube_cache = None

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
        cols, present = self.catalog.gather_rows(
            dirty.tolist(), with_strings=self._plane_reports)
        if not bool(present.all()):
            group.dirty |= dirty_set
            return False                    # raced a remove: restack
        if self._plane_reports:
            # a rename shifts the group's sorted-path order (every rank
            # after the move changes): degrade to a full re-upload, the
            # same fallback as a structural change
            if any(group.paths[r] != p
                   for r, p in zip(rows.tolist(), cols["_paths"])):
                group.dirty |= dirty_set
                group.structural = True
                return False
        cube_live = (self._plane_cube and self._cube_partials is not None
                     and not self._cube_stale)
        if cube_live:
            # capture the OLD cube cells before the mirror updates — the
            # signed move subtracts exactly what the resident cube holds
            old_cells = (group.cgid[rows].copy(), group.csb[rows].copy(),
                         group.cab[rows].copy(),
                         np.asarray(group.cols["size"][rows], np.float32),
                         np.asarray(group.cols["blocks"][rows], np.float32))
        vals = np.zeros((self._block_rows(), dirty.size), dtype=np.float32)
        for i, name in enumerate(KERNEL_COLUMNS):
            group.cols[name][rows] = cols[name]      # host mirror first
            vals[i] = cols[name]
        vals[_VALID_COL] = 1.0               # pure updates: rows stay valid
        if self._plane_reports:
            vals[_ORD_COL] = group.ord[rows]  # paths unchanged: ranks stay
        if self._plane_cube:
            ngid, nsb, nab, nflip = self._cube_codes(cols)
            group.cgid[rows] = ngid
            group.csb[rows] = nsb
            group.cab[rows] = nab
            group.cflip[rows] = nflip
            finite = np.isfinite(nflip)
            if finite.any():
                group.cmin_flip = min(group.cmin_flip,
                                      float(nflip[finite].min()))
            vals[_GID_COL] = ngid
            vals[_SB_COL] = nsb
            vals[_AB_COL] = nab
        # one copy of the values up, one of the rows, one index_copy_ into
        # the group's slice (the rows are distinct: the dirty set is a set)
        dev = self._buf.device
        slot = self._slots[group.gid]
        self._buf[slot].index_copy_(
            1, torch.from_numpy(rows.astype(np.int64)).to(dev),
            torch.from_numpy(vals).to(dev))
        if cube_live:
            if len(self._cube_groups) > self._cube_bp:
                # a delta minted more groups than the partials can hold:
                # full cube rebuild on the next query
                self._cube_stale = True
                self._cube_cache = None
            else:
                ogid, osb, oab, osize, oblocks = old_cells
                ones = np.ones(dirty.size, np.float32)
                self._cube_scatter(
                    group, np.concatenate([self._cells(ogid, osb, oab),
                                           self._cells(ngid, nsb, nab)]),
                    np.stack([
                        np.concatenate([-ones, ones]),
                        np.concatenate([-osize, np.asarray(
                            cols["size"], np.float32)]),
                        np.concatenate([-oblocks, np.asarray(
                            cols["blocks"], np.float32)])]))
        if self._plane_perm:
            perm_live = (group.vis is not None and group.packed
                         and self._perm_buf is not None
                         and self._grants.version == self._grants_version)
            if perm_live:
                # pure updates keep row positions and paths, so only the
                # ownership grants of the dirty rows can flip: re-derive
                # just those rows' visibility and scatter the changed
                # packed words (one index_copy_ along the word axis)
                nvis = self._vis_rows(
                    group.spaths, np.asarray(cols["owner"], np.int64),
                    np.asarray(cols["group"], np.int64), group.ord[rows])
                if not np.array_equal(nvis, group.vis[:, rows]):
                    group.vis[:, rows] = nvis
                    words = np.unique(rows // 32)
                    wvals = self._pack_words(group, words)
                    self._perm_buf[slot].index_copy_(
                        1, torch.from_numpy(words.astype(np.int64)).to(dev),
                        torch.from_numpy(wvals.view(np.int32)).to(dev))
                    self.perm_word_scatters += 1
            else:
                # grants ticked (or the bitset never materialized): a
                # row-granular patch could miss a new subject's row —
                # drop the group's bitset, rebuilt on the next scoped
                # query by _ensure_perms
                group.vis = None
        group.versions = versions
        self._epoch += 1
        self.delta_refreshes += 1
        self.rows_scattered += int(dirty.size)
        self._bytes_moved("scatter", vals.nbytes)
        return True

    @staticmethod
    def _cells(gid: np.ndarray, sb: np.ndarray, ab: np.ndarray
               ) -> np.ndarray:
        """Flat partial-cube cell index of each row: (gid * S + sb) * A +
        ab."""
        from .profiles import A, S
        return ((np.asarray(gid, np.int64) * S + sb) * A + ab).astype(
            np.int64)

    def _scatter_row(self, group: _ShardGroup, row: int, rows: np.ndarray,
                     vals: np.ndarray) -> None:
        """Set ONE block row of one group at local rows ``rows`` (age-bucket
        rollovers touch only the ``_AB_COL`` row): one ``index_copy_``."""
        dev = self._buf.device
        self._buf[self._slots[group.gid], row].index_copy_(
            0, torch.from_numpy(rows.astype(np.int64)).to(dev),
            torch.from_numpy(vals.astype(np.float32)).to(dev))

    def _cube_scatter(self, group: _ShardGroup, flat: np.ndarray,
                      vals: np.ndarray) -> None:
        """Signed scatter-add of (3, k) measure deltas into the group's
        flat partial cube at cells ``flat``: one ``index_add_``. The deltas
        are f32 values of whole counts and bytes and the partials f64, so
        the adds are exact in any order below 2**53. Drops the host cube
        cache."""
        dev = self._cube_partials.device
        self._cube_partials[self._slots[group.gid]].index_add_(
            1, torch.from_numpy(flat).to(dev),
            torch.from_numpy(np.asarray(vals, np.float64)).to(dev))
        self._cube_cache = None

    def _bytes_moved(self, mode: str, nbytes: int) -> None:
        self.telemetry.counter(
            "store_bytes_moved", help="host->device bytes shipped",
            mode=mode, **self._tlabels).inc(int(nbytes))

    def _round_up(self, n: int) -> int:
        return -(-max(n, 1) // self.tile) * self.tile

    def _group_count(self, group: _ShardGroup) -> int:
        return sum(self.catalog.shards[s].count() for s in group.shard_ids)

    def _pad_resident(self) -> int:
        """Bring the tensor to the resident groups (gid order) at the
        current ``self._rp`` rows a group. When it widens, or the resident
        set changed (placement), the new tensor is allocated and every
        clean uploaded group is copied into it device to device instead of
        re-uploaded — only a grown or promoted group pays a full upload;
        groups already headed for a full upload (structural / never
        uploaded) are left at zeros, and a demoted group's slices are
        freed. The copy carries every block row, the analytics rows
        included. The partial cubes do not depend on row positions: they
        stay, compacted the same way when the resident set changed. The
        permissions words follow a compaction; after a widening they are
        repacked on the next scoped query (their word axis widens). Both
        tensors are held during the copy. Returns the number of groups
        widened. Lock held."""
        old, old_slots = self._buf, self._slots
        slots = {g.gid: i for i, g in enumerate(self._resident())}
        if old is not None and old.shape[2] == self._rp \
                and slots == old_slots:
            return 0
        if not slots:
            # nothing resident: every slice freed
            self._buf = None
            self._slots = {}
            self._compact_planes(old_slots, slots, False)
            return 0
        widen = old is not None and old.shape[2] != self._rp
        new = torch.zeros((len(slots), self._block_rows(), self._rp),
                          dtype=torch.float32, device=self.device)
        padded = 0
        for gid, slot in slots.items():
            group = self._groups[gid]
            if old is None or gid not in old_slots or not group.uploaded \
                    or group.structural:
                continue
            src = old[old_slots[gid]]
            new[slot, :, : src.shape[1]].copy_(src)
            if widen:
                # the word axis widened too: repack from the kept visibility
                group.packed = False
                padded += 1
                self.device_pads += 1
        self._buf = new
        self._slots = slots
        if slots != old_slots:
            self._compact_planes(old_slots, slots, widen)
        if padded:
            self._epoch += 1
        return padded

    def _compact_planes(self, old_slots: Dict[int, int],
                        slots: Dict[int, int], widen: bool) -> None:
        """Follow a resident-set change in the permissions plane and the
        partial cubes: the kept groups' slices are copied device to device
        into tensors of the new group count; a group with no old slice
        (promoted) repacks its words and forces a cube rebuild. Lock
        held."""
        kept = [(old_slots[g], s) for g, s in slots.items() if g in old_slots]
        parts = self._cube_partials
        if parts is not None:
            new = parts.new_zeros((len(slots),) + tuple(parts.shape[1:]))
            for o, s in kept:
                new[s].copy_(parts[o])
            self._cube_partials = new
            self._cube_cache = None
            if len(kept) < len(slots):
                self._cube_stale = True
        perm = self._perm_buf
        if perm is not None and not widen:
            new = perm.new_zeros((len(slots),) + tuple(perm.shape[1:]))
            for o, s in kept:
                new[s].copy_(perm[o])
            self._perm_buf = new
            for gid in slots:
                if gid not in old_slots:
                    self._groups[gid].packed = False

    def refresh(self) -> Dict[str, int]:
        """Bring every stale shard group up to date; returns counters of
        the refresh modes taken: ``full``/``delta``/``fresh`` resident
        groups, plus ``padded`` blocks widened on the device by a grown
        sibling. Placement (demote/promote under ``hbm_budget_rows``) and
        warm-segment freshness run first, so after a refresh both the
        resident blocks and the warm segments reflect the catalog."""
        with self.telemetry.trace("store.refresh", **self._tlabels) as _sp:
            stats = self._refresh_locked()
            _sp.annotate(**stats)
            return stats

    def _refresh_locked(self) -> Dict[str, int]:
        with self._lock:
            self._reap_demote_workers()
            self._placement_pass()
            self._ensure_segments()
            stats = {"full": 0, "delta": 0, "fresh": 0, "padded": 0}
            resident = self._resident()
            stale = [g for g in resident if self._stale(g)]
            stats["fresh"] = len(resident) - len(stale)
            if not stale:
                self._pad_resident()        # frees a demoted group's slices
                return stats
            # a grown group re-pads the capacity, but siblings keep their
            # blocks: clean groups are copied on the device
            # (_pad_resident), only the grown group re-uploads
            need = max((self._group_count(g) for g in resident), default=1)
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
                        elif self._mirror_fresh(group):
                            # fresh mirrors, no block (promotion from a
                            # warm segment): stage without re-snapshotting
                            self._stage_upload(group, self._rp)
                            stats["full"] += 1
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

    # -- tiered residency: placement, packing, promotion -----------------------
    def _resident(self) -> List[_ShardGroup]:
        """Resident groups in gid order — the slice order of ``_buf``."""
        return [g for g in self._groups if g.resident]

    def _demoted(self) -> List[_ShardGroup]:
        return [g for g in self._groups if not g.resident]

    def _window_rows(self) -> int:
        """Rows of one slot of the streaming window (tile multiple); a
        window holds ``D`` slots. Under a budget the two window buffers
        must fit the reserve, so the default 32-tile slot shrinks to
        budget/(2*D) when the budget is tighter."""
        if not self._rw:
            rw = 32 * self.tile
            if self.hbm_budget_rows:
                cap = max(self.hbm_budget_rows // (2 * self.n_groups), 1)
                rw = min(rw, cap)
            self._rw = max((rw // self.tile) * self.tile, self.tile)
        return self._rw

    def _hot_fraction(self, group: _ShardGroup) -> float:
        """Volume fraction of the group's young age buckets — the
        ProfileCube side of the placement signal (recently-accessed data
        predicts upcoming policy work). Served from the resident cube
        mirrors or the demoted group's frozen partial; 0 when the cube
        plane is off."""
        if not self._plane_cube:
            return 0.0
        from .profiles import HOT_AGE_BUCKETS, hot_volume_fraction
        if group.resident and group.cab is not None and group.rows:
            return hot_volume_fraction(
                group.cab, np.asarray(group.cols["size"], np.float64))
        if group.frozen_cube is not None:
            vol_ab = group.frozen_cube[1].sum(axis=(0, 1)).astype(np.float64)
            total = float(vol_ab.sum())
            if total <= 0.0:
                return 0.0
            return float(vol_ab[:HOT_AGE_BUCKETS].sum()) / total
        return 0.0

    def _placement_pass(self) -> None:
        """Decide the resident set under ``hbm_budget_rows``: groups rank
        by decayed churn heat, then cube hot-volume fraction (residents
        win exact ties — hysteresis), and the largest prefix whose padded
        blocks + window reserve fit the budget stays resident. Quiet
        groups demote to packed segments; hot-again groups promote.
        Lock held (start of refresh)."""
        budget = self.hbm_budget_rows
        if budget is None:
            for group in self._groups:
                if not group.resident:
                    self._promote(group)
            return
        for group in self._groups:
            group.heat = 0.5 * group.heat + group.churn
            group.churn = 0
        order = sorted(self._groups,
                       key=lambda g: (-g.heat, -self._hot_fraction(g),
                                      0 if g.resident else 1, g.gid))
        rw = self._window_rows()
        m = len(order)
        while m > 0:
            need = max((self._group_count(g) for g in order[:m]),
                       default=1)
            rp = self._round_up(int(need * self.headroom))
            reserve = 0 if m == len(order) else 2 * self.n_groups * rw
            if m * rp + reserve <= budget:
                break
            m -= 1
        desired = {g.gid for g in order[:m]}
        for group in self._groups:
            if group.resident and group.gid not in desired \
                    and not group.pending_demote:
                self._demote(group)
        for group in self._groups:
            if not group.resident and group.gid in desired:
                self._promote(group)
            elif group.resident and group.gid in desired:
                group.pending_demote = False   # placement changed its mind

    def _seg_fresh(self, group: _ShardGroup) -> bool:
        """True when the group's packed segment still matches the catalog
        and carries every enabled plane's columns. Lock held."""
        seg = group.segment
        if seg is None or group.dirty or group.structural:
            return False
        if self._plane_reports and "ord" not in seg.names:
            return False
        if self._plane_cube and "cgid" not in seg.names:
            return False
        return self._shard_versions(group) == group.versions

    def _ensure_segments(self) -> None:
        """Re-encode any demoted group whose segment went stale (churn on
        warm data): snapshot, repack, refreeze its cube partial. The
        churn counters feeding :meth:`_placement_pass` promote a group
        that keeps doing this. Lock held."""
        for group in self._groups:
            if group.resident or self._seg_fresh(group):
                continue
            self._commit_demote(group, self._pack_segment(group),
                                repack=True)

    def _pack_segment(self, group: _ShardGroup) -> PackedSegment:
        """Encode the group's columns into a PackedSegment (host mirrors
        refreshed first if stale), saved beside the sqlite mirror and
        mapped back read-only when the catalog has one. Lock held."""
        if not self._mirror_fresh(group):
            self._host_refresh(group)
        return self._pack_segment_from(group)

    def _pack_segment_from(self, group: _ShardGroup) -> PackedSegment:
        """Encode from already-fresh mirrors (the async demote path packs
        a thread-private shadow group, without the store lock)."""
        cols: Dict[str, np.ndarray] = {
            n: np.asarray(group.cols[n]) for n in PLAN_COLUMNS}
        if self._plane_reports:
            cols["path"] = np.asarray(
                group.paths if group.paths is not None else [],
                dtype="<U1" if not group.rows else None)
            cols["ord"] = group.ord
        if self._plane_cube:
            cols["cgid"] = group.cgid
            cols["csb"] = group.csb
        seg = PackedSegment.pack(
            cols, meta={"gid": group.gid, "rows": group.rows,
                        "versions": {str(k): int(v)
                                     for k, v in group.versions.items()}})
        path = self.catalog.sidecar_path(f"seg{group.gid}.npz")
        if path:
            seg.save(path)
            seg = PackedSegment.load(path, mmap=True)
        return seg

    def _freeze_cube(self, group: _ShardGroup) -> None:
        """Capture the demoted group's exact int64 partial cube at the
        current ``_cube_ref`` (host bincount over the cube mirrors) so
        unscoped profile queries never stream: merged cube = resident
        partials + frozen partials. Stale once an age flip passes
        ``frozen_min_flip`` (then :meth:`_refreeze` recomputes from the
        segment). Lock held, mirrors fresh."""
        from .profiles import A, S, _bincount_i64
        b = max(len(self._cube_groups), 1)
        k = b * S * A
        flat = self._cells(group.cgid, group.csb, group.cab)
        counts = np.bincount(flat, minlength=k)
        group.frozen_cube = np.stack([
            counts.astype(np.int64),
            _bincount_i64(flat, np.asarray(group.cols["size"], np.int64), k,
                          counts),
            _bincount_i64(flat, np.asarray(group.cols["blocks"], np.int64),
                          k, counts)]).reshape(3, b, S, A)
        group.frozen_min_flip = group.cmin_flip
        group.frozen_ref = self._cube_ref

    def _refreeze(self, group: _ShardGroup, now: float) -> int:
        """Recompute a demoted group's frozen partial cube at ``now``
        (decoding the segment) after an age-bucket flip passed. Returns
        the number of rows that moved buckets. Lock held."""
        from .profiles import (_FLIP_EDGES, A, S, _bincount_i64,
                               age_buckets_np)
        dec = group.segment.columns()
        stamps = np.asarray(dec["atime"], np.float64)
        old_ab = age_buckets_np(group.frozen_ref - stamps)
        new_ab = age_buckets_np(now - stamps)
        b = max(len(self._cube_groups), 1)
        k = b * S * A
        flat = self._cells(dec["cgid"], np.asarray(dec["csb"], np.int64),
                           new_ab)
        counts = np.bincount(flat, minlength=k)
        group.frozen_cube = np.stack([
            counts.astype(np.int64),
            _bincount_i64(flat, np.asarray(dec["size"], np.int64), k,
                          counts),
            _bincount_i64(flat, np.asarray(dec["blocks"], np.int64), k,
                          counts)]).reshape(3, b, S, A)
        flips = stamps + _FLIP_EDGES[new_ab]
        finite = np.isfinite(flips)
        group.frozen_min_flip = float(flips[finite].min()) \
            if finite.any() else np.inf
        group.frozen_ref = now
        group.sstack_ref = np.nan           # AB row of the stack is stale
        return int((new_ab != old_ab).sum())

    def _frozen_total(self) -> np.ndarray:
        """Sum of every demoted group's frozen partial, padded to the
        current ``_cube_bp`` group capacity. Lock held."""
        from .profiles import A, S
        out = np.zeros((3, self._cube_bp, S, A), np.int64)
        for group in self._groups:
            fz = group.frozen_cube
            if group.resident or fz is None:
                continue
            out[:, : fz.shape[1]] += fz
        return out

    def _commit_demote(self, group: _ShardGroup, seg: PackedSegment,
                       repack: bool = False) -> None:
        """Install a packed segment and drop the group's host mirrors; the
        next refresh frees its slices of the card's tensors (this may run
        on a demote worker: it touches no CUDA tensor). Lock held."""
        group.segment = seg
        group.sstack = group.svis = group.sspaths = None
        group.sstack_ref = np.nan
        group.svis_ver = -1
        if self._plane_cube:
            self._freeze_cube(group)
        group.resident = False
        group.uploaded = False
        group.pending_demote = False
        group.packed = False
        self._cube_cache = None
        # host mirrors dropped: the packed segment IS the warm copy
        group.fids = np.zeros(0, np.int64)
        group.cols = {}
        group._order = None
        group.paths = group.spaths = group.ord = None
        group.cgid = group.csb = group.cab = group.cflip = None
        group.cmin_flip = np.inf
        group.vis = None
        # deliberately NOT an epoch bump: the commit is content-preserving
        # (version-revalidated against the catalog), and in-flight
        # MeshMatch handles hold their own mirror-array references — an
        # async commit landing between match() and plan() must not stale
        # them
        if repack:
            self.segment_repacks += 1
        else:
            self.demotions += 1

    def _demote(self, group: _ShardGroup) -> None:
        """Demote a resident group to a packed warm segment. With
        ``demote_async`` the encode runs on a worker thread against its
        own catalog snapshot (the group keeps serving resident); the
        commit re-validates versions under the lock and discards the pack
        if the group churned meanwhile. Lock held."""
        if not self.demote_async:
            self._commit_demote(group, self._pack_segment(group))
            return
        group.pending_demote = True

        def worker() -> None:
            shadow = _ShardGroup(group.gid, group.shard_ids)
            with self._lock:
                if not (group.pending_demote and group.resident):
                    return
            # snapshot + encode WITHOUT the store lock (queries keep
            # serving the still-resident blocks meanwhile); host work only
            self._host_refresh(shadow)
            seg = self._pack_segment_from(shadow)
            with self._lock:
                if (group.pending_demote and group.resident
                        and not group.dirty and not group.structural
                        and self._shard_versions(group) == shadow.versions):
                    # adopt the shadow's fresh mirrors so _freeze_cube
                    # inside the commit reads consistent state
                    for slot in ("fids", "cols", "rows", "versions",
                                 "offsets", "paths", "spaths", "ord",
                                 "cgid", "csb", "cab", "cflip",
                                 "cmin_flip"):
                        setattr(group, slot, getattr(shadow, slot))
                    self._commit_demote(group, seg)
                else:
                    group.pending_demote = False
                    self.demote_races += 1

        t = threading.Thread(target=worker, daemon=True)
        self._demote_workers.append(t)
        t.start()

    def _reap_demote_workers(self) -> None:
        self._demote_workers = [t for t in self._demote_workers
                                if t.is_alive()]

    def drain_demotions(self, timeout: Optional[float] = None) -> None:
        """Join any in-flight async demotions (tests / shutdown). Must be
        called WITHOUT the store lock held."""
        for t in list(self._demote_workers):
            t.join(timeout)
        with self._lock:
            self._reap_demote_workers()

    def _promote(self, group: _ShardGroup) -> None:
        """Bring a demoted group back resident: decode the segment into
        host mirrors (exact round trip — no catalog re-read when the
        segment is fresh) and let the refresh loop stage the block.
        Lock held."""
        seg = group.segment
        if seg is not None and self._seg_fresh(group):
            dec = seg.columns()
            group.fids = np.asarray(dec["fid"], np.int64)
            # mirrors must be writable (delta refresh patches in place);
            # decoded arrays may be read-only mmap views, so copy
            group.cols = {n: np.array(dec[n]) for n in PLAN_COLUMNS}
            group.rows = int(group.fids.size)
            group._order = None
            if self._plane_reports:
                parr = np.asarray(dec["path"])
                group.paths = parr.tolist()
                group.ord = np.asarray(dec["ord"], np.int64)
                sp = np.empty_like(parr)
                sp[group.ord] = parr
                group.spaths = sp
            if self._plane_cube:
                from .profiles import _FLIP_EDGES, age_buckets_np
                group.cgid = np.asarray(dec["cgid"], np.int64)
                group.csb = np.asarray(dec["csb"], np.int64)
                stamps = np.asarray(dec["atime"], np.float64)
                group.cab = age_buckets_np(self._cube_ref - stamps)
                group.cflip = stamps + _FLIP_EDGES[group.cab]
                finite = np.isfinite(group.cflip)
                group.cmin_flip = float(group.cflip[finite].min()) \
                    if finite.any() else np.inf
        # else: stale/absent segment — mirrors stay empty and the refresh
        # loop takes the full snapshot+upload path
        group.segment = None
        group.sstack = group.svis = group.sspaths = None
        group.frozen_cube = None
        group.frozen_min_flip = np.inf
        group.resident = True
        group.uploaded = False
        group.pending_demote = False
        group.packed = False
        if self._plane_cube:
            self._cube_stale = True         # its partial must rebuild
            self._cube_cache = None
        self._epoch += 1
        self.promotions += 1

    def tiering_counters(self) -> Dict[str, int]:
        """Snapshot of the tiering counters (surfaced per run in
        :attr:`RunReport.tiering`)."""
        with self._lock:
            return {
                "demotions": self.demotions,
                "promotions": self.promotions,
                "segments_streamed": self.segments_streamed,
                "windows_streamed": self.windows_streamed,
                "window_stalls": self.window_stalls,
                "segment_repacks": self.segment_repacks,
                "demote_races": self.demote_races,
                "device_pads": self.device_pads,
                "resident_groups": sum(g.resident for g in self._groups),
                "demoted_groups": sum(not g.resident
                                      for g in self._groups),
            }

    # -- warm-segment streaming ------------------------------------------------
    def _segment_stack(self, group: _ShardGroup) -> np.ndarray:
        """(block rows, n) f32 staging stack decoded from the group's warm
        segment — the streaming analogue of :meth:`_stack_f32`, cached on
        the group until the segment repacks. The age-bucket row
        re-derives (from the exact float64 stamps) whenever the cube
        reference moved, so streamed windows carry the same AB codes the
        resident blocks do. Lock held."""
        dec = group.segment.columns()
        if group.sstack is None:
            n = int(group.segment.n_rows)
            out = np.zeros((self._block_rows(), n), np.float32)
            for i, name in enumerate(KERNEL_COLUMNS):
                out[i] = dec[name]
            out[_VALID_COL] = 1.0
            if self._plane_reports:
                out[_ORD_COL] = dec["ord"]
            if self._plane_cube:
                out[_GID_COL] = dec["cgid"]
                out[_SB_COL] = dec["csb"]
            group.sstack = out
            group.sstack_ref = np.nan       # AB row filled below
        if self._plane_cube and group.sstack_ref != self._cube_ref:
            from .profiles import age_buckets_np
            stamps = np.asarray(dec["atime"], np.float64)
            group.sstack[_AB_COL] = age_buckets_np(self._cube_ref - stamps)
            group.sstack_ref = self._cube_ref
        return group.sstack

    def _segment_spaths(self, group: _ShardGroup) -> np.ndarray:
        """Sorted path mirror of a demoted group (du rank bounds, subtree
        grants) — decoded once per segment."""
        if group.sspaths is None:
            group.sspaths = np.sort(
                np.asarray(group.segment.decode("path")), kind="stable")
        return group.sspaths

    def _segment_vis(self, group: _ShardGroup) -> np.ndarray:
        """(Sp, n) bool subject visibility over a demoted group's rows,
        cached per grants version — the host source the streamed
        permission windows pack from. Lock held, after
        :meth:`_ensure_perms` (sizes ``_perm_sp``)."""
        if (group.svis is not None
                and group.svis_ver == self._grants.version
                and group.svis.shape[0] == self._perm_sp):
            return group.svis
        dec = group.segment.columns()
        group.svis = self._vis_rows(
            self._segment_spaths(group),
            np.asarray(dec["owner"], np.int64),
            np.asarray(dec["group"], np.int64),
            np.asarray(dec["ord"], np.int64))
        group.svis_ver = self._grants.version
        return group.svis

    def _stage_window(self, stack: np.ndarray, vis: Optional[np.ndarray],
                      base: int, nrows: int, buf: np.ndarray,
                      pbuf: Optional[np.ndarray]) -> None:
        """Write rows ``[base, base + nrows)`` of a demoted group into the
        (block rows, D·Rw) host staging buffer ``buf`` (rows past
        ``nrows`` zeroed: they read ``valid = 0``) and, for a scoped
        query, their visibility packed into the (Sp, D·Rw/32) int32
        buffer ``pbuf`` (bit b of word w = window row w*32+b, LSB first;
        rows past ``nrows`` pack to 0 — invisible). ``np.copyto`` writes
        into the buffer's own memory: read-only mmap decodes are copied,
        never wrapped."""
        np.copyto(buf[:, :nrows], stack[:, base:base + nrows])
        buf[:, nrows:] = 0.0
        if pbuf is not None:
            sub = np.zeros((self._perm_sp, buf.shape[1]), dtype=bool)
            sub[:, :nrows] = vis[:, base:base + nrows]
            np.copyto(pbuf, np.packbits(sub, axis=1, bitorder="little")
                      .view(np.int32))

    def _pinned_pair(self, shape: Tuple[int, int], dtype) -> list:
        """Two pinned host staging buffers of ``shape``, kept on the store
        between sweeps (pinning is slow) and replaced when the window's
        shape changes."""
        key = (shape, dtype)
        if key not in self._staging:
            self._staging = {k: v for k, v in self._staging.items()
                             if k[1] != dtype}
            self._staging[key] = [torch.empty(shape, dtype=dtype,
                                              pin_memory=True)
                                  for _ in range(2)]
        return self._staging[key]

    def _copy_window(self, side, host, dev, phost, pdev, free) -> None:
        """Enqueue the host→device copies of one window on the side
        stream ``side``, after the event ``free`` (the last launch that
        read these device buffers) when there is one."""
        with torch.cuda.stream(side):
            if free is not None:
                side.wait_event(free)
            dev.copy_(host, non_blocking=True)
            if pdev is not None:
                pdev.copy_(phost, non_blocking=True)

    def _stream_windows(self, group: _ShardGroup, launch, want_perm: bool):
        """Drive one demoted group's packed segment through the
        double-buffered streaming window.

        The segment decodes into the cached f32 row stack, which goes up
        in windows of ``D·Rw`` rows: the window at ``base`` is a ``(1,
        block rows, D·Rw)`` tensor holding the group's rows ``[base, base
        + D·Rw)`` in order. ``launch(window, perm_window)`` returns
        tensor(s) (``perm_window`` the ``(1, Sp, D·Rw/32)`` int32 words
        when ``want_perm``, else None); yields ``(base, nrows, result)``
        in row order, consumed one window behind. Lock held for the whole
        sweep (same discipline as match).

        On the card: two pinned staging buffers and two device window
        buffers; window k's copy runs on a side stream after window k-2's
        launch finished with its device buffer, window k's launch waits on
        its copy's event, and staging buffer k % 2 is rewritten only after
        window k-2's copy completed. On the CPU the staging buffer is the
        window itself: no stream, no pinning.
        """
        D = self.n_groups
        chunk = D * self._window_rows()
        stack = self._segment_stack(group)
        n = stack.shape[1]
        if not n:
            return
        br = self._block_rows()
        vis = self._segment_vis(group) if want_perm else None
        self.segments_streamed += 1
        card = self.device.type == "cuda"
        trace, labels = self.telemetry.trace, self._tlabels
        if card:
            host = self._pinned_pair((br, chunk), torch.float32)
            phost = self._pinned_pair((self._perm_sp, chunk // 32),
                                      torch.int32) \
                if want_perm else [None, None]
            dev = [torch.empty((1, br, chunk), dtype=torch.float32,
                               device=self.device) for _ in range(2)]
            pdev = [torch.empty((1, self._perm_sp, chunk // 32),
                                dtype=torch.int32, device=self.device)
                    for _ in range(2)] if want_perm else [None, None]
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            side = self._copy_stream
            cur = torch.cuda.current_stream(self.device)
            # the window buffers were allocated on the current stream:
            # their memory may still be read by its earlier work, and the
            # side stream writes them, so it starts after that work and the
            # allocator holds them until the side stream is done
            side.wait_stream(cur)
            for t in dev + pdev:
                if t is not None:
                    t.record_stream(side)
            copied = [None, None]           # event: copy out of staging j
            computed = [None, None]         # event: launch that read dev j
        else:
            host = [np.empty((br, chunk), np.float32) for _ in range(2)]
            phost = [np.empty((self._perm_sp, chunk // 32), np.int32)
                     for _ in range(2)] if want_perm else [None, None]
        pending = None
        try:
            for k, base in enumerate(range(0, n, chunk)):
                nrows = min(chunk, n - base)
                j = k % 2
                with trace("store.window.stage", **labels):
                    if card:
                        if copied[j] is not None:
                            copied[j].synchronize()
                        buf = host[j].numpy()
                        pbuf = phost[j].numpy() if want_perm else None
                    else:
                        buf, pbuf = host[j], phost[j]
                    self._stage_window(stack, vis, base, nrows, buf, pbuf)
                with trace("store.window.copy", **labels):
                    if card:
                        self._copy_window(
                            side, host[j], dev[j][0], phost[j],
                            pdev[j][0] if want_perm else None, computed[j])
                        copied[j] = torch.cuda.Event()
                        copied[j].record(side)
                        cur.wait_event(copied[j])
                        win, pwin = dev[j], pdev[j]
                    else:
                        win = torch.from_numpy(buf)[None]
                        pwin = torch.from_numpy(pbuf)[None] \
                            if want_perm else None
                with trace("store.window.launch", **labels):
                    res = launch(win, pwin)
                    done = None
                    if card:
                        done = computed[j] = torch.cuda.Event()
                        done.record(cur)
                self.windows_streamed += 1
                self._bytes_moved("window", buf.nbytes)
                if pending is not None:
                    yield self._consume_window(pending)
                pending = (base, nrows, res, done)
            if pending is not None:
                yield self._consume_window(pending)
        finally:
            if card:
                # the pinned buffers outlive the sweep: no copy out of
                # them may still be in flight when the next sweep writes
                for ev in copied:
                    if ev is not None:
                        ev.synchronize()

    def _consume_window(self, pending):
        base, nrows, res, done = pending
        if done is not None and not done.query():
            # the overlapped copy did not hide this window's compute: the
            # consumer blocks on it; the wait is timed so the stall shows
            # in the telemetry export, not just as a count
            self.window_stalls += 1
            t0 = time.perf_counter()
            done.synchronize()
            self.telemetry.histogram(
                "store_window_stall_seconds",
                help="streaming-window consume blocked on compute",
                **self._tlabels).observe(time.perf_counter() - t0)
        return base, nrows, res

    def _group_paths(self, group: _ShardGroup):
        """Row-aligned paths: the host mirror list for a resident group,
        the cached segment decode for a demoted one."""
        if group.resident:
            return group.paths
        return group.segment.decode("path")

    def _group_arrays(self, group: _ShardGroup):
        """(fids, columns, row-aligned paths) for result gathering —
        host mirrors resident, cached segment decode demoted."""
        if group.resident:
            return group.fids, group.cols, group.paths
        dec = group.segment.columns()
        return np.asarray(dec["fid"], np.int64), dec, dec.get("path")

    # -- permissions plane (per-subject packed visibility bitsets) -------------
    def _require_permissions_plane(self) -> None:
        if not self._plane_perm:
            raise PolicyError(
                "permissions plane not enabled "
                "(DeviceColumnStore.enable_permissions_plane)")

    def _subject_id(self, subject: str) -> int:
        # unknown subjects raise KeyError, NOT PolicyError: a host
        # fallback would fail identically, so degrading serves nothing
        return int(self._grants.subject_id(subject))

    def _vis_rows(self, spaths: Optional[np.ndarray], owner: np.ndarray,
                  grp: np.ndarray, rank: np.ndarray) -> np.ndarray:
        """(Sp, k) bool visibility of k group rows (given the group's
        sorted path mirror, the rows' interned owner/group codes and
        sorted-path ranks) for every registered subject — rows past the
        registry stay all-False pad. Mirrors
        :meth:`GrantTable.visible_mask` exactly: ownership via code
        membership, subtrees via the same rank-range searches ``du``
        uses on the sorted-path mirror. Lock held."""
        strings = self.catalog.strings
        subjects = self._grants.subjects()
        out = np.zeros((self._perm_sp, owner.size), dtype=bool)
        sp = spaths if spaths is not None else np.zeros(0, dtype="<U1")
        for sid, s in enumerate(subjects):
            v = out[sid]
            ocodes = [c for c in (strings.code_of(u) for u in s.owners)
                      if c is not None]
            if ocodes:
                v |= np.isin(owner, ocodes)
            gcodes = [c for c in (strings.code_of(g) for g in s.groups)
                      if c is not None]
            if gcodes:
                v |= np.isin(grp, gcodes)
            for pref in s.subtrees:
                lo = np.searchsorted(sp, pref + "/", side="left")
                hi = np.searchsorted(sp, pref + "0", side="left")
                lo2 = np.searchsorted(sp, pref, side="left")
                hi2 = np.searchsorted(sp, pref, side="right")
                v |= ((rank >= lo) & (rank < hi)) \
                    | ((rank >= lo2) & (rank < hi2))
        return out

    def _pack_group(self, group: _ShardGroup) -> np.ndarray:
        """Pack a group's full (Sp, rows) visibility into the (Sp, Rp/32)
        uint32 bit layout: bit b of word w (LSB first) = local row
        w*32+b; pad rows read 0 (invisible, like the validity row)."""
        full = np.zeros((self._perm_sp, self._rp), dtype=bool)
        if group.rows:
            full[:, : group.rows] = group.vis
        return np.packbits(full, axis=1,
                           bitorder="little").view(np.uint32)

    def _pack_words(self, group: _ShardGroup,
                    words: np.ndarray) -> np.ndarray:
        """(Sp, k) packed uint32 values of k whole words re-read from the
        group's visibility mirror (rows past ``group.rows`` pack to 0) —
        the warm-scatter payload after a dirty-row visibility change."""
        rows = (words[:, None] * 32 + np.arange(32)).reshape(-1)
        sub = np.zeros((self._perm_sp, rows.size), dtype=bool)
        inside = rows < group.rows
        sub[:, inside] = group.vis[:, rows[inside]]
        return np.packbits(sub, axis=1, bitorder="little").view(np.uint32)

    def _ensure_perms(self) -> None:
        """Materialize / refresh the resident bitsets. Lock held; call
        AFTER :meth:`refresh` (full uploads invalidate group bitsets).
        Any :attr:`GrantTable.version` tick or subject-capacity overflow
        re-materializes every group; otherwise only groups whose bitset
        was invalidated (structural churn, re-pad) rebuild. The words go
        up as int32 (the same bits; the kernels read them as u32)."""
        g = self._grants
        if (g.version != self._grants_version or self._perm_buf is None
                or len(g) > self._perm_sp):
            # subject axis padded like the group axis of the cube plane:
            # headroom + a multiple of 8, so new subjects keep landing
            # without an immediate re-materialization
            self._perm_sp = max(
                -(-int(max(len(g), 1) * self.headroom) // 8) * 8, 8)
            self._grants_version = g.version
            self._perm_buf = None
            for group in self._groups:
                group.vis = None
                group.svis = None          # streaming bitsets stale too
                group.svis_ver = -1
        res = self._resident()
        if (self._perm_buf is None or self._perm_buf.shape[2] * 32 != self._rp
                or self._perm_buf.shape[0] != len(res)):
            # (re)allocated at the block's row capacity, one slice a
            # resident group: every group packs
            self._perm_buf = torch.zeros(
                (len(res), self._perm_sp, self._rp // 32),
                dtype=torch.int32, device=self.device)
            for group in self._groups:
                group.packed = False
        changed = False
        for group in res:                  # demoted: _segment_vis on demand
            if group.vis is not None and group.packed:
                continue
            if group.rows:
                owner = np.asarray(group.cols["owner"], np.int64)
                grp = np.asarray(group.cols["group"], np.int64)
                rank = group.ord
            else:
                owner = grp = np.zeros(0, np.int64)
                rank = np.zeros(0, np.int64)
            group.vis = self._vis_rows(group.spaths, owner, grp, rank)
            self._perm_buf[self._slots[group.gid]].copy_(torch.from_numpy(
                self._pack_group(group).view(np.int32)))
            group.packed = True
            self.perm_materializations += 1
            changed = True
        if changed:
            self._epoch += 1

    def _resolve_subject(self, subject: Optional[str]) -> Optional[int]:
        """Subject id for a scoped query (None unscoped), materializing
        the resident bitsets. Lock held, AFTER refresh()."""
        if subject is None:
            return None
        self._require_permissions_plane()
        self._ensure_perms()
        return self._subject_id(subject)

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
        CPU. ``subject=`` ANDs that subject's permission bitset into the
        match (permissions plane required; on the card one launch of the
        scoped store form)."""
        # the lock is held for the WHOLE match (launch and readback): a
        # concurrent refresh would rewrite the resident blocks under the
        # in-flight launch and mutate the host mirrors this match
        # translates through — concurrent matches serialize instead
        with self._lock, \
                self.telemetry.trace("store.match", **self._tlabels) as _sp:
            m = self._match_locked(exprs, now, use_kernel, with_agg,
                                   subject)
            _sp.annotate(rows_revaluated=m.reval,
                         scoped=subject is not None)
            return m

    def _match_locked(self, exprs: Sequence, now: float,
                      use_kernel: Optional[bool], with_agg: bool,
                      subject: Optional[str] = None) -> MeshMatch:
        from ..kernels.policy_scan.ops import (_agg_dict, _program_tuples,
                                               merge_agg_partials,
                                               mesh_policy_scan_batch)
        ops, colidx, operands = compile_programs(exprs, self.catalog.strings,
                                                 now)
        ops_t, colidx_t = _program_tuples(ops, colidx)
        self.refresh()
        sid = self._resolve_subject(subject)
        kw = dict(ops_t=ops_t, colidx_t=colidx_t,
                  size_col=KERNEL_COLUMNS.index("size"),
                  blocks_col=KERNEL_COLUMNS.index("blocks"),
                  valid_col=_VALID_COL, with_agg=with_agg,
                  use_kernel=use_kernel)
        operands_t = torch.from_numpy(operands).to(self.device)
        res = self._resident()
        mirrors: List[Tuple[np.ndarray, Dict[str, np.ndarray]]] = \
            [(np.zeros(0, np.int64), {})] * self.n_groups
        group_idx = [np.zeros(0, np.int64)] * self.n_groups
        group_rule = [np.zeros(0, np.int32)] * self.n_groups
        agg_parts = []
        reval = 0
        if res:
            with self.telemetry.trace("store.match.launch",
                                      groups=len(res), **self._tlabels):
                mask, rule, agg = mesh_policy_scan_batch(
                    self._buf, operands_t,
                    perm=self._perm_buf if sid is not None else None,
                    subject=sid, **kw)
            # only mask + attribution cross device→host, never the columns
            with self.telemetry.trace("store.match.combine",
                                      **self._tlabels):
                mask_np = mask.cpu().numpy()
                rule_np = rule.cpu().numpy()
                agg_parts.append(agg.cpu().numpy())
            for i, g in enumerate(res):
                idx = np.nonzero(mask_np[i, : g.rows] > 0.5)[0]
                mirrors[g.gid] = (g.fids, g.cols)
                group_idx[g.gid] = idx
                group_rule[g.gid] = rule_np[i, idx].astype(np.int32)
                reval += g.rows

        def launch(win, pwin):
            return mesh_policy_scan_batch(
                win, operands_t, perm=pwin,
                subject=sid if pwin is not None else None, **kw)
        for g in self._demoted():
            idx_parts, rule_parts = [], []
            for base, nrows, (mask, rule, agg) in self._stream_windows(
                    g, launch, want_perm=sid is not None):
                m = mask.cpu().numpy().reshape(-1)[:nrows]
                r = rule.cpu().numpy().reshape(-1)[:nrows]
                hit = np.nonzero(m > 0.5)[0]
                idx_parts.append(base + hit)
                rule_parts.append(r[hit].astype(np.int32))
                if with_agg:
                    agg_parts.append(agg.cpu().numpy())
            dec = g.segment.columns()
            mirrors[g.gid] = (np.asarray(dec["fid"], np.int64),
                              {n: dec[n] for n in PLAN_COLUMNS})
            group_idx[g.gid] = (np.concatenate(idx_parts) if idx_parts
                                else np.zeros(0, np.int64))
            group_rule[g.gid] = (np.concatenate(rule_parts) if rule_parts
                                 else np.zeros(0, np.int32))
            reval += int(g.segment.n_rows)
        per_rule = merge_agg_partials(agg_parts, len(ops_t))
        return MeshMatch(self, self._epoch, mirrors, group_idx, group_rule,
                         _agg_dict(per_rule[0], per_rule), reval)

    def scan(self, expr, now: float, use_kernel: Optional[bool] = None,
             subject: Optional[str] = None) -> Tuple[np.ndarray, dict]:
        """Single-expression scan: (matching fids, aggregate dict) — the
        device-resident analogue of ``ops.scan_catalog``; ``subject=``
        scopes it as :meth:`match` does."""
        match = self.match([expr], now, use_kernel=use_kernel,
                           subject=subject)
        fids, _sizes, _sort, _ridx = match.plan("size")
        return fids, match.agg

    # -- resident profile cube -------------------------------------------------
    def _advance_cube_ref(self, now: float,
                          update_partials: bool = True) -> int:
        """Advance the age reference: re-bucket only the rows whose next
        flip instant passed (block ``_AB_COL`` scatter + mirror update;
        when the partials are live, a signed cube move too). Mirrors
        ``core.profiles._ShardCube.sweep``. Lock held."""
        if now <= self._cube_ref:
            return 0
        from .profiles import _FLIP_EDGES, age_buckets_np
        moved = 0
        for group in self._groups:
            if not group.rows or group.cflip is None \
                    or group.cmin_flip > now:
                continue
            due = np.nonzero(group.cflip <= now)[0]
            if due.size:
                stamps = np.asarray(group.cols["atime"][due], np.float64)
                new_ab = age_buckets_np(now - stamps)
                if update_partials and self._cube_partials is not None \
                        and not self._cube_stale:
                    gid, sb = group.cgid[due], group.csb[due]
                    ones = np.ones(due.size, np.float32)
                    size = np.asarray(group.cols["size"][due], np.float32)
                    blocks = np.asarray(group.cols["blocks"][due],
                                        np.float32)
                    self._cube_scatter(
                        group, np.concatenate([
                            self._cells(gid, sb, group.cab[due]),
                            self._cells(gid, sb, new_ab)]),
                        np.stack([np.concatenate([-ones, ones]),
                                  np.concatenate([-size, size]),
                                  np.concatenate([-blocks, blocks])]))
                group.cab[due] = new_ab
                group.cflip[due] = stamps + _FLIP_EDGES[new_ab]
                # the new age buckets into the resident block, so a later
                # full cube rebuild reads current codes
                self._scatter_row(group, _AB_COL, due, new_ab)
                moved += int(due.size)
            finite = np.isfinite(group.cflip)
            group.cmin_flip = float(group.cflip[finite].min()) \
                if finite.any() else np.inf
        self._cube_ref = now
        self.rollovers += moved
        return moved

    def _cube_capacity(self) -> int:
        # group-axis capacity: headroom, rounded up to a multiple of 8, so
        # newly minted groups keep scatter-adding without a rebuild
        b = max(len(self._cube_groups), 1)
        return max(-(-int(b * self.headroom) // 8) * 8, 8)

    def _rebuild_cube(self, now: float) -> None:
        """Cold/fallback path: ``mesh_profile_cube`` rebuilds every group's
        partial from its block (one ``profile_cube`` launch a group on the
        card). Lock held; blocks must be fresh (call after
        :meth:`refresh`)."""
        from ..kernels.profile_cube.ops import mesh_profile_cube
        self._advance_cube_ref(now, update_partials=False)
        self._cube_bp = self._cube_capacity()
        partials, combined = mesh_profile_cube(
            self._buf, n_groups=self._cube_bp, gid_col=_GID_COL,
            size_col=KERNEL_COLUMNS.index("size"),
            blocks_col=KERNEL_COLUMNS.index("blocks"), sb_col=_SB_COL,
            ab_col=_AB_COL, valid_col=_VALID_COL)
        self._cube_partials = partials
        self._cube_cache = np.rint(combined.cpu().numpy()).astype(np.int64)
        self._cube_stale = False
        self.cube_rebuilds += 1

    def _ensure_cube(self, now: float) -> None:
        if self._resident():
            if (self._cube_partials is None or self._cube_stale
                    or len(self._cube_groups) > self._cube_bp):
                self._rebuild_cube(now)
            else:
                self._advance_cube_ref(now, update_partials=True)
        else:
            # nothing resident: only the frozen partials and streamed
            # windows serve, but the reference still advances so their
            # age buckets stay exact as of ``now``
            if self._cube_bp < len(self._cube_groups) \
                    or self._cube_bp == 0:
                self._cube_bp = self._cube_capacity()
            self._advance_cube_ref(now, update_partials=False)
        # demoted partials whose first scheduled age flip passed refreeze
        # from their segments at the advanced reference
        for g in self._demoted():
            if g.frozen_cube is not None \
                    and g.frozen_min_flip <= self._cube_ref:
                self.rollovers += self._refreeze(g, self._cube_ref)

    def invalidate_cube(self) -> None:
        """Force a full cube rebuild on the next query (the store-backed
        analogue of ``ProfileCube.rebuild``)."""
        with self._lock:
            self._cube_stale = True
            self._cube_cache = None

    def analytics_cube(self, now: Optional[float] = None,
                       subject: Optional[str] = None) -> np.ndarray:
        """Merged (N_MEASURES, B, S, A) int64 cube as of ``now``, served
        from the resident partials: refresh scatters churned rows, due
        age rollovers move on the device, and only the summed cube
        crosses to the host. ``subject=`` bins only rows that subject may
        see — one :func:`mesh_scoped_cube` build over the resident tensor
        and bitsets (one scoped ``profile_cube`` launch a group on the
        card; no resident scoped partials: the rollover advance above
        keeps the block's age codes exact as of ``now``, so the scoped
        cube matches the host oracle).

        Under tiering, demoted groups contribute without re-residency: the
        unscoped cube adds their exact int64 frozen partials (refrozen
        from the segment when an age flip passed); a scoped cube streams
        their windows through :func:`mesh_scoped_cube` (one scoped launch
        a window on the card) and sums the window cubes with the resident
        one in f64 on the device."""
        from ..kernels.profile_cube.ops import (mesh_cube_combine,
                                                mesh_scoped_cube)
        from ..kernels.profile_cube.ref import (A_BUCKETS, N_MEASURES,
                                                S_BUCKETS)
        with self._lock:
            if not self._plane_cube:
                raise PolicyError("cube plane not enabled "
                                  "(DeviceColumnStore.enable_cube_plane)")
            now = float(self._cube_clock()) if now is None else float(now)
            self.refresh()
            self._ensure_cube(now)
            self.store_queries += 1
            res = self._resident()
            demoted = self._demoted()
            shape = (N_MEASURES, self._cube_bp, S_BUCKETS, A_BUCKETS)
            b = min(len(self._cube_groups), self._cube_bp)
            if subject is not None:
                sid = self._resolve_subject(subject)
                kw = dict(n_groups=self._cube_bp, gid_col=_GID_COL,
                          size_col=KERNEL_COLUMNS.index("size"),
                          blocks_col=KERNEL_COLUMNS.index("blocks"),
                          sb_col=_SB_COL, ab_col=_AB_COL,
                          valid_col=_VALID_COL)
                total = torch.zeros(shape, dtype=torch.float64,
                                    device=self.device)
                if res:
                    total += mesh_scoped_cube(self._buf, self._perm_buf, sid,
                                              **kw)

                def launch(win, pwin):
                    return mesh_scoped_cube(win, pwin, sid, **kw)
                for g in demoted:
                    for _b, _n, cube in self._stream_windows(g, launch,
                                                             True):
                        total += cube
                return np.rint(total.cpu().numpy()).astype(np.int64)[:, :b]
            if res and self._cube_cache is None:
                combined = mesh_cube_combine(self._cube_partials)
                self._cube_cache = np.rint(combined.cpu().numpy()).astype(
                    np.int64).reshape(shape)
            cube = self._cube_cache if res else np.zeros(shape, np.int64)
            if any(g.frozen_cube is not None for g in demoted):
                cube = cube + self._frozen_total()
            return cube[:, :b]

    # -- resident report queries (rbh-find / top-N / rbh-du) -------------------
    def _require_reports_plane(self) -> None:
        if not self._plane_reports:
            raise PolicyError("reports plane not enabled "
                              "(DeviceColumnStore.enable_reports_plane)")

    def _arrays_positions(self, group: _ShardGroup,
                          idx: np.ndarray) -> np.ndarray:
        """Map group-local row indices to catalog ``arrays()`` positions
        (the host oracle's row order) for tie-exact result ordering."""
        counts = {}
        for g in self._groups:
            for p, sid in enumerate(g.shard_ids):
                counts[sid] = int(g.offsets[p + 1] - g.offsets[p])
        base = np.concatenate(
            [[0], np.cumsum([counts.get(s, 0)
                             for s in range(self.catalog.n_shards)])])
        seg = np.searchsorted(group.offsets, idx, side="right") - 1
        sids = np.asarray(group.shard_ids, np.int64)[seg]
        return base[sids] + (idx - group.offsets[seg])

    def find_paths(self, expr, now: float, limit: int = 0,
                   subject: Optional[str] = None) -> List[str]:
        """``rbh-find`` from the resident tensor: one lean store-form
        launch, then the winning rows translate to paths through the host
        path mirrors — emitted in catalog ``arrays()`` order
        (byte-identical to the host fold). Raises PolicyError on glob
        predicates (host fallback). ``subject=`` lists only rows that
        subject may see (one lean scoped launch). A demoted group's rows
        stream (one lean launch a window) and translate through its
        segment's decoded paths."""
        with self._lock:
            self._require_reports_plane()
            match = self._match_locked([expr], now, None, False, subject)
            self.store_queries += 1
            out: List[str] = []
            for sid in range(self.catalog.n_shards):
                group = self._groups[sid % self.n_groups]
                p = sid // self.n_groups
                lo = int(group.offsets[p])
                hi = int(group.offsets[p + 1])
                idx = match._group_idx[group.gid]
                seg = idx[(idx >= lo) & (idx < hi)]
                paths = self._group_paths(group)
                out.extend(str(paths[i]) for i in seg.tolist())
                if limit and len(out) >= limit:
                    return out[:limit]
            return out

    def top_files(self, by: str = "size", k: int = 10, desc: bool = True,
                  now: float = 0.0,
                  subject: Optional[str] = None) -> List[dict]:
        """Top-N listing from the resident tensor, two passes: the groups'
        top-k find the exact k-th-best value (the union of the groups'
        top-k contains the global top-k), then a threshold mask recovers
        every candidate, ties across groups included; the final order
        sorts candidates by native mirror values with the host oracle's
        exact tie semantics (stable argsort + reversal). ``now`` is not
        read (kernel columns hold no relative ages); ``subject=`` ranks
        only rows that subject may see (both passes). A demoted group's
        windows stream through both passes (each window's top-k joins the
        candidates)."""
        from ..kernels.policy_scan.ops import (mesh_column_topk,
                                               mesh_threshold_rows)
        from .types import FsType
        if by not in KERNEL_COLUMNS:
            raise PolicyError(f"top_files by {by!r} is not a kernel column")
        with self._lock:
            self._require_reports_plane()
            self.refresh()
            self.store_queries += 1
            res = self._resident()
            demoted = self._demoted()
            if k <= 0 or not (any(g.rows for g in res)
                              or any(g.segment.n_rows for g in demoted)):
                return []
            sid = self._resolve_subject(subject)
            want_perm = sid is not None
            kw = dict(col=KERNEL_COLUMNS.index(by), valid_col=_VALID_COL,
                      type_col=KERNEL_COLUMNS.index("type"),
                      file_code=float(int(FsType.FILE)))
            perm = self._perm_buf if want_perm else None
            # pass 1: each group's and each window's top-k; the global
            # top-k is a subset of their union, so the merged k-th best is
            # an exact selection threshold for pass 2
            cand_thr = []
            if res:
                vals, _idx = mesh_column_topk(
                    self._buf, k=min(k, self._rp), desc=desc, perm=perm,
                    subject=sid, **kw)
                cand_thr.append(vals.cpu().numpy().ravel())
            kwin = min(k, self.n_groups * self._window_rows())

            def launch_topk(win, pwin):
                return mesh_column_topk(
                    win, k=kwin, desc=desc, perm=pwin,
                    subject=sid if pwin is not None else None, **kw)
            for g in demoted:
                for _b, _n, (vals, _i) in self._stream_windows(
                        g, launch_topk, want_perm):
                    cand_thr.append(vals.cpu().numpy().ravel())
            merged = np.concatenate(cand_thr)
            merged = merged[np.isfinite(merged)]
            if merged.size == 0:
                return []
            merged.sort()                     # ascending
            kk = min(k, merged.size)
            thr = float(merged[-kk] if desc else merged[kk - 1])
            # pass 2: the threshold mask recovers every candidate, ties
            # across groups and windows included; only the rows of its
            # hits cross to the host
            cand_vals, cand_pos, cand_paths, cand_fids = [], [], [], []

            def collect(group, rows):
                fids, gcols, paths = self._group_arrays(group)
                cand_vals.append(np.asarray(gcols[by])[rows])
                cand_pos.append(self._arrays_positions(group, rows))
                cand_fids.append(np.asarray(fids)[rows])
                cand_paths.extend(str(paths[i]) for i in rows.tolist())

            if res:
                hits = torch.nonzero(mesh_threshold_rows(
                    self._buf, thr, ge=desc, perm=perm, subject=sid,
                    **kw)).cpu().numpy()
                for i, group in enumerate(res):
                    rows = hits[hits[:, 0] == i, 1]
                    if rows.size:
                        collect(group, rows)

            def launch_thr(win, pwin):
                return mesh_threshold_rows(
                    win, thr, ge=desc, perm=pwin,
                    subject=sid if pwin is not None else None, **kw)
            for g in demoted:
                parts = []
                for base, nrows, mask in self._stream_windows(
                        g, launch_thr, want_perm):
                    hit = np.nonzero(mask.cpu().numpy().reshape(-1)
                                     [:nrows])[0]
                    if hit.size:
                        parts.append(base + hit)
                if parts:
                    collect(g, np.concatenate(parts))
            if not cand_vals:
                return []
            values = np.concatenate(cand_vals)
            pos = np.concatenate(cand_pos)
            fids = np.concatenate(cand_fids)
            # host tie semantics: stable ascending argsort (ties by
            # arrays position), reversed wholesale for descending
            order = np.lexsort((pos, values))
            order = order[::-1][:kk] if desc else order[:kk]
            return [{"path": cand_paths[o], by: float(values[o]),
                     "fid": int(fids[o])} for o in order.tolist()]

    def du(self, path_prefix: str, subject: Optional[str] = None) -> dict:
        """``rbh-du -s`` from the resident tensor: two host binary searches
        a group into the sorted path mirror give rank bounds; one range
        aggregate on the device sums [count, files, volume, spc_used] over
        the groups — no row leaves the device. ``subject=`` counts only
        rows that subject may see. A demoted group streams: its windows'
        rows carry their rank in the GROUP's sorted-path order, so one
        bounds row serves every window."""
        from ..kernels.policy_scan.ops import mesh_range_aggregate
        from .types import FsType
        with self._lock:
            self._require_reports_plane()
            self.refresh()
            self.store_queries += 1
            sid = self._resolve_subject(subject)
            want_perm = sid is not None
            prefix = path_prefix.rstrip("/")

            def rank_bounds(sp):
                return (np.searchsorted(sp, prefix + "/", side="left"),
                        np.searchsorted(sp, prefix + "0", side="left"),
                        np.searchsorted(sp, prefix, side="left"),
                        np.searchsorted(sp, prefix, side="right"))

            kw = dict(ord_col=_ORD_COL,
                      type_col=KERNEL_COLUMNS.index("type"),
                      size_col=KERNEL_COLUMNS.index("size"),
                      blocks_col=KERNEL_COLUMNS.index("blocks"),
                      valid_col=_VALID_COL, file_code=float(int(FsType.FILE)))
            res = self._resident()
            total = np.zeros(4, np.float64)
            if res:
                bounds = np.zeros((len(res), 4), np.float32)
                for i, group in enumerate(res):
                    sp = group.spaths if group.spaths is not None \
                        else np.zeros(0, dtype="<U1")
                    bounds[i] = rank_bounds(sp)
                total += mesh_range_aggregate(
                    self._buf, bounds,
                    perm=self._perm_buf if want_perm else None,
                    subject=sid, **kw).cpu().numpy()
            for g in self._demoted():
                gb = np.asarray([rank_bounds(self._segment_spaths(g))],
                                np.float32)

                def launch(win, pwin):
                    return mesh_range_aggregate(
                        win, gb, perm=pwin,
                        subject=sid if pwin is not None else None, **kw)
                for _b, _n, agg in self._stream_windows(g, launch,
                                                        want_perm):
                    total += agg.cpu().numpy()
            return {"count": int(round(float(total[0]))),
                    "files": int(round(float(total[1]))),
                    "volume": int(round(float(total[2]))),
                    "spc_used": int(round(float(total[3])))}
