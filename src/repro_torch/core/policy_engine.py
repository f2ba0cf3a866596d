"""Generic policy engine (C5, C7, C10) — robinhood v3 plugin architecture.

A *policy* is: a **scope** (criteria restricting which entries it may ever
touch), ordered **rules** (criteria -> parameters), an **action** (plugin
callable), **triggers** (periodic / usage-watermark / manual), and run
options (sort order, rate limits, target volume/count).

This is the paper's v3 "generic policies": archive/purge/rmdir are just
shipped plugin configurations; users register custom actions the same way
(see ``plugins.py``). Watermark triggers reproduce the per-OST purge (C7):
when an OST exceeds ``high_wm``, the engine runs the policy restricted to
entries striped on that OST until usage is projected below ``low_wm``.

Execution is **columnar, batched and shard-parallel** (paper SII-B1: policy
runs over billions of entries must never degenerate into per-entry scans).
The hot path never constructs a per-entry Python object and never launches
more than one kernel per shard batch:

* **matching** goes through a pluggable evaluator backend — ``"numpy"``
  (vectorized column masks), ``"policy_scan"`` (the hand-written CUDA
  kernel on the engine's CUDA device, its plain PyTorch version when the
  engine runs on ``device="cpu"``) or ``"policy_scan_mesh"``
  (the same program batch evaluated data-parallel over a device-resident
  column store — see
  :meth:`PolicyEngine.attach_device_store`; no per-run host concat or
  host→device re-upload, stale shard groups refresh by delta scatter).
  The kernel backends evaluate the policy's whole (R, P) rule-program
  batch in a SINGLE launch (per device) that writes the (R, N) mask tile
  with first-match-wins rule **attribution** and per-rule size/blocks
  reductions fused on-device (the per-rule-launch path survives inside
  ``match_programs`` as a fallback and differential oracle). Evaluator
  downgrades (mesh without a store, glob predicates) are recorded on
  ``RunReport.fallback_reason`` so callers can assert the requested
  backend really ran;
* **budgets** (target volume / max actions) are planned on batch
  boundaries over the match-time column snapshot — no entry objects: the
  engine takes the minimal prefix of the sorted candidate list whose
  projected volume meets the remaining target, executes it, and only
  re-plans if failures left the target unmet. The actioned set is a pure
  function of the catalog snapshot — deterministic across ``n_threads``,
  with no overshoot races;
* **execution** draws work in fid chunks from a deque; under the default
  ``execution="columnar"`` each chunk is fetched as a
  :class:`~repro_torch.core.catalog.ColumnBatch` (one numeric column gather per
  shard group, lazy string decode, zero ``Entry.__init__``) and applied
  through the action's batch interface
  (``action.action_batch(batch, params) -> list[bool]``). ``Entry``
  objects are materialized ONLY for actions that declare
  ``needs_entries = True`` (their ``action_batch`` then receives
  ``List[Entry]``) and for scalar-only actions.

Two slower paths are kept so ``benchmarks/bench_policy.py`` can report the
speedups honestly: ``execution="batched"`` (the pre-columnar path — every
chunk materializes Entries via :meth:`Catalog.get_batch`, then batch
actions run off a ``ColumnBatch.from_entries`` shim so plugin code is
byte-identical across modes) and ``execution="scalar"`` (per-entry
catalog.get + Python rule re-evaluation).

Incremental match (paper SII-C: changelogs replace re-scans)
------------------------------------------------------------

Policy runs do not have to re-scan the catalog: once the engine is wired to
a delta source — :meth:`PolicyEngine.subscribe_pipeline` (the changelog
pipeline's post-commit fan-out), :meth:`PolicyEngine.subscribe_stream` /
:meth:`subscribe_hub` (a named changelog subscriber that trails the
pipeline's ack watermark), or explicit :meth:`mark_dirty` calls — it keeps
per-policy **incremental match state**:

* a **dirty-fid set** of entries touched since the last run;
* a cached **match table** (fid -> size, sort key, first-matching rule) for
  every entry currently satisfying ``scope AND any(rules)``;
* a **flip schedule** for age predicates (``last_access > 30d`` flips at
  ``atime + 30d`` with no delta arriving): per entry, the earliest future
  instant its match status can change through time alone.

An incremental run re-evaluates only ``dirty ∪ time-due`` rows — gathered
by fid via :meth:`Catalog.gather_rows`, no full-column snapshot — merges
the verdicts into the cached table, and plans/sorts/budgets from the table
exactly like a full run. Watermark ``extra_criteria`` are applied freshly
on top of the cached set each run (they can only restrict it). After a
non-dry run, actioned fids are marked dirty again so plugin-made catalog
mutations are re-observed.

Runs fall back to a **full columnar scan** when: (1) no state exists yet —
the first run (or any run after :meth:`invalidate`, e.g. on a changelog
cursor reset) scans fully and rebuilds the cache; (2) the policy uses
``==``/``!=`` comparisons on age attributes (no well-defined flip instant);
(3) the dirty set outgrew ``incremental_rescan_frac`` of the catalog, where
a scan is cheaper; (4) the caller forces ``matching="full"``. Every full
run with no extra criteria rebuilds the cache in passing. ``RunReport.mode``
records which path ran; correctness contract: all catalog mutations reach
the engine through a subscribed delta source (or ``mark_dirty``).

Incremental state **persists across restarts**: :meth:`save_incremental`
serializes every valid per-policy match table + age-flip schedule (plus any
undrained dirty fids) to a compressed npz beside the catalog's sqlite
mirror, keyed by a signature of each policy's criteria;
:meth:`load_incremental` restores the tables whose signatures still match,
so a restarted engine resumes incrementally instead of paying a cold full
scan. Pair it with a durable changelog subscriber name so deltas that
arrive while the engine is down are re-delivered on restart.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .catalog import Catalog, ColumnBatch
from .changelog import ChangelogHub, ChangelogStream
from .fidtable import FidTable as _FidTable
from .telemetry import slug
from .policy import (AGE_ATTRS, ALWAYS, Cmp, Expr, GLOB_ATTRS, PolicyError,
                     all_of, any_of, attribute_rules, iter_exprs, parse_expr)
from .types import Entry, FsType
from ..device import resolve_device

Action = Callable[[Entry, dict], bool]   # returns True on success
# Optional vectorized form, attached to the Action callable as the
# ``action_batch`` attribute: (batch, shared params) -> per-entry success.
# ``batch`` is a ColumnBatch unless the callable also sets
# ``needs_entries = True``, in which case the engine materializes and
# passes List[Entry] instead.
BatchAction = Callable[[ColumnBatch, dict], List[bool]]

EVALUATORS = ("numpy", "policy_scan", "policy_scan_mesh")
MATCHING_MODES = ("auto", "full", "incremental")
EXECUTION_MODES = ("columnar", "batched", "scalar")

_ENGINE_SEQ = [0]                 # per-process engine subscriber counter
_ENGINE_SEQ_LOCK = threading.Lock()


@dataclasses.dataclass
class Rule:
    name: str
    condition: Expr
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PolicyDefinition:
    name: str
    action: Action
    scope: Expr = dataclasses.field(default_factory=lambda: ALWAYS)
    rules: List[Rule] = dataclasses.field(default_factory=list)
    # run behaviour
    sort_by: str = "atime"          # LRU by default, like robinhood purge
    sort_desc: bool = False
    max_actions_per_run: int = 0    # 0 = unlimited
    max_volume_per_run: int = 0     # 0 = unlimited (bytes)
    n_threads: int = 1
    dry_run: bool = False
    batch_size: int = 512           # entries per execution chunk
    evaluator: str = "numpy"        # default matching backend
    # whether the action mutates entries (purge/archive/...): actioned fids
    # are then re-marked dirty so incremental state re-observes them. Pure
    # observer actions (tagging nothing, reporting) may set False to keep
    # the dirty set at true churn size.
    mutates: bool = True

    @classmethod
    def from_config(cls, name: str, action: Action, scope: str = "true",
                    rules: Optional[Sequence[Tuple[str, str, dict]]] = None,
                    **kw) -> "PolicyDefinition":
        """Build from string criteria — 'a few lines of configuration'."""
        pd = cls(name=name, action=action, scope=parse_expr(scope), **kw)
        for rname, cond, params in rules or []:
            pd.rules.append(Rule(rname, parse_expr(cond), params))
        return pd


@dataclasses.dataclass
class RunReport:
    policy: str
    matched: int = 0
    succeeded: int = 0
    failed: int = 0
    volume: int = 0          # bytes touched (e.g. freed / archived)
    elapsed: float = 0.0
    trigger: str = "manual"
    matched_volume: int = 0  # total bytes of all matched entries
    skipped: int = 0         # matched but gone from the catalog by exec time
    evaluator: str = "numpy"
    rounds: int = 0          # budget re-planning rounds executed
    mode: str = "full"       # matching path: "full" scan or "incremental"
    reval: int = 0           # rows (re-)evaluated to produce the match set
    execution: str = "columnar"   # execution path that applied the actions
    # why the run did NOT match on the evaluator that was requested ("" =
    # the requested backend ran): benchmarks/CI assert the kernel / mesh
    # path really executed instead of silently degrading to numpy
    fallback_reason: str = ""
    # tiered-residency activity during the mesh match (empty when the run
    # did not go through a device store): counter deltas for demotions /
    # promotions / segments_streamed / windows_streamed / window_stalls
    # etc., plus the absolute resident_groups / demoted_groups gauges —
    # bench_tiering asserts streaming really happened from these
    tiering: dict = dataclasses.field(default_factory=dict)
    # per-run telemetry (empty when the catalog's registry is disabled):
    # {"spans": nested span tree of the whole run — ingest/match/act
    # children, the device store's refresh/launch/combine spans nested
    # inside — "counters": registry counter deltas this run caused}
    telemetry: dict = dataclasses.field(default_factory=dict)


class UsageWatermarkTrigger:
    """Per-resource usage trigger (OST / pool / HBM page pool).

    ``usage_fn()`` returns a list of (resource_key, used, capacity); when
    ``used/capacity`` exceeds ``high_pct``, the policy runs with a target of
    freeing down to ``low_pct``, restricted by ``restrict_fn(resource_key)``.
    """

    def __init__(self, usage_fn: Callable[[], List[Tuple[object, int, int]]],
                 high_pct: float, low_pct: float,
                 restrict_fn: Callable[[object], Expr]) -> None:
        self.usage_fn = usage_fn
        self.high_pct = high_pct
        self.low_pct = low_pct
        self.restrict_fn = restrict_fn

    def check(self) -> List[Tuple[object, Expr, int]]:
        """Returns (resource, extra_criteria, bytes_to_free) per firing."""
        out = []
        for key, used, cap in self.usage_fn():
            if cap <= 0:
                continue
            if 100.0 * used / cap >= self.high_pct:
                target = used - int(cap * self.low_pct / 100.0)
                out.append((key, self.restrict_fn(key), target))
        return out


@dataclasses.dataclass
class _Plan:
    """One execution round: parallel arrays of planned work, sorted order."""
    fids: np.ndarray        # int64
    sizes: np.ndarray       # int64 (match-time snapshot, used for budgets)
    rule_idx: np.ndarray    # int32, -1 = no rule (empty params)


def _age_predicates(policy: PolicyDefinition
                    ) -> Tuple[List[Tuple[str, float]], bool]:
    """Collect (time_column, threshold_seconds) per age predicate in the
    policy's scope/rules; second result is False when a predicate has no
    well-defined flip instant (``==``/``!=`` on a continuous age)."""
    preds: Set[Tuple[str, float]] = set()
    supported = True
    for expr in [policy.scope] + [r.condition for r in policy.rules]:
        for node in iter_exprs(expr):
            if isinstance(node, Cmp) and node.attr in AGE_ATTRS:
                if node.op in ("==", "!="):
                    supported = False
                preds.add((AGE_ATTRS[node.attr], float(node.value)))
    return sorted(preds), supported


def _uses_globs(*exprs: Optional[Expr]) -> bool:
    return any(isinstance(node, Cmp) and node.attr in GLOB_ATTRS
               for expr in exprs if expr is not None
               for node in iter_exprs(expr))


def _next_flips(cols: Dict[str, np.ndarray],
                age_preds: List[Tuple[str, float]], now: float) -> np.ndarray:
    """Earliest future instant each row's age predicates change truth value.

    A predicate over ``time_col`` with threshold T flips exactly at
    ``time_col + T``; instants already past are spent. The boundary itself
    is kept (>= now) so strict comparisons that only become true just after
    the boundary are still re-evaluated on the next run. Rows with no
    future flip read +inf.
    """
    out = np.full(len(cols["fid"]), np.inf)
    for time_col, thr in age_preds:
        cand = np.asarray(cols[time_col], dtype=np.float64) + thr
        np.minimum(out, np.where(cand >= now, cand, np.inf), out=out)
    return out


class _IncrementalState:
    """Per-policy incremental match state (dirty set + cached match table).

    ``matched`` caches every fid satisfying ``scope AND any(rules)`` with
    its budget/sort/attribution columns; ``flips`` schedules time-driven
    re-evaluation for age predicates. ``touched`` collects delta fids
    between runs. All methods are thread-safe against delta fan-in."""

    def __init__(self, policy: PolicyDefinition) -> None:
        self.lock = threading.Lock()
        self.touched: Set[int] = set()
        self.valid = False
        self.sort_by = policy.sort_by
        self.matched = _FidTable((("size", np.int64), ("sort", np.float64),
                                  ("rule", np.int32)))
        self.flips = _FidTable((("flip", np.float64),))
        self.age_preds, self.supported = _age_predicates(policy)
        # string gather is only paid when a criteria holds a glob predicate
        self.needs_strings = _uses_globs(
            policy.scope, *(r.condition for r in policy.rules))
        self.full_rebuilds = 0

    def note_touched(self, fids: Iterable[int]) -> None:
        with self.lock:
            if self.valid:           # invalid state is rebuilt by a full scan
                self.touched.update(fids)

    def drain_touched(self) -> Set[int]:
        with self.lock:
            out, self.touched = self.touched, set()
            return out

    def touched_count(self) -> int:
        with self.lock:
            return len(self.touched)

    def invalidate(self) -> None:
        with self.lock:
            self.valid = False
            self.touched = set()

    def begin_rebuild(self) -> None:
        """Start accepting deltas for the full scan about to be snapshot.

        Called *before* the columnar snapshot: changes committed before the
        snapshot are covered by it, changes committed after will be
        re-delivered into ``touched`` — either way nothing is lost."""
        with self.lock:
            self.touched = set()
            self.valid = True

    def rebuild(self, cols: Dict[str, np.ndarray], mask: np.ndarray,
                rule_idx: np.ndarray, now: float) -> None:
        """Load the cached match table from a full columnar scan."""
        fids = cols["fid"][mask]
        self.matched.bulk_load(
            fids, size=cols["size"][mask],
            sort=np.asarray(cols[self.sort_by][mask], dtype=np.float64),
            rule=rule_idx[mask])
        if self.age_preds:
            flips = _next_flips(cols, self.age_preds, now)
            keep = np.isfinite(flips)
            self.flips.bulk_load(cols["fid"][keep], flip=flips[keep])
        else:
            self.flips.bulk_load(np.zeros(0, dtype=np.int64),
                                 flip=np.zeros(0))
        self.full_rebuilds += 1

    def rebuild_arrays(self, fids: np.ndarray, sizes: np.ndarray,
                       sorts: np.ndarray, rules: np.ndarray,
                       flip_fids: np.ndarray, flips: np.ndarray) -> None:
        """Load the cached match table from pre-extracted flat arrays —
        the mesh full scan's output (``MeshMatch.cache_arrays``), where
        the host columns were never materialized. Same postcondition as
        :meth:`rebuild`: table + flip schedule valid as of the scan."""
        self.matched.bulk_load(
            np.asarray(fids, dtype=np.int64),
            size=np.asarray(sizes, dtype=np.int64),
            sort=np.asarray(sorts, dtype=np.float64),
            rule=np.asarray(rules, dtype=np.int32))
        self.flips.bulk_load(np.asarray(flip_fids, dtype=np.int64),
                             flip=np.asarray(flips, dtype=np.float64))
        self.full_rebuilds += 1

    def due_flips(self, now: float) -> Set[int]:
        return set(self.flips.select_le("flip", now).tolist())

    def apply(self, fids: np.ndarray, cols: Dict[str, np.ndarray],
              present: np.ndarray, mask: np.ndarray, rule_idx: np.ndarray,
              now: float) -> None:
        """Merge re-evaluated rows into the cached tables."""
        gone = fids[~present].tolist()
        self.matched.remove_many(gone)
        self.flips.remove_many(gone)
        hit = mask & present
        self.matched.upsert_many(
            fids[hit].tolist(), size=cols["size"][hit],
            sort=np.asarray(cols[self.sort_by][hit], dtype=np.float64),
            rule=rule_idx[hit])
        self.matched.remove_many(fids[present & ~mask].tolist())
        if self.age_preds:
            flips = _next_flips(cols, self.age_preds, now)
            sched = present & np.isfinite(flips)
            self.flips.upsert_many(fids[sched].tolist(), flip=flips[sched])
            self.flips.remove_many(fids[present & ~np.isfinite(flips)].tolist())
        self.matched.maybe_compact()
        self.flips.maybe_compact()

    def plan_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        fids, cols = self.matched.live()
        return fids, cols["size"], cols["sort"], cols["rule"]

    # -- persistence (engine restart resumes incrementally) -------------------
    def export(self, sig: str) -> Optional[Dict[str, np.ndarray]]:
        """Snapshot the match table + flip schedule (+ undrained dirty fids)
        as flat arrays; None when the state is cold (nothing to resume)."""
        with self.lock:
            if not self.valid:
                return None
            fids, cols = self.matched.live()
            ffids, fcols = self.flips.live()
            return {
                "sig": np.array(sig),
                "fids": fids, "size": cols["size"], "sort": cols["sort"],
                "rule": cols["rule"],
                "flip_fids": ffids, "flip": fcols["flip"],
                "touched": np.array(sorted(self.touched), dtype=np.int64),
            }

    def restore(self, data: Dict[str, np.ndarray]) -> None:
        """Load a previously exported snapshot and mark the state valid."""
        with self.lock:
            self.matched.bulk_load(
                data["fids"].astype(np.int64), size=data["size"],
                sort=data["sort"], rule=data["rule"])
            self.flips.bulk_load(data["flip_fids"].astype(np.int64),
                                 flip=data["flip"])
            self.touched = set(data["touched"].tolist())
            self.valid = True


class PolicyEngine:
    """Evaluates policies over the catalog and applies actions."""

    # auto matching falls back to a full rescan once the dirty set exceeds
    # this fraction of the catalog (a scan is cheaper than that many gathers)
    incremental_rescan_frac = 0.25

    def __init__(self, catalog: Catalog, clock: Callable[[], float] = time.time,
                 device=None) -> None:
        self.catalog = catalog
        # the kernel evaluators run here: "cuda" unless told otherwise,
        # raising when there is no usable card (never a silent CPU run)
        self.device = resolve_device(device)
        self.clock = clock
        self.telemetry = catalog.telemetry
        self._tlabels = {"engine": catalog.telemetry.instance("engine")}
        self.policies: Dict[str, PolicyDefinition] = {}
        self.triggers: List[Tuple[str, UsageWatermarkTrigger]] = []
        self.history: List[RunReport] = []
        self._lock = threading.Lock()
        self._inc: Dict[str, _IncrementalState] = {}
        self._inc_enabled = False
        self._streams: List[Tuple[ChangelogStream, str]] = []
        self._sub_name: Optional[str] = None
        self.device_store = None         # attach_device_store wires the mesh

    def attach_device_store(self, store) -> None:
        """Wire a device column store (an object with ``catalog`` and
        ``match``; none ships with this package yet) so the
        ``policy_scan_mesh`` evaluator can match data-parallel over the
        device-resident sharded column stacks (no per-run host concat, no
        host→device re-upload — warm runs refresh churned rows by scatter).
        The store must wrap this engine's catalog."""
        if store.catalog is not self.catalog:
            raise PolicyError("device store wraps a different catalog")
        self.device_store = store

    def register(self, policy: PolicyDefinition) -> None:
        self.policies[policy.name] = policy
        self._inc.pop(policy.name, None)     # definition changed: reset cache
        if self._inc_enabled:
            self._ensure_state(policy.name)

    def add_watermark_trigger(self, policy_name: str,
                              trigger: UsageWatermarkTrigger) -> None:
        self.triggers.append((policy_name, trigger))

    # -- incremental state plumbing ------------------------------------------------
    def _ensure_state(self, policy_name: str) -> Optional[_IncrementalState]:
        state = self._inc.get(policy_name)
        if state is None:
            state = _IncrementalState(self.policies[policy_name])
            if state.supported:
                self._inc[policy_name] = state
            else:
                return None              # ==/!= age predicates: always full
        return state

    def enable_incremental(self) -> None:
        """Create per-policy incremental state; on by default once any delta
        source (pipeline / stream / mark_dirty) is attached."""
        self._inc_enabled = True
        for name in self.policies:
            self._ensure_state(name)

    def subscribe_pipeline(self, pipeline) -> None:
        """Receive (changed, removed) fid deltas from an
        :class:`EventPipeline` after each catalog commit."""
        self.enable_incremental()
        pipeline.add_delta_listener(self._on_deltas)

    def subscribe_stream(self, stream: ChangelogStream,
                         subscriber: Optional[str] = None) -> None:
        """Follow a changelog stream under the engine's own cursor.

        The subscriber registers ``from_start`` so records already emitted
        but not yet committed by the pipeline are not skipped (re-folding
        an already-committed fid is harmless — it is just re-evaluated).
        The engine's cursor then deliberately trails the stream's *default*
        consumer ack watermark (the pipeline's catalog-commit point): a
        record is only folded into dirty state once the catalog reflects
        it. Polling happens at the start of every :meth:`run`.

        ``subscriber`` defaults to a name unique to this engine instance so
        engines sharing a stream never steal each other's records; pass a
        stable name explicitly to resume a durable cursor across restarts
        (and :meth:`ChangelogStream.unsubscribe` it when decommissioned).
        """
        self.enable_incremental()
        name = subscriber or self._subscriber_name()
        # auto-named cursors are per-process: never persisted, so a dead
        # engine instance cannot pin the stream's purge floor after restart
        stream.subscribe(name, from_start=True,
                         durable=subscriber is not None)
        self._streams.append((stream, name))

    def _subscriber_name(self) -> str:
        if self._sub_name is None:
            with _ENGINE_SEQ_LOCK:
                _ENGINE_SEQ[0] += 1
                self._sub_name = f"policy-engine-{_ENGINE_SEQ[0]}"
        return self._sub_name

    def subscribe_hub(self, hub: ChangelogHub,
                      subscriber: Optional[str] = None) -> None:
        for stream in hub.streams.values():
            self.subscribe_stream(stream, subscriber)

    def mark_dirty(self, fids: Iterable[int]) -> None:
        """Explicitly mark entries changed (for catalog mutations that did
        not flow through a subscribed changelog/pipeline)."""
        if not self._inc_enabled:
            self.enable_incremental()
        fids = list(fids)
        for state in list(self._inc.values()):
            state.note_touched(fids)

    def invalidate(self, policy_name: Optional[str] = None) -> None:
        """Drop cached match state (e.g. after a changelog cursor reset);
        the next run falls back to a full scan and rebuilds it."""
        if policy_name is None:
            states = list(self._inc.values())
        else:
            state = self._inc.get(policy_name)
            states = [state] if state is not None else []
        for state in states:
            state.invalidate()

    # -- incremental state persistence --------------------------------------------
    @staticmethod
    def _signature(policy: PolicyDefinition) -> str:
        """Criteria signature guarding resume: a snapshot is only restored
        into a policy whose scope/rules/sort have not changed since save."""
        return repr((policy.scope,
                     [(r.name, r.condition, sorted(r.params.items()))
                      for r in policy.rules],
                     policy.sort_by, policy.sort_desc))

    def _inc_state_path(self, path: Optional[str]) -> str:
        if path is not None:
            return path
        if self.catalog.db_path:
            return self.catalog.db_path + ".incstate.npz"
        raise PolicyError("no incremental-state path: pass one explicitly "
                          "or attach a sqlite mirror to the catalog")

    def save_incremental(self, path: Optional[str] = None) -> str:
        """Serialize every valid per-policy match table + age-flip schedule
        (and undrained dirty fids) beside the sqlite mirror.

        Default path is ``<catalog.db_path>.incstate.npz``. The write is
        atomic (tmp + rename). Call it quiescent — between runs, after the
        changelog pipeline has drained — and pair it with a *durable*
        changelog subscriber so deltas arriving while the engine is down
        are re-delivered after :meth:`load_incremental`.
        """
        path = self._inc_state_path(path)
        payload: Dict[str, np.ndarray] = {}
        for name, state in list(self._inc.items()):
            policy = self.policies.get(name)
            if policy is None:
                continue
            data = state.export(self._signature(policy))
            if data is None:
                continue
            for key, arr in data.items():
                payload[f"{name}::{key}"] = arr
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
        return path

    def load_incremental(self, path: Optional[str] = None) -> List[str]:
        """Restore saved match state; returns the policies resumed.

        A policy resumes only when it is registered and its criteria
        signature matches the snapshot (a changed definition falls back to
        the usual cold full scan). Missing file -> no-op, [].
        """
        path = self._inc_state_path(path)
        if not os.path.exists(path):
            return []
        by_policy: Dict[str, Dict[str, np.ndarray]] = {}
        with np.load(path, allow_pickle=False) as z:
            for key in z.files:
                name, field = key.rsplit("::", 1)
                by_policy.setdefault(name, {})[field] = z[key]
        self.enable_incremental()
        resumed = []
        for name, data in by_policy.items():
            policy = self.policies.get(name)
            if policy is None or "sig" not in data:
                continue
            if str(data["sig"]) != self._signature(policy):
                continue
            state = self._ensure_state(name)
            if state is None:
                continue
            state.restore(data)
            resumed.append(name)
        return resumed

    def _on_deltas(self, changed: List[int], removed: List[int]) -> None:
        # called from pipeline worker threads: snapshot against concurrent
        # register() mutating the state dict
        for state in list(self._inc.values()):
            state.note_touched(changed)
            state.note_touched(removed)

    def _poll_streams(self) -> None:
        """Drain subscribed changelog streams into the dirty sets, acking
        only records the default consumer has already committed."""
        for stream, name in self._streams:
            while True:
                recs = stream.read(max_records=4096, subscriber=name)
                if not recs:
                    break
                committed = stream.acked        # pipeline's commit watermark
                use = [r for r in recs if r.seq <= committed]
                if use:
                    fids = [r.fid for r in use]
                    for state in list(self._inc.values()):
                        state.note_touched(fids)
                    stream.ack(use[-1].seq, subscriber=name)
                if len(use) < len(recs):
                    # beyond the commit point: re-deliver on the next poll
                    stream.reset_cursor(subscriber=name)
                    break

    # -- matching -----------------------------------------------------------------
    def _eval_cols(self, policy: PolicyDefinition, cols, extra: Optional[Expr],
                   now: float) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized scope/rules evaluation over any column dict."""
        strings = self.catalog.strings
        mask = policy.scope.mask(cols, strings, now)
        rule_masks = [r.condition.mask(cols, strings, now)
                      for r in policy.rules]
        if rule_masks:
            mask = mask & np.logical_or.reduce(rule_masks)
        if extra is not None:
            mask = mask & extra.mask(cols, strings, now)
        return mask, self._attribute(mask, rule_masks)

    @staticmethod
    def _programs(policy: PolicyDefinition, extra: Optional[Expr]
                  ) -> List[Expr]:
        """[combined criteria] + per-rule conditions, the kernel-path
        program batch shared by the single-launch and mesh evaluators."""
        rule_exprs = [r.condition for r in policy.rules]
        full = all_of([policy.scope]
                      + ([any_of(rule_exprs)] if rule_exprs else [])
                      + ([extra] if extra else []))
        return [full] + rule_exprs

    def _match(self, policy: PolicyDefinition, extra: Optional[Expr],
               now: float, evaluator: str = "numpy"
               ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray],
                          str, str]:
        """One columnar pass: final mask + vectorized rule attribution.

        Returns (mask, rule_idx, cols, evaluator_used, fallback_reason).
        ``rule_idx[i]`` is the index of the first (highest-priority) rule
        matching row i, or -1 when the policy has no rules. The
        ``policy_scan`` backend evaluates the whole program batch in a
        single kernel launch with attribution fused on-device; it falls
        back to numpy for host-only (glob) predicates, recording why.
        """
        if evaluator not in EVALUATORS:
            raise PolicyError(f"unknown evaluator {evaluator!r}")
        cols = self.catalog.arrays()
        reason = ""
        if evaluator in ("policy_scan", "policy_scan_mesh"):
            try:
                from ..kernels.policy_scan.ops import match_programs
                masks, _agg, rule_idx = match_programs(
                    cols, self._programs(policy, extra),
                    self.catalog.strings, now, device=self.device)
                return masks[0], rule_idx, cols, "policy_scan", reason
            except PolicyError as e:
                # glob predicates run on the host
                reason = f"policy_scan->numpy: {e}"
        mask, rule_idx = self._eval_cols(policy, cols, extra, now)
        return mask, rule_idx, cols, "numpy", reason

    def _match_mesh(self, policy: PolicyDefinition, extra: Optional[Expr],
                    now: float):
        """Mesh-parallel full match over the attached device store.

        Each device evaluates the (R, P) program batch over its resident
        shard-group column block (stale groups refresh by delta scatter
        first); only matched local rows come back and are translated
        through the store's host mirrors — the catalog columns are never
        concatenated or re-uploaded. Returns the live
        ``MeshMatch`` (``plan`` for the
        action plan, ``cache_arrays`` to prime the incremental cache).
        Raises PolicyError when no store is attached or the criteria hold
        host-only (glob) predicates.
        """
        if self.device_store is None:
            raise PolicyError("no device store attached "
                              "(PolicyEngine.attach_device_store)")
        return self.device_store.match(self._programs(policy, extra), now,
                                       with_agg=False)

    def _match_incremental(self, policy: PolicyDefinition,
                           state: _IncrementalState, extra: Optional[Expr],
                           now: float
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray, int]:
        """Re-evaluate only dirty/time-due rows, plan from the cached table.

        Re-evaluated rows flow as a :class:`ColumnBatch` (no Entry
        materialization). Returns (fids, sizes, sort_keys, rule_idx,
        n_revaluated)."""
        reval = sorted(state.drain_touched() | state.due_flips(now))
        if reval:
            try:
                batch = self.catalog.column_batch(
                    reval, with_strings=state.needs_strings)
                mask, rule_idx = self._eval_cols(policy, batch.cols, None,
                                                 now)
                state.apply(np.asarray(reval, dtype=np.int64), batch.cols,
                            batch.present, mask, rule_idx, now)
            except Exception:
                # the drained dirty fids may be partially merged: force a
                # full rebuild rather than silently losing them
                state.invalidate()
                raise
        fids, sizes, sort_keys, rule_idx = state.plan_arrays()
        if extra is not None and fids.size:
            ebatch = self.catalog.column_batch(
                fids.tolist(), with_strings=_uses_globs(extra))
            emask = extra.mask(ebatch.cols, self.catalog.strings, now) \
                & ebatch.present
            fids, sizes = fids[emask], sizes[emask]
            sort_keys, rule_idx = sort_keys[emask], rule_idx[emask]
        return fids, sizes, sort_keys, rule_idx, len(reval)

    def _resolve_matching(self, matching: str, policy: PolicyDefinition,
                          state: Optional[_IncrementalState],
                          has_extra: bool = False) -> str:
        if matching not in MATCHING_MODES:
            raise PolicyError(f"unknown matching mode {matching!r}")
        if matching == "full":
            return "full"
        ready = state is not None and state.valid
        if matching == "incremental":
            if not ready:
                if not _age_predicates(policy)[1]:
                    raise PolicyError(
                        f"policy {policy.name!r} cannot match incrementally:"
                        " ==/!= comparisons on age attributes have no"
                        " well-defined flip instant")
                raise PolicyError(
                    "incremental matching unavailable: no cached match "
                    "state (attach a delta source and run a full scan "
                    "first)")
            return "incremental"
        if not ready:
            return "full"
        limit = self.incremental_rescan_frac * max(1, len(self.catalog))
        if state.touched_count() > limit:
            return "full"                  # scan beats that many gathers
        if has_extra and len(state.matched) > limit:
            # extra criteria re-gather every cached matched fid; past this
            # size a vectorized full snapshot is the cheaper plan
            return "full"
        return "incremental"

    @staticmethod
    def _attribute(mask: np.ndarray, rule_masks: List[np.ndarray]
                   ) -> np.ndarray:
        """First-match-wins rule index per row (shared semantics authority:
        :func:`core.policy.attribute_rules`)."""
        return attribute_rules(rule_masks, int(mask.shape[0]))

    def _rule_params(self, policy: PolicyDefinition, e: Entry, now: float) -> dict:
        for rule in policy.rules:
            if rule.condition.evaluate(e, now):
                return rule.params
        return {}

    # -- execution -----------------------------------------------------------------
    def run(self, policy_name: str, extra_criteria: Optional[Expr] = None,
            target_volume: int = 0, trigger: str = "manual",
            evaluator: Optional[str] = None,
            execution: str = "columnar",
            matching: str = "auto") -> RunReport:
        """One policy run: match -> sort -> apply until targets met.

        ``evaluator`` overrides the policy's matching backend for this run;
        ``execution`` picks the apply path: ``"columnar"`` (default) flows
        ColumnBatch chunks straight to batch actions with zero Entry
        materialization, ``"batched"`` keeps the Entry-materializing
        chunked path and ``"scalar"`` the legacy per-entry path (benchmarks
        / bisection only); ``matching`` picks the planner: ``"full"`` scans
        the catalog columns, ``"incremental"`` re-evaluates only dirty/due
        rows against the cached match table (requires a delta source and a
        prior full run), ``"auto"`` (default) uses the incremental path
        whenever it is valid.
        """
        if execution not in EXECUTION_MODES:
            raise PolicyError(f"unknown execution mode {execution!r}")
        policy = self.policies[policy_name]
        now = self.clock()
        t0 = time.perf_counter()
        c0 = self.telemetry.counter_values() if self.telemetry.enabled \
            else {}
        with self.telemetry.trace("run", policy=policy_name,
                                  trigger=trigger,
                                  **self._tlabels) as _root:
            report = self._run_traced(policy_name, policy, now,
                                      extra_criteria, target_volume,
                                      trigger, evaluator, execution,
                                      matching)
        report.elapsed = time.perf_counter() - t0
        if self.telemetry.enabled:
            c1 = self.telemetry.counter_values()
            report.telemetry = {
                "spans": _root.to_dict(),
                "counters": {k: v - c0.get(k, 0.0)
                             for k, v in c1.items()
                             if v != c0.get(k, 0.0)},
            }
        self.history.append(report)
        return report

    def _run_traced(self, policy_name: str, policy, now: float,
                    extra_criteria: Optional[Expr], target_volume: int,
                    trigger: str, evaluator: Optional[str],
                    execution: str, matching: str) -> RunReport:
        with self.telemetry.trace("run.ingest", **self._tlabels):
            self._poll_streams()
        state = self._inc.get(policy_name)
        mode = self._resolve_matching(matching, policy, state,
                                      has_extra=extra_criteria is not None)

        with self.telemetry.trace("run.match", mode=mode,
                                  **self._tlabels) as _msp:
            (fids, sizes, sort_keys, ridx, reval, used_eval, fallback,
             tiering) = self._match_phase(policy, state, mode,
                                          extra_criteria, now, evaluator)
            _msp.annotate(evaluator=used_eval, reval=reval)
        report = RunReport(policy=policy_name, matched=int(fids.size),
                           trigger=trigger, evaluator=used_eval,
                           mode=mode, reval=reval, execution=execution,
                           fallback_reason=fallback, tiering=tiering,
                           matched_volume=int(sizes.sum()) if fids.size else 0)

        executed = 0
        plan = None
        if fids.size:
            key = -sort_keys if policy.sort_desc else sort_keys
            order = np.lexsort((fids, key))    # fid tie-break: total order,
            plan = _Plan(fids=fids[order],     # identical across planners
                         sizes=sizes[order], rule_idx=ridx[order])
            budget_volume = target_volume or policy.max_volume_per_run
            budget_count = policy.max_actions_per_run
            with self.telemetry.trace("run.act", execution=execution,
                                      **self._tlabels):
                if execution == "scalar":
                    executed = self._run_scalar(policy, plan, now, report,
                                                budget_volume, budget_count)
                else:
                    executed = self._run_batched(policy, plan, now, report,
                                                 budget_volume, budget_count,
                                                 execution)
        if executed and policy.mutates and not policy.dry_run:
            # actions may mutate the catalog directly (purge/archive
            # plugins): re-observe actioned entries on the next run
            acted = plan.fids[:executed].tolist()
            for st in list(self._inc.values()):
                st.note_touched(acted)
        return report

    def _record_fallback(self, reason: str) -> None:
        """Mirror a ``RunReport.fallback_reason`` entry into the registry
        as ``fallback{stage=,reason=}`` — the stage is the downgrade edge
        (``policy_scan_mesh->policy_scan``, ``policy_scan->numpy``, ...),
        the reason a bounded slug of the cause, so exports can assert "no
        silent fallback" without scraping report strings."""
        stage, _, cause = reason.partition(":")
        self.telemetry.counter(
            "fallback", help="evaluator/serving downgrades",
            stage=stage.strip(), reason=slug(cause.strip() or "unknown"),
            **self._tlabels).inc()

    def _match_phase(self, policy: PolicyDefinition, state, mode: str,
                     extra_criteria: Optional[Expr], now: float,
                     evaluator: Optional[str]):
        """Resolve the match set for one run (the ``run.match`` span):
        returns (fids, sizes, sort_keys, ridx, reval, used_eval,
        fallback_reason, tiering_deltas)."""
        fallback = ""
        tiering: dict = {}
        if mode == "incremental":
            fids, sizes, sort_keys, ridx, reval = self._match_incremental(
                policy, state, extra_criteria, now)
            used_eval = "numpy"
            want = evaluator or policy.evaluator
            if want != "numpy":
                # not a degradation — the cached match table beat a full
                # scan on ANY backend — but still recorded so callers
                # asserting "the kernel path ran" see why it did not
                fallback = (f"{want}->incremental: cached match table "
                            "served the run (force matching=\"full\" to "
                            "exercise the evaluator)")
                self._record_fallback(fallback)
        else:
            want = evaluator or policy.evaluator
            mesh_done = False
            if want == "policy_scan_mesh":
                # the mesh full scan primes the incremental cache without
                # touching host columns: matched rows + age-flip instants
                # extract from the store's host mirrors (cache_arrays),
                # same no-lost-deltas bracket as the host scans below
                rebuild = state is not None and extra_criteria is None
                if rebuild:
                    state.begin_rebuild()
                tc0 = self.device_store.tiering_counters() \
                    if self.device_store is not None else {}
                try:
                    match = self._match_mesh(policy, extra_criteria, now)
                    if rebuild:
                        (fids, sizes, sort_keys, ridx, flip_fids,
                         flips) = match.cache_arrays(
                            policy.sort_by, state.age_preds, now)
                        state.rebuild_arrays(fids, sizes, sort_keys, ridx,
                                             flip_fids, flips)
                    else:
                        fids, sizes, sort_keys, ridx = match.plan(
                            policy.sort_by)
                    reval = match.reval
                    used_eval = "policy_scan_mesh"
                    mesh_done = True
                    # deltas for counters, absolute values for gauges
                    tc1 = self.device_store.tiering_counters()
                    tiering = {
                        k: v if k in ("resident_groups", "demoted_groups")
                        else v - tc0.get(k, 0) for k, v in tc1.items()}
                except PolicyError as e:
                    if rebuild:
                        state.invalidate()
                    fallback = f"policy_scan_mesh->policy_scan: {e}"
                    self._record_fallback(fallback)
                except Exception:
                    if rebuild:
                        state.invalidate()
                    raise
            if not mesh_done:
                rebuild = state is not None and extra_criteria is None
                if rebuild:
                    state.begin_rebuild()   # before snapshot: no lost deltas
                try:
                    mask, rule_idx, cols, used_eval, reason = self._match(
                        policy, extra_criteria, now, want)
                    if reason:
                        self._record_fallback(reason)
                    fallback = "; ".join(r for r in (fallback, reason) if r)
                    fids = cols["fid"][mask]
                    sizes = cols["size"][mask]
                    ridx = rule_idx[mask]
                    sort_keys = np.asarray(cols[policy.sort_by][mask],
                                           dtype=np.float64)
                    reval = int(mask.size)
                    if rebuild:
                        state.rebuild(cols, mask, rule_idx, now)
                except Exception:
                    # never leave a half-built cache marked valid (a bad
                    # sort_by would otherwise silently match nothing forever)
                    if rebuild:
                        state.invalidate()
                    raise
        return fids, sizes, sort_keys, ridx, reval, used_eval, fallback, \
            tiering

    # -- batched / columnar execution ---------------------------------------------
    def _run_batched(self, policy: PolicyDefinition, plan: _Plan, now: float,
                     report: RunReport, budget_volume: int,
                     budget_count: int, execution: str = "columnar") -> int:
        """Budgeted rounds of chunk-parallel execution.

        Each round takes the minimal prefix of the remaining sorted work
        whose projected (match-time) volume/count meets the remaining
        budget, so the stop decision happens on batch boundaries and the
        actioned set never depends on thread timing. A follow-up round only
        happens when failures/skips left a budget unmet. Returns the number
        of plan entries attempted.
        """
        n = len(plan.fids)
        pos = 0
        while pos < n:
            take = n - pos
            if budget_volume:
                remaining = budget_volume - report.volume
                if remaining <= 0:
                    break
                csum = np.cumsum(plan.sizes[pos:])
                take = min(take, int(np.searchsorted(csum, remaining)) + 1)
            if budget_count:
                remaining_n = budget_count - report.succeeded
                if remaining_n <= 0:
                    break
                take = min(take, remaining_n)
            self._execute_round(policy, plan, pos, pos + take, now, report,
                                execution)
            report.rounds += 1
            pos += take
            if not budget_volume and not budget_count:
                break                      # single round covers everything
        return pos

    def _execute_round(self, policy: PolicyDefinition, plan: _Plan,
                       lo: int, hi: int, now: float, report: RunReport,
                       execution: str = "columnar") -> None:
        """Execute plan[lo:hi] in chunks drawn from a deque by N workers."""
        chunk = max(1, policy.batch_size)
        work: "deque[slice]" = deque(slice(i, min(i + chunk, hi))
                                     for i in range(lo, hi, chunk))

        def worker() -> None:
            while True:
                try:
                    sl = work.popleft()    # atomic; IndexError ends worker
                except IndexError:
                    return
                self._apply_chunk(policy, plan, sl, now, report, execution)

        n_threads = min(max(1, policy.n_threads), len(work))
        if n_threads <= 1:
            worker()
            return
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _apply_chunk(self, policy: PolicyDefinition, plan: _Plan,
                     sl: slice, now: float, report: RunReport,
                     execution: str = "columnar") -> None:
        """Apply one chunk of planned work.

        ``execution="columnar"`` (the hot path) fetches the chunk as a
        :class:`ColumnBatch` — one numeric gather per shard group, zero
        ``Entry.__init__`` — and hands per-rule sub-batches to the action's
        batch interface. Entries are materialized only when the action
        declares ``needs_entries = True`` or exposes no batch interface.
        ``execution="batched"`` is the legacy baseline: every chunk
        materializes Entries first, then batch actions run off a
        ``ColumnBatch.from_entries`` shim (identical plugin code, so the
        two paths action identical fid sequences — the materialization is
        exactly the cost being measured).
        """
        fids = plan.fids[sl]
        sizes = plan.sizes[sl]
        ridx = plan.rule_idx[sl]
        if policy.dry_run:
            with self._lock:
                report.succeeded += len(fids)
                report.volume += int(sizes.sum())
            return
        batch_fn: Optional[BatchAction] = getattr(policy.action,
                                                  "action_batch", None)
        needs_entries = bool(getattr(policy.action, "needs_entries", False))
        entries: Optional[List[Optional[Entry]]] = None
        batch: Optional[ColumnBatch] = None
        if batch_fn is None or needs_entries or execution == "batched":
            entries = self.catalog.get_batch(fids.tolist())
            skipped = np.array([e is None for e in entries])
            if batch_fn is not None and not needs_entries:
                batch = ColumnBatch.from_entries(entries,
                                                 self.catalog.strings,
                                                 self.catalog)
        else:
            batch = self.catalog.column_batch(fids.tolist())
            skipped = ~batch.present
        ok = np.zeros(len(fids), dtype=bool)
        if batch_fn is not None:
            # batch interface: one call per rule group (shared params)
            for ri in np.unique(ridx):
                group = np.nonzero((ridx == ri) & ~skipped)[0]
                if not group.size:
                    continue
                params = policy.rules[ri].params if ri >= 0 else {}
                payload = ([entries[i] for i in group] if needs_entries
                           else batch.take(group))
                try:
                    results = batch_fn(payload, params)
                except Exception:
                    results = [False] * int(group.size)
                ok[group] = results
        else:
            # scalar actions keep strict plan (sort) order within the chunk
            for i in np.nonzero(~skipped)[0]:
                ri = ridx[i]
                params = policy.rules[ri].params if ri >= 0 else {}
                try:
                    ok[i] = policy.action(entries[i], params)
                except Exception:
                    ok[i] = False
        done = ok & ~skipped
        with self._lock:
            report.succeeded += int(done.sum())
            report.failed += int((~ok & ~skipped).sum())
            report.skipped += int(skipped.sum())
            report.volume += int(sizes[done].sum())

    # -- legacy scalar execution (benchmark baseline) ------------------------------
    def _run_scalar(self, policy: PolicyDefinition, plan: _Plan, now: float,
                    report: RunReport, budget_volume: int,
                    budget_count: int) -> int:
        """Pre-batching hot path: O(n) dequeues, per-entry catalog.get and
        Python rule re-evaluation, racy post-hoc budget checks. Returns the
        number of plan entries attempted (conservative: the whole list)."""
        work = list(plan.fids.tolist())
        work_lock = threading.Lock()
        stop = threading.Event()

        def runner() -> None:
            while not stop.is_set():
                with work_lock:
                    if not work:
                        return
                    fid = work.pop(0)
                e = self.catalog.get(fid)
                if e is None:
                    continue
                params = self._rule_params(policy, e, now)
                size = e.size
                if policy.dry_run:
                    ok = True
                else:
                    try:
                        ok = policy.action(e, params)
                    except Exception:
                        ok = False
                with self._lock:
                    if ok:
                        report.succeeded += 1
                        report.volume += size
                    else:
                        report.failed += 1
                    if budget_volume and report.volume >= budget_volume:
                        stop.set()
                    if budget_count and report.succeeded >= budget_count:
                        stop.set()

        threads = [threading.Thread(target=runner, daemon=True)
                   for _ in range(max(1, policy.n_threads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return len(plan.fids)

    def check_triggers(self) -> List[RunReport]:
        """Fire any watermark triggers whose threshold is exceeded (C7)."""
        reports = []
        for policy_name, trig in self.triggers:
            for key, extra, target in trig.check():
                reports.append(self.run(policy_name, extra_criteria=extra,
                                        target_volume=target,
                                        trigger=f"watermark:{key}"))
        return reports

    def run_all_periodic(self) -> List[RunReport]:
        return [self.run(name) for name in self.policies]
