"""Multi-stage record-processing pipeline (C4) + async dirty-tag mode (C11).

Paper SIII-A2: record processing is split into steps, one per resource kind
(filesystem lookups vs database commits), serviced by a worker-thread pool;
per-resource concurrency is capped so neither the MDS nor the DB is
overloaded. We reproduce that, plus the paper's *proposed* asynchronous
improvement: changelog processing merely **tags** entries dirty (cheap, acks
fast), and a background pool of *updaters* refreshes tagged entries, folding
repeated changes to one refresh (dedup).

**Columnar hot path (default).** The line-rate ingest plane runs one
sharded reader per MDT stream. Each reader drains records into a columnar
batch (``seq``/``fid``/``type``/``time`` numpy arrays — no per-event
Python dicts from the reader onward), folds the batch with
:func:`fold_columnar` (vectorized last-write-wins via ``np.unique`` on fid
with a reversed-order index: CREAT→UNLNK annihilation, SETATTR storms
deduped and counted), resolves the surviving fids through one batched
``fs.stat_batch``, and lands the whole :class:`DeltaBatch` with ONE
``Catalog.commit_delta_batch`` call — one durable commit, one version
bump, and one delta fan-out that reaches catalog hooks, profile cube,
permission bitmaps and the ``DeviceColumnStore`` in a single dispatch
instead of N listener invocations re-deriving the same classification.

**Adaptive backpressure.** Each reader owns a per-MDT batch quantum in
``[min_batch, max_batch]``, driven by the PR-9 telemetry signals
(``changelog_backlog_mdt*`` / ``changelog_lag_seconds_mdt*`` are computed
from the same cursors the reader consults via ``stream.pending()`` /
``lag_seconds()``): the quantum doubles toward ``max_batch`` while the
backlog exceeds it and lag stays under ``lag_target``, and halves when a
batch's apply latency exceeds ``target_batch_seconds`` (ack latency
degrading). Transitions are visible as ``pipeline_batch_quantum{mdt=}``
gauges and ``pipeline_batch_adaptations{mdt=,direction=}`` counters.

**Differential oracle.** ``PipelineConfig(columnar=False)`` keeps the
record-at-a-time path (reader → batch queue → worker pool): identical
catalog state, actioned fid sets and ack ordering — the property suites
and the tier-2 bench assertion prove the two paths equivalent, including
crash/resume mid-batch.

Stages (synchronous modes):
  changelog record -> [GET_INFO: fs.stat, bounded by fs_concurrency]
                   -> [DB_APPLY: catalog batch upsert, bounded by db_concurrency]
                   -> ack(seq)

Acks are only issued once every record up to ``seq`` is committed (the
catalog's sqlite commit happens inside ``upsert_batch`` /
``commit_delta_batch``), preserving the transactional contract end-to-end.

**Delta fan-out**: downstream consumers (the policy engine's incremental
match state, cache invalidators, ...) can register a listener via
:meth:`EventPipeline.add_delta_listener`; after each batch is committed to
the catalog the listener receives ``(changed_fids, removed_fids)``.
Batch-aware consumers use :meth:`EventPipeline.add_batch_listener` and
receive the full :class:`DeltaBatch` instead. Listeners are notified
*after* the catalog mutation, so re-reading the catalog for a notified fid
always observes at least that change. Within one batch, records are folded
per fid, last-write-wins (one refresh per fid; an ``UNLNK`` arriving after
a ``CREAT`` of the same fid in the same batch wins — the entry is removed,
never materialized, and never reported dirty). The columnar fold emits
changed/removed fids in sorted-fid order (the scalar oracle emits
first-occurrence order); per-fid outcomes are identical.

The same committed mutations also reach every ``Catalog.add_delta_hook``
consumer (each claiming exactly one feed — see the shared fan-out
contract in ``core.device_store`` / ``ProfileCube.claim_delta_feed``):
the :class:`~repro_torch.core.device_store.DeviceColumnStore` drains one dirty
batch into the resident column block, the cube partials, the plane
mirrors **and the permissions-plane bitsets** in a single scatter pass,
so changelog ingestion keeps multi-tenant ``subject=`` serving fresh
without any consumer rescanning the catalog.
"""
from __future__ import annotations

import dataclasses
import heapq
import queue
import threading
import time
from typing import (Callable, Dict, List, NamedTuple, Optional, Set,
                    Tuple, Union)

import numpy as np

from .catalog import Catalog
from .changelog import ChangelogHub, ChangelogStream, ColumnarRecords
from .stats import ChangelogCounters
from .telemetry import counter_attr
from .types import ChangelogRecord, ChangelogType, Entry
from ..fs.base import stat_batch as _fs_stat_batch

_RM = (int(ChangelogType.UNLNK), int(ChangelogType.RMDIR))
_BORN = (int(ChangelogType.CREAT), int(ChangelogType.MKDIR))


@dataclasses.dataclass
class PipelineConfig:
    fs_concurrency: int = 4       # max simultaneous filesystem operations
    db_concurrency: int = 2       # max simultaneous catalog commit batches
    batch_size: int = 256         # records per DB commit batch (start quantum)
    n_workers: int = 4            # oracle-mode worker pool size
    async_updates: bool = False   # dirty-tag + background updaters
    n_updaters: int = 2
    updater_interval: float = 0.002   # kept for config back-compat (unused:
    #                                   updaters block on a Condition now)
    columnar: bool = True         # vectorized fold + single fan-out apply;
    #                               False = record-at-a-time oracle
    min_batch: int = 64           # adaptive quantum floor
    max_batch: int = 8192         # adaptive quantum ceiling
    target_batch_seconds: float = 0.05   # shrink when apply exceeds this
    lag_target: float = 1.0       # grow only while stream lag is under this


class FoldResult(NamedTuple):
    """Vectorized last-write-wins fold of one columnar batch."""
    survivors: np.ndarray    # unique fids whose last op is not a removal
    removed: np.ndarray      # unique fids whose last op is UNLNK/RMDIR
    annihilated: np.ndarray  # ⊆ removed: first op in batch was CREAT/MKDIR
    dedup: int               # records folded away (n_records - n_unique)


def fold_columnar(fid: np.ndarray, typ: np.ndarray) -> FoldResult:
    """Fold a record batch per fid with vectorized last-write-wins.

    ``np.unique`` on the forward fid array yields the sorted unique fids
    plus each fid's FIRST record index; the same call on the reversed
    array yields identical uniques whose first-occurrence indices map to
    the LAST record index (``n-1-rev_idx``). The last op classifies each
    fid as removal vs survivor; a removed fid whose first in-batch op was
    a CREAT/MKDIR was born and died inside the batch — an annihilation
    (the entry must never materialize downstream). Equivalent to the
    scalar record-order fold for every interleaving (property-tested in
    ``tests/core/test_fold_properties.py``).
    """
    n = fid.shape[0]
    uniq, first_idx = np.unique(fid, return_index=True)
    if uniq.size == n:
        last_idx = first_idx               # no duplicates: first == last
    else:
        _, rev_idx = np.unique(fid[::-1], return_index=True)
        last_idx = n - 1 - rev_idx
    last_t = typ[last_idx]
    is_rm = (last_t == _RM[0]) | (last_t == _RM[1])
    first_t = typ[first_idx]
    born = (first_t == _BORN[0]) | (first_t == _BORN[1])
    return FoldResult(survivors=uniq[~is_rm], removed=uniq[is_rm],
                      annihilated=uniq[is_rm & born],
                      dedup=int(n - uniq.size))


@dataclasses.dataclass
class DeltaBatch:
    """One committed columnar batch, as delivered to batch listeners."""
    mdt: int
    seqs: np.ndarray           # acked sequence numbers (contiguous read)
    changed: List[int]         # surviving fids upserted (sorted-fid order)
    removed: List[int]         # fids whose last op removed them (sorted)
    entries: List[Entry]       # the upserted entries, aligned with changed
    dedup: int                 # records folded away by last-write-wins
    annihilated: List[int]     # same-batch CREAT→UNLNK fids (⊆ removed)


class _AckTracker:
    """Tracks per-stream contiguous completion so acks stay in order.

    Completed work arrives as [lo, hi] seq ranges (every read is a
    contiguous run after the cursor), so the heap holds ranges, not
    individual seqs — completing a 8192-record batch is one push, not
    8192 O(log n) pushes."""

    def __init__(self, stream: ChangelogStream) -> None:
        self.stream = stream
        self._lock = threading.Lock()
        self._done: List[Tuple[int, int]] = []   # min-heap of (lo, hi)
        self._acked = stream.acked

    def complete(self, seqs: List[int]) -> None:
        if seqs:
            self.complete_range(min(seqs), max(seqs))

    def complete_range(self, lo: int, hi: int) -> None:
        with self._lock:
            heapq.heappush(self._done, (lo, hi))
            new_ack = self._acked
            while self._done and self._done[0][0] == new_ack + 1:
                new_ack = heapq.heappop(self._done)[1]
            if new_ack != self._acked:
                self._acked = new_ack
                self.stream.ack(new_ack)


class EventPipeline:
    """Consumes one or many changelog streams into the catalog.

    ``stream`` may be a single :class:`ChangelogStream` (back-compat: one
    pipeline per MDT) or a whole :class:`ChangelogHub` — the pipeline then
    runs one sharded reader per MDT stream with independent ack cursors
    and adaptive per-MDT batch quanta.
    """

    # ingest counters, registry-backed (tests read them as plain ints)
    processed = counter_attr(
        "pipeline_records_processed", "changelog records folded into the "
        "catalog")
    dedup_hits = counter_attr(
        "pipeline_dedup_hits", "records folded away before the catalog "
        "(columnar last-write-wins / pending dirty tags)")

    def __init__(self, fs, catalog: Catalog,
                 stream: Union[ChangelogStream, ChangelogHub],
                 config: Optional[PipelineConfig] = None,
                 counters: Optional[ChangelogCounters] = None) -> None:
        self.fs = fs
        self.catalog = catalog
        self.stream = stream
        if isinstance(stream, ChangelogHub):
            self.streams: Dict[int, ChangelogStream] = dict(stream.streams)
        else:
            self.streams = {stream.mdt: stream}
        self.cfg = config or PipelineConfig()
        self.counters = counters
        self.telemetry = catalog.telemetry
        self._tlabels = {"pipeline": catalog.telemetry.instance("pipeline")}
        # the streams' backlog/lag gauges + events counters land in the
        # same registry (first binder wins; a stream shared by several
        # catalogs keeps its first registry)
        for s in self.streams.values():
            if s.telemetry is None:
                s.bind_telemetry(catalog.telemetry)
        self._fs_sem = threading.Semaphore(self.cfg.fs_concurrency)
        self._db_sem = threading.Semaphore(self.cfg.db_concurrency)
        self._acks = {mdt: _AckTracker(s) for mdt, s in self.streams.items()}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._batches: "queue.Queue[Optional[List[ChangelogRecord]]]" = \
            queue.Queue(maxsize=64)
        self.processed = 0
        self._processed_lock = threading.Lock()
        # batches read but not yet committed+acked (drain must wait on
        # these: stream.pending() covers the pre-ack window, but the async
        # updater pops fids out of _dirty before the refresh lands)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # async dirty-tag state; the Condition doubles as the updater
        # wakeup (no interval polling — taggers notify, updaters wait)
        self._dirty: Set[int] = set()
        self._dirty_cv = threading.Condition()
        self._dirty_lock = self._dirty_cv      # back-compat alias
        self.dedup_hits = 0
        # adaptive per-MDT read quantum (columnar backpressure loop)
        self._quantum: Dict[int, int] = {
            mdt: max(self.cfg.min_batch,
                     min(self.cfg.batch_size, self.cfg.max_batch))
            for mdt in self.streams}
        for mdt, q in self._quantum.items():
            self.telemetry.gauge(
                "pipeline_batch_quantum", help="adaptive per-MDT read "
                "quantum", mdt=str(mdt), **self._tlabels).set(q)
        # delta fan-out (policy engine incremental match state, caches, ...)
        self._delta_listeners: List[Callable[[List[int], List[int]], None]] = []
        self._batch_listeners: List[Callable[[DeltaBatch], None]] = []

    # -- delta fan-out ------------------------------------------------------------
    def add_delta_listener(self, fn: Callable[[List[int], List[int]], None]
                           ) -> None:
        """Register ``fn(changed_fids, removed_fids)``, called after each
        batch of records has been committed to the catalog."""
        self._delta_listeners.append(fn)

    def add_batch_listener(self, fn: Callable[[DeltaBatch], None]) -> None:
        """Register a batch-aware consumer: ``fn(delta_batch)`` fires once
        per committed batch with the folded classification (changed /
        removed / annihilated / dedup) already attached — no re-deriving
        it from fid lists."""
        self._batch_listeners.append(fn)

    def _notify(self, changed: List[int], removed: List[int],
                batch: Optional[DeltaBatch] = None) -> None:
        if not (changed or removed):
            return
        self.telemetry.counter(
            "pipeline_deltas_fanned_out", help="fids propagated to "
            "delta listeners after a catalog commit",
            **self._tlabels).inc(len(changed) + len(removed))
        with self.telemetry.trace("pipeline.fanout",
                                  changed=len(changed),
                                  removed=len(removed),
                                  **self._tlabels):
            for fn in self._delta_listeners:
                fn(changed, removed)
            if batch is not None:
                for bfn in self._batch_listeners:
                    bfn(batch)

    # -- in-flight accounting ------------------------------------------------------
    def _inflight_add(self, n: int) -> None:
        with self._inflight_lock:
            self._inflight += n

    # -- columnar apply ------------------------------------------------------------
    def _apply_columnar(self, cb: ColumnarRecords) -> None:
        """Fold → stat_batch → one commit_delta_batch → fan-out → ack."""
        reg = self.telemetry
        n = len(cb)
        with reg.trace("pipeline.apply", records=n, mdt=str(cb.mdt),
                       **self._tlabels):
            if self.counters is not None:
                self.counters.on_records(cb.records)
            with reg.trace("pipeline.fold", **self._tlabels):
                fold = fold_columnar(cb.fid, cb.type)
            entries: List[Entry] = []
            if fold.survivors.size:
                with self._fs_sem:               # bounded FS concurrency
                    with reg.trace("pipeline.stat",
                                   fids=int(fold.survivors.size),
                                   **self._tlabels):
                        entries = [e for e in _fs_stat_batch(
                            self.fs, fold.survivors.tolist())
                            if e is not None]
            removed = fold.removed.tolist()
            with self._db_sem:                    # bounded DB concurrency
                with reg.trace("pipeline.commit", entries=len(entries),
                               removed=len(removed), **self._tlabels):
                    self.catalog.commit_delta_batch(entries, removed)
            with self._processed_lock:
                self.processed += n
                if fold.dedup:
                    self.dedup_hits += fold.dedup
            reg.counter(
                "pipeline_events_folded", help="per-fid folds committed "
                "(records deduped per batch)", **self._tlabels
            ).inc(int(fold.survivors.size + fold.removed.size))
            if fold.annihilated.size:
                reg.counter(
                    "pipeline_annihilations", help="same-batch CREAT→UNLNK "
                    "pairs cancelled before materializing",
                    **self._tlabels).inc(int(fold.annihilated.size))
            batch = DeltaBatch(
                mdt=cb.mdt, seqs=cb.seq,
                changed=[e.fid for e in entries], removed=removed,
                entries=entries, dedup=fold.dedup,
                annihilated=fold.annihilated.tolist())
            self._notify(batch.changed, batch.removed, batch)
            self._acks[cb.mdt].complete_range(int(cb.seq[0]),
                                              int(cb.seq[-1]))

    # -- record -> catalog application (scalar oracle) -----------------------------
    def _apply_records(self, recs: List[ChangelogRecord]) -> None:
        """GET_INFO + DB_APPLY for one batch, then mark complete for ack.

        Records are folded per fid, last-in-record-order wins: repeated
        updates of one entry cost a single ``fs.stat``, and an ``UNLNK``
        following a ``CREAT`` of the same fid inside the batch results in a
        removal only (the short-lived entry is never materialized).
        """
        with self.telemetry.trace("pipeline.apply", records=len(recs),
                                  **self._tlabels):
            is_removal: Dict[int, bool] = {}  # fid -> last op kind, batch order
            for rec in recs:
                if self.counters is not None:
                    self.counters.on_record(rec)
                is_removal[rec.fid] = int(rec.type) in _RM
            entries: List[Entry] = []
            removals: List[int] = []
            for fid, rm in is_removal.items():
                if rm:
                    removals.append(fid)
                    continue
                with self._fs_sem:                   # bounded FS concurrency
                    e = self.fs.stat(fid)
                if e is not None:
                    entries.append(e)
            with self._db_sem:                        # bounded DB concurrency
                if entries:
                    self.catalog.upsert_batch(entries)  # durable before ack
                for fid in removals:
                    self.catalog.remove(fid)
            with self._processed_lock:
                self.processed += len(recs)
            self.telemetry.counter(
                "pipeline_events_folded", help="per-fid folds committed "
                "(records deduped per batch)", **self._tlabels
            ).inc(len(is_removal))
            changed = [e.fid for e in entries]
            batch = None
            if self._batch_listeners:
                batch = DeltaBatch(
                    mdt=recs[0].mdt, seqs=np.array([r.seq for r in recs]),
                    changed=changed, removed=removals, entries=entries,
                    dedup=len(recs) - len(is_removal), annihilated=[])
            self._notify(changed, removals, batch)
            self._acks[recs[0].mdt].complete([r.seq for r in recs])

    def _tag_records(self, recs: List[ChangelogRecord]) -> None:
        """Async mode stage 1: tag dirty + ack immediately after durable tag.

        Removals still apply synchronously (they can't be 'refreshed'
        later). The dirty tags land in the catalog as ONE vectorized
        ``update_fields_batch(dirty=1)`` — one sqlite commit for the whole
        batch instead of a write per record while holding the dirty lock.
        """
        removals = []
        folds = 0                 # committed work: new tags + removals
        with self._dirty_cv:
            new_tags: List[int] = []
            for rec in recs:
                if self.counters is not None:
                    self.counters.on_record(rec)
                if int(rec.type) in _RM:
                    removals.append(rec.fid)
                    self._dirty.discard(rec.fid)      # never refreshed post-rm
                    folds += 1
                elif rec.fid in self._dirty:
                    self.dedup_hits += 1              # folded into pending tag
                else:
                    self._dirty.add(rec.fid)
                    new_tags.append(rec.fid)
                    folds += 1
            if new_tags:
                # durable tag under the dirty lock (an updater must never
                # refresh-and-clear a fid whose tag hasn't landed), but
                # batched: one vectorized patch + one commit
                self.catalog.update_fields_batch(new_tags, dirty=1)
            self._dirty_cv.notify_all()               # wake updaters
        with self._db_sem:
            for fid in removals:
                self.catalog.remove(fid)
        with self._processed_lock:
            self.processed += len(recs)
        self.telemetry.counter(
            "pipeline_events_folded", help="per-fid folds committed "
            "(records deduped per batch)", **self._tlabels).inc(folds)
        # changed fids are notified by the updater after the actual refresh
        self._notify([], removals)
        self._acks[recs[0].mdt].complete([r.seq for r in recs])

    def _take_dirty(self) -> List[int]:
        """Pop one updater batch; counts it in-flight while held."""
        take = list(self._dirty)[: self.cfg.batch_size]
        if take:
            for fid in take:
                self._dirty.discard(fid)
            self._inflight_add(1)
        return take

    def _refresh(self, take: List[int]) -> None:
        """Updater stage 2: re-stat + upsert a popped dirty batch."""
        try:
            entries = []
            with self._fs_sem:
                for e in _fs_stat_batch(self.fs, take):
                    if e is not None:
                        e.dirty = False
                        entries.append(e)
            with self._db_sem:
                if entries:
                    self.catalog.upsert_batch(entries)
            self._notify([e.fid for e in entries], [])
        finally:
            self._inflight_add(-1)

    def _updater(self) -> None:
        """Background refresh of dirty-tagged entries (paper's 'updaters').

        Blocks on the dirty Condition — zero wakeups while the pipeline
        is idle (asserted via the span histograms in the tests) instead
        of the old fixed-interval polling.
        """
        while True:
            with self._dirty_cv:
                self._dirty_cv.wait_for(
                    lambda: self._dirty or self._stop.is_set())
                take = self._take_dirty()
            if not take:
                if self._stop.is_set():
                    return
                continue
            self.telemetry.counter(
                "pipeline_wakeups", help="reader/updater loop iterations "
                "that found work", thread="updater", **self._tlabels).inc()
            self._refresh(take)

    # -- driver ------------------------------------------------------------------
    def _handler(self) -> Tuple[Callable, bool]:
        """Active record handler + whether it takes ColumnarRecords."""
        if self.cfg.async_updates:
            return self._tag_records, False
        if self.cfg.columnar:
            return self._apply_columnar, True
        return self._apply_records, False

    def _adapt_quantum(self, mdt: int, stream: ChangelogStream,
                       apply_seconds: float) -> None:
        """Backpressure loop: one adjustment per applied batch, driven by
        the same cursor state the telemetry gauges export."""
        q = self._quantum[mdt]
        direction = None
        if apply_seconds > self.cfg.target_batch_seconds \
                and q > self.cfg.min_batch:
            q = max(self.cfg.min_batch, q // 2)     # ack latency degrading
            direction = "shrink"
        elif stream.pending() > q and q < self.cfg.max_batch \
                and stream.lag_seconds() <= self.cfg.lag_target:
            q = min(self.cfg.max_batch, q * 2)      # backlog rising, lag ok
            direction = "grow"
        if direction is not None:
            self._quantum[mdt] = q
            self.telemetry.gauge(
                "pipeline_batch_quantum", help="adaptive per-MDT read "
                "quantum", mdt=str(mdt), **self._tlabels).set(q)
            self.telemetry.counter(
                "pipeline_batch_adaptations", help="adaptive quantum "
                "transitions", mdt=str(mdt), direction=direction,
                **self._tlabels).inc()

    def _reader_columnar(self, mdt: int, stream: ChangelogStream) -> None:
        """One sharded reader per MDT: read → apply inline → adapt.

        Applying on the reader thread is the backpressure: the reader
        cannot read faster than the catalog commits, so the only queue in
        the system is the changelog itself (bounded by its ack cursor).
        """
        handler, takes_columnar = self._handler()
        wakeups = self.telemetry.counter(
            "pipeline_wakeups", help="reader/updater loop iterations that "
            "found work", thread=f"reader_mdt{mdt}", **self._tlabels)
        while True:
            cb = stream.read_columnar(max_records=self._quantum[mdt],
                                      timeout=60.0, stop=self._stop)
            if cb is None:
                if self._stop.is_set():
                    return
                continue
            wakeups.inc()
            self._inflight_add(1)
            try:
                t0 = time.perf_counter()
                handler(cb if takes_columnar else cb.records)
                dt = time.perf_counter() - t0
            finally:
                self._inflight_add(-1)
            self._adapt_quantum(mdt, stream, dt)

    def _reader(self, mdt: int, stream: ChangelogStream) -> None:
        """Oracle-mode reader: blocking read → bounded batch queue."""
        while not self._stop.is_set():
            recs = stream.read(max_records=self.cfg.batch_size,
                               timeout=60.0, stop=self._stop)
            if recs:
                self._batches.put(recs)

    def _worker(self) -> None:
        handler = self._tag_records if self.cfg.async_updates \
            else self._apply_records
        while True:
            recs = self._batches.get()
            if recs is None:                      # shutdown sentinel
                self._batches.task_done()
                return
            self._inflight_add(1)
            try:
                handler(recs)
            finally:
                self._inflight_add(-1)
                self._batches.task_done()

    def start(self) -> None:
        if self.cfg.columnar:
            # sharded per-MDT readers apply inline (tag_records in async
            # mode) — no intermediate batch queue, no worker pool
            self._threads = [
                threading.Thread(target=self._reader_columnar,
                                 args=(mdt, s), daemon=True)
                for mdt, s in self.streams.items()]
        else:
            self._threads = [
                threading.Thread(target=self._reader, args=(mdt, s),
                                 daemon=True)
                for mdt, s in self.streams.items()]
            self._threads += [threading.Thread(target=self._worker,
                                               daemon=True)
                              for _ in range(self.cfg.n_workers)]
        if self.cfg.async_updates:
            self._threads += [threading.Thread(target=self._updater,
                                               daemon=True)
                              for _ in range(self.cfg.n_updaters)]
        for t in self._threads:
            t.start()

    def total_pending(self) -> int:
        return sum(s.pending() for s in self.streams.values())

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every emitted record has been processed and acked.

        The in-flight counter closes the drain race: a worker holding a
        popped batch, or an updater holding fids it removed from
        ``_dirty`` before the refresh commits, keeps ``_inflight`` > 0 —
        ``pending()==0 and _batches.empty() and not _dirty`` alone would
        report drained while that refresh is still in flight.
        """
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.total_pending() == 0 and self._batches.empty() \
                    and not self._dirty and self._inflight == 0:
                return True
            time.sleep(0.01)
        return False

    def stop(self) -> None:
        self._stop.set()
        for s in self.streams.values():
            s.wake()                            # unblock condition reads
        if not self.cfg.columnar:
            for _ in range(self.cfg.n_workers):
                self._batches.put(None)         # one sentinel per worker
        with self._dirty_cv:
            self._dirty_cv.notify_all()         # unblock updaters
        for t in self._threads:
            t.join(timeout=5)

    def process_once(self, max_records: int = 4096) -> int:
        """Synchronous single-shot processing (no threads) — for tests.

        With a hub attached, streams are drained via the fair round-robin
        sweep (one quantum per MDT per pass)."""
        handler, takes_columnar = self._handler()
        total = 0
        while total < max_records:
            quantum = min(max_records - total, self.cfg.batch_size)
            if isinstance(self.stream, ChangelogHub):
                batches = self.stream.read_round_robin(quantum=quantum)
            else:
                cb = self.stream.read_columnar(max_records=quantum)
                batches = [cb] if cb is not None else []
            if not batches:
                break
            for cb in batches:
                handler(cb if takes_columnar else cb.records)
                total += len(cb)
        if self.cfg.async_updates:
            # run one updater sweep inline
            while self._dirty:
                with self._dirty_cv:
                    take = self._take_dirty()
                if take:
                    self._refresh(take)
        return total
