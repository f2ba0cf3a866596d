"""Transactional, persistent changelog streams — MDT ChangeLog analogue (C3).

Contract reproduced from the paper (SII-C2):

* records are appended to a per-MDT stream with monotonically increasing
  sequence numbers and kept on persistent storage;
* a consumer registers, reads batches, and **acks** a sequence number only
  after the corresponding change has been committed to its own database;
* records are purged only once acked, so no event is ever lost — even if the
  consumer crashes mid-processing, unacked records are re-delivered on
  restart.

A stream supports multiple named **subscribers**, each with its own read
cursor and ack watermark (Lustre's ``changelog_register`` users analogue):
the event pipeline mirrors records into the catalog under the default
subscriber while e.g. the policy engine follows the same stream under its
own cursor to maintain incremental match state. Records are purged only
once *every* subscriber has acked them.

Persistence is an append-only JSONL file per stream (fsync on append batch)
plus a tiny ack cursor file (an int for the lone default subscriber, a JSON
object once named subscribers exist). DNE is modelled by running one stream
per MDT.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from itertools import islice
from typing import Deque, Dict, Iterable, List, Optional

import numpy as np

from .telemetry import MetricRegistry
from .types import ChangelogRecord, ChangelogType

DEFAULT_SUBSCRIBER = "main"


class ColumnarRecords:
    """One read batch decoded into aligned numpy columns.

    The ingest hot path works on these arrays only — ``seq``/``fid``/
    ``type``/``time`` — so from the reader onward no per-event Python
    dict is ever built (the original :class:`ChangelogRecord` objects
    ride along solely for the per-record uid/jobid counters and the
    record-at-a-time differential oracle).
    """

    __slots__ = ("mdt", "seq", "fid", "type", "time", "records")

    def __init__(self, mdt: int, seq: np.ndarray, fid: np.ndarray,
                 type_: np.ndarray, time_: np.ndarray,
                 records: List[ChangelogRecord]) -> None:
        self.mdt = mdt
        self.seq = seq
        self.fid = fid
        self.type = type_
        self.time = time_
        self.records = records

    def __len__(self) -> int:
        return self.seq.shape[0]

    @classmethod
    def from_records(cls, recs: List[ChangelogRecord],
                     mdt: int) -> "ColumnarRecords":
        """Columnar decode: four vectorized passes, no per-event dicts."""
        n = len(recs)
        seq = np.fromiter((r.seq for r in recs), dtype=np.int64, count=n)
        fid = np.fromiter((r.fid for r in recs), dtype=np.int64, count=n)
        typ = np.fromiter((int(r.type) for r in recs), dtype=np.int8,
                          count=n)
        tim = np.fromiter((r.time for r in recs), dtype=np.float64, count=n)
        return cls(mdt, seq, fid, typ, tim, recs)


class _Subscriber:
    """Cursor/ack bookkeeping for one registered consumer."""

    __slots__ = ("name", "read_cursor", "acked", "durable")

    def __init__(self, name: str, read_cursor: int, acked: int,
                 durable: bool = True) -> None:
        self.name = name
        self.read_cursor = read_cursor
        self.acked = acked
        self.durable = durable


class ChangelogStream:
    """One MDT's changelog: producer side (append) + consumer side (read/ack)."""

    def __init__(self, mdt: int = 0, persist_dir: Optional[str] = None,
                 fsync: bool = False) -> None:
        self.mdt = mdt
        self._lock = threading.Condition()
        self._records: Deque[ChangelogRecord] = deque()
        self._next_seq = 1
        self._subs: Dict[str, _Subscriber] = {
            DEFAULT_SUBSCRIBER: _Subscriber(DEFAULT_SUBSCRIBER, 0, 0)
        }
        self._recovered_acks: Dict[str, int] = {}
        self._persist_dir = persist_dir
        self._fsync = fsync
        self._fh = None
        self._closed = False
        # telemetry (bind_telemetry): emitted-events counter + live
        # backlog/lag callback gauges; None until a pipeline (or caller)
        # binds a registry — emit stays a no-op-cost path until then
        self.telemetry: Optional[MetricRegistry] = None
        self._tclock = time.time
        self._emitted = None
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            self._log_path = os.path.join(persist_dir, f"changelog_mdt{mdt}.jsonl")
            self._ack_path = os.path.join(persist_dir, f"changelog_mdt{mdt}.ack")
            self._recover()
            self._fh = open(self._log_path, "a", encoding="utf-8")

    # -- persistence -----------------------------------------------------------
    def _recover(self) -> None:
        """Reload unacked records after a crash (paper: no event loss)."""
        acks: Dict[str, int] = {}
        if os.path.exists(self._ack_path):
            with open(self._ack_path, "r", encoding="utf-8") as f:
                txt = f.read().strip()
            if txt:
                try:
                    acks = {DEFAULT_SUBSCRIBER: int(txt)}
                except ValueError:
                    acks = {str(k): int(v) for k, v in json.loads(txt).items()}
        self._recovered_acks = acks
        acked = acks.get(DEFAULT_SUBSCRIBER, 0)
        main = self._subs[DEFAULT_SUBSCRIBER]
        main.acked = acked
        floor = min(acks.values()) if acks else 0
        if os.path.exists(self._log_path):
            with open(self._log_path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    d = json.loads(line)
                    rec = ChangelogRecord(
                        seq=d["seq"], type=ChangelogType(d["type"]),
                        fid=d["fid"], parent_fid=d.get("parent_fid", -1),
                        name=d.get("name", ""), time=d.get("time", 0.0),
                        uid=d.get("uid", ""), jobid=d.get("jobid", ""),
                        mdt=self.mdt, attrs=d.get("attrs"))
                    if rec.seq > floor:
                        self._records.append(rec)
                    self._next_seq = max(self._next_seq, rec.seq + 1)
        # re-delivery: each reader restarts from its oldest unacked record
        main.read_cursor = acked

    def _persist_records(self, recs: List[ChangelogRecord]) -> None:
        if self._fh is None:
            return
        for r in recs:
            self._fh.write(json.dumps({
                "seq": r.seq, "type": int(r.type), "fid": r.fid,
                "parent_fid": r.parent_fid, "name": r.name, "time": r.time,
                "uid": r.uid, "jobid": r.jobid, "attrs": r.attrs}) + "\n")
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    def _persist_acks(self) -> None:
        if not self._persist_dir:
            return
        tmp = self._ack_path + ".tmp"
        acks = {name: ack for name, ack in self._recovered_acks.items()
                if name not in self._subs}      # not yet re-registered
        # ephemeral subscribers die with their process: persisting their ack
        # would pin the purge floor forever after a restart renames them
        acks.update({name: s.acked for name, s in self._subs.items()
                     if s.durable})
        with open(tmp, "w", encoding="utf-8") as f:
            if len(acks) == 1:
                f.write(str(acks[DEFAULT_SUBSCRIBER]))
            else:
                f.write(json.dumps(acks))
        os.replace(tmp, self._ack_path)

    # -- telemetry ---------------------------------------------------------------
    def bind_telemetry(self, registry: MetricRegistry,
                       clock=time.time) -> "ChangelogStream":
        """Land this stream's series in ``registry``: a
        ``changelog_events_emitted{mdt=}`` counter plus collection-time
        ``changelog_backlog`` / ``changelog_lag_seconds`` gauges, one
        series per subscriber — live cursor state read at scrape time,
        no write on the emit/ack hot paths. Idempotent per registry;
        an :class:`EventPipeline` binds its catalog's registry
        automatically."""
        if self.telemetry is registry:
            return self
        self.telemetry = registry
        self._tclock = clock
        self._emitted = registry.counter(
            "changelog_events_emitted", help="records appended to the MDT "
            "stream", mdt=str(self.mdt))
        mdt = str(self.mdt)
        registry.register_callback(
            f"changelog_backlog_mdt{self.mdt}",
            lambda: [({"mdt": mdt, "subscriber": name}, depth)
                     for name, depth in self._cursor_depths()],
            help="unacked records behind each subscriber cursor")
        registry.register_callback(
            f"changelog_lag_seconds_mdt{self.mdt}",
            lambda: [({"mdt": mdt, "subscriber": name},
                      self.lag_seconds(name))
                     for name in self.subscribers()],
            help="age of the oldest unacked record per subscriber")
        return self

    def _cursor_depths(self) -> List[tuple]:
        with self._lock:
            head = self._next_seq - 1
            return [(name, head - s.acked) for name, s in self._subs.items()]

    def backlog(self, subscriber: Optional[str] = None) -> int:
        """Alias of :meth:`pending` under the telemetry vocabulary."""
        return self.pending(subscriber)

    def lag_seconds(self, subscriber: Optional[str] = None) -> float:
        """Age of the subscriber's oldest unacked record (0.0 when fully
        caught up, or when records carry no timestamps)."""
        with self._lock:
            sub = self._sub(subscriber)
            if not self._records or self._records[-1].seq <= sub.acked:
                return 0.0
            idx = max(0, sub.acked - self._records[0].seq + 1)
            if idx >= len(self._records):
                return 0.0
            t = self._records[idx].time
            if not t:
                return 0.0
            return max(0.0, self._tclock() - t)

    # -- subscriber registry -----------------------------------------------------
    def subscribe(self, name: str, from_start: bool = False,
                  durable: bool = True) -> str:
        """Register a named consumer with its own read/ack cursor.

        A new subscriber starts at the stream head (future records only)
        unless ``from_start`` is set, in which case it sees every retained
        record. Re-subscribing an existing (or crash-recovered) name resumes
        from its persisted ack watermark. ``durable=False`` keeps the
        cursor out of the persisted ack file — for per-process consumers
        that rebuild their own state after a restart anyway — so a dead
        instance can never pin the purge floor. Returns the name.
        """
        if name == DEFAULT_SUBSCRIBER:
            return name
        with self._lock:
            if name in self._subs:
                return name
            if name in self._recovered_acks:
                start = self._recovered_acks.pop(name)   # resumed: consumed
            elif from_start:
                start = 0
            else:
                start = self._next_seq - 1
            self._subs[name] = _Subscriber(name, start, start,
                                           durable=durable)
            self._persist_acks()
            return name

    def unsubscribe(self, name: str) -> None:
        """Drop a named subscriber; records it held back become purgeable."""
        if name == DEFAULT_SUBSCRIBER:
            raise ValueError("cannot unsubscribe the default consumer")
        with self._lock:
            dropped = self._subs.pop(name, None) is not None
            # a crash-recovered ack must go too, or it would resurrect in
            # the ack file and pin the purge floor forever
            dropped |= self._recovered_acks.pop(name, None) is not None
            if dropped:
                self._purge()
                self._persist_acks()

    def subscribers(self) -> List[str]:
        with self._lock:
            return list(self._subs)

    def _sub(self, name: Optional[str]) -> _Subscriber:
        sub = self._subs.get(name or DEFAULT_SUBSCRIBER)
        if sub is None:
            raise KeyError(f"unknown changelog subscriber {name!r}")
        return sub

    # -- producer ----------------------------------------------------------------
    def emit(self, type: ChangelogType, fid: int, **kw) -> ChangelogRecord:
        with self._lock:
            rec = ChangelogRecord(seq=self._next_seq, type=type, fid=fid,
                                  mdt=self.mdt, **kw)
            self._next_seq += 1
            self._records.append(rec)
            self._persist_records([rec])
            if self._emitted is not None:
                self._emitted.inc()
            self._lock.notify_all()
            return rec

    def emit_batch(self, recs: Iterable[ChangelogRecord]) -> None:
        with self._lock:
            out = []
            for r in recs:
                r.seq = self._next_seq
                r.mdt = self.mdt
                self._next_seq += 1
                self._records.append(r)
                out.append(r)
            self._persist_records(out)
            if self._emitted is not None and out:
                self._emitted.inc(len(out))
            self._lock.notify_all()

    # -- consumer -----------------------------------------------------------------
    def read(self, max_records: int = 1024, timeout: Optional[float] = None,
             subscriber: Optional[str] = None,
             stop: Optional[threading.Event] = None) -> List[ChangelogRecord]:
        """Read the next batch past the subscriber's cursor (does NOT ack).

        Retained records are dense in seq and purged only from the front,
        so the cursor position is an index: a read costs O(position +
        batch), not O(backlog) — a lagging subscriber (e.g. an idle policy
        engine) cannot degrade the main consumer's read loop.

        ``timeout=None`` returns immediately when nothing is pending; pass
        a timeout (or ``float('inf')``-like large value) to block on the
        stream's condition variable until a record is emitted — no
        polling. A blocked read wakes on emit, :meth:`close`, :meth:`wake`,
        or when the optional ``stop`` event is set (checked only at wakeup
        — pair it with :meth:`wake` for prompt shutdown).
        """
        with self._lock:
            sub = self._sub(subscriber)
            if timeout is not None:
                self._lock.wait_for(
                    lambda: self._closed
                    or (stop is not None and stop.is_set())
                    or (self._records
                        and self._records[-1].seq > sub.read_cursor),
                    timeout=timeout)
            if not self._records or self._records[-1].seq <= sub.read_cursor:
                return []
            start = max(0, sub.read_cursor - self._records[0].seq + 1)
            out = list(islice(self._records, start, start + max_records))
            if out:
                sub.read_cursor = out[-1].seq
            return out

    def read_columnar(self, max_records: int = 1024,
                      timeout: Optional[float] = None,
                      subscriber: Optional[str] = None,
                      stop: Optional[threading.Event] = None
                      ) -> Optional[ColumnarRecords]:
        """:meth:`read`, decoded to a :class:`ColumnarRecords` batch.

        Returns ``None`` instead of an empty batch so callers can
        distinguish 'nothing pending' without touching numpy.
        """
        recs = self.read(max_records=max_records, timeout=timeout,
                         subscriber=subscriber, stop=stop)
        if not recs:
            return None
        return ColumnarRecords.from_records(recs, self.mdt)

    def wake(self) -> None:
        """Wake every blocked :meth:`read` (shutdown path: set the stop
        event the readers were given, then call this)."""
        with self._lock:
            self._lock.notify_all()

    @property
    def acked(self) -> int:
        """Highest acknowledged sequence number (default consumer)."""
        with self._lock:
            return self._subs[DEFAULT_SUBSCRIBER].acked

    def acked_of(self, subscriber: str) -> int:
        with self._lock:
            return self._sub(subscriber).acked

    def _purge(self) -> None:
        floor = min(s.acked for s in self._subs.values())
        for name, ack in self._recovered_acks.items():
            if name not in self._subs:          # crashed subscriber, not back yet
                floor = min(floor, ack)
        while self._records and self._records[0].seq <= floor:
            self._records.popleft()

    def ack(self, seq: int, subscriber: Optional[str] = None) -> None:
        """Acknowledge records up to ``seq`` for one subscriber; records are
        purged once every subscriber has acked them."""
        with self._lock:
            sub = self._sub(subscriber)
            # clamp to emitted seqs: acking past the head must not swallow
            # records emitted later
            sub.acked = min(max(sub.acked, seq), self._next_seq - 1)
            sub.read_cursor = max(sub.read_cursor, sub.acked)
            self._purge()
            self._persist_acks()

    def reset_cursor(self, subscriber: Optional[str] = None) -> None:
        """Simulate consumer restart: unacked records are re-delivered."""
        with self._lock:
            sub = self._sub(subscriber)
            sub.read_cursor = sub.acked

    def pending(self, subscriber: Optional[str] = None) -> int:
        """Unacked record count — O(1): seqs are dense and retention always
        covers (purge floor, head] ⊇ (acked, head]."""
        with self._lock:
            sub = self._sub(subscriber)
            return self._next_seq - 1 - sub.acked

    def close(self) -> None:
        """Close the stream (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self._lock.notify_all()


class ChangelogHub:
    """All MDT streams of a (possibly DNE) filesystem."""

    def __init__(self, n_mdts: int = 1, persist_dir: Optional[str] = None,
                 fsync: bool = False) -> None:
        self.streams: Dict[int, ChangelogStream] = {
            i: ChangelogStream(i, persist_dir, fsync) for i in range(n_mdts)
        }
        self._rr = 0          # rotating round-robin start cursor
        self._closed = False

    def stream(self, mdt: int = 0) -> ChangelogStream:
        return self.streams[mdt]

    def subscribe(self, name: str, from_start: bool = False) -> str:
        """Register ``name`` on every MDT stream."""
        for s in self.streams.values():
            s.subscribe(name, from_start=from_start)
        return name

    def total_pending(self) -> int:
        return sum(s.pending() for s in self.streams.values())

    def read_round_robin(self, quantum: int = 1024,
                         subscriber: Optional[str] = None
                         ) -> List[ColumnarRecords]:
        """One fair sweep over every MDT stream: up to ``quantum`` records
        from each, visiting streams in rotating order so a storming MDT
        can never starve the others — per sweep, every stream with
        pending records contributes a batch, so a quiet stream's lag is
        bounded by one quantum regardless of how deep another stream's
        backlog grows. Returns the non-empty batches in visit order.
        """
        mdts = sorted(self.streams)
        n = len(mdts)
        start = self._rr % n if n else 0
        self._rr += 1
        out: List[ColumnarRecords] = []
        for i in range(n):
            s = self.streams[mdts[(start + i) % n]]
            cb = s.read_columnar(max_records=quantum, subscriber=subscriber)
            if cb is not None:
                out.append(cb)
        return out

    def wake(self) -> None:
        for s in self.streams.values():
            s.wake()

    def close(self) -> None:
        """Close every stream (idempotent — safe to call more than once)."""
        if self._closed:
            return
        self._closed = True
        for s in self.streams.values():
            s.close()
