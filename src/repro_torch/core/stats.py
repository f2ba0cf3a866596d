"""Pre-aggregated, on-the-fly statistics (C6) — the O(1) ``rbh-report`` path.

The paper: *"Commonly used statistics are pre-generated in the database.
They are computed on-the-fly as entries are updated, so the following
information is always available: statistics per object type, per user, per
group, per migration status and file size profile."*

:class:`StatsAggregator` subscribes to catalog delta hooks — every
insert/update/remove adjusts counters incrementally, so report queries never
scan entries. Also implements the paper's SIII-C *future* counters as
beyond-paper features: per-user and per-jobid changelog counters and
per-directory-level usage counters (instant ``du``).

Counter updates can run **synchronously** (paper default; measurably slows
ingest) or be drained **asynchronously** by a background thread from a
bounded delta queue (the paper's proposed fix; stats lag slightly but ingest
is faster) — both modes are benchmarked in ``benchmarks/bench_changelog.py``.

The scalar per-record dict fold here is the **differential oracle** for the
on-device analytics subsystem (:class:`~repro_torch.core.profiles.ProfileCube`):
pass ``cube=`` to serve every report from the incrementally-maintained
profile cube instead (deltas forward to it, reports reduce over it), while
this scalar path stays available for byte-identical cross-checks.

**Shared delta fan-out contract.** Each consumer of catalog deltas claims
exactly one feed. A cube-backed aggregator forwards its own hook into the
cube (claiming the cube's feed); when the cube is instead served by the
device column store cube plane
(``ProfileCube.attach_device_store``), the *store's* hook is the single
consumer and fans one dirty batch out to resident columns, partial cubes
and plane mirrors in the same scatter pass — so one pipeline delta batch
is applied exactly once everywhere (see :mod:`repro_torch.core.profiles`).
"""
from __future__ import annotations

import queue
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .types import (ChangelogRecord, FsType, HsmState, SIZE_PROFILE_LABELS,
                    size_profile_bucket)


class _Acc:
    """count / volume (logical bytes) / spc_used (allocated) accumulator."""

    __slots__ = ("count", "volume", "spc_used")

    def __init__(self) -> None:
        self.count = 0
        self.volume = 0
        self.spc_used = 0

    def add(self, sign: int, size: int, blocks: int) -> None:
        self.count += sign
        self.volume += sign * size
        self.spc_used += sign * blocks

    def as_dict(self) -> dict:
        avg = self.volume / self.count if self.count else 0.0
        return {"count": self.count, "volume": self.volume,
                "spc_used": self.spc_used, "avg_size": avg}


class StatsAggregator:
    """O(1) pre-aggregated stats, keyed per user/group/type/hsm-state/size-bin."""

    def __init__(self, strings, async_mode: bool = False,
                 queue_size: int = 1 << 16, cube=None) -> None:
        self.strings = strings
        self._lock = threading.Lock()
        # cube-backed mode: deltas forward to the ProfileCube, reports
        # reduce over it — the scalar dicts below then stay empty. The
        # forwarding hook becomes the cube's one delta feed (wiring
        # attach() as well would double-count; claiming it here raises).
        self._cube = cube
        if cube is not None:
            cube.claim_delta_feed("StatsAggregator(cube=...)")
        # (owner_code, type) -> _Acc ; (group_code, type) -> _Acc ; type -> _Acc
        self.per_user: Dict[Tuple[int, int], _Acc] = defaultdict(_Acc)
        self.per_group: Dict[Tuple[int, int], _Acc] = defaultdict(_Acc)
        self.per_type: Dict[int, _Acc] = defaultdict(_Acc)
        self.per_hsm: Dict[int, _Acc] = defaultdict(_Acc)
        # (owner_code, size_bucket) -> count : per-user file size profile
        self.size_profile: Dict[Tuple[int, int], int] = defaultdict(int)
        self._total = _Acc()
        self.async_mode = async_mode
        self._q: Optional[queue.Queue] = None
        self._drainer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if async_mode:
            self._q = queue.Queue(maxsize=queue_size)
            self._drainer = threading.Thread(target=self._drain, daemon=True)
            self._drainer.start()

    # -- delta hook (wired into Catalog.add_delta_hook) -----------------------
    def on_delta(self, old, new) -> None:
        if self.async_mode:
            self._q.put((old, new))
        else:
            self._apply(old, new)

    def on_delta_batch(self, pairs) -> None:
        """Batch variant of :meth:`on_delta` (register it as the ``batch=``
        arm of ``Catalog.add_delta_hook``): one committed delta batch folds
        under ONE lock acquisition instead of one per mutation."""
        if self.async_mode:
            for p in pairs:
                self._q.put(p)
            return
        if self._cube is not None:
            self._cube.on_delta_batch(pairs)
            return
        with self._lock:
            fold = self._fold
            for old, new in pairs:
                if old is not None:
                    fold(-1, *old)
                if new is not None:
                    fold(+1, *new)

    def _drain(self) -> None:
        while not self._stop.is_set() or (self._q is not None and not self._q.empty()):
            try:
                old, new = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            self._apply(old, new)
            self._q.task_done()

    def flush(self) -> None:
        """Wait until asynchronously queued deltas are folded in."""
        if self._q is not None:
            self._q.join()

    def close(self) -> None:
        self._stop.set()
        if self._drainer is not None:
            self._drainer.join(timeout=5)

    def _apply(self, old, new) -> None:
        if self._cube is not None:
            self._cube.on_delta(old, new)
            return
        with self._lock:
            if old is not None:
                self._fold(-1, *old)
            if new is not None:
                self._fold(+1, *new)

    def _fold(self, sign: int, fid: int, owner: int, group: int, type_: int,
              size: int, blocks: int, hsm: int, atime: float) -> None:
        # fid/atime ride the Delta for the profile cube (shard routing +
        # age buckets); the flat scalar counters ignore them
        self.per_user[(owner, type_)].add(sign, size, blocks)
        self.per_group[(group, type_)].add(sign, size, blocks)
        self.per_type[type_].add(sign, size, blocks)
        self.per_hsm[hsm].add(sign, size, blocks)
        self._total.add(sign, size, blocks)
        if type_ == int(FsType.FILE):
            self.size_profile[(owner, size_profile_bucket(size))] += sign

    @property
    def total(self) -> _Acc:
        if self._cube is not None:
            acc = _Acc()
            count, volume, spc = self._cube.totals()
            acc.count, acc.volume, acc.spc_used = count, volume, spc
            return acc
        return self._total

    # -- O(1) report queries -----------------------------------------------------
    def report_user(self, user: str) -> List[dict]:
        """`rbh-report -u user`: per-type count/volume/avg — O(#types)."""
        if self._cube is not None:
            return self._cube.report_user(user)
        code = self.strings.code_of(user)
        if code is None:
            return []
        out = []
        with self._lock:
            for t in sorted(FsType, key=int):
                acc = self.per_user.get((code, int(t)))
                if acc and acc.count:
                    d = acc.as_dict()
                    d.update(user=user, type=t.name.lower())
                    out.append(d)
        return out

    def report_group(self, grp: str) -> List[dict]:
        if self._cube is not None:
            return self._cube.report_group(grp)
        code = self.strings.code_of(grp)
        if code is None:
            return []
        out = []
        with self._lock:
            for t in sorted(FsType, key=int):
                acc = self.per_group.get((code, int(t)))
                if acc and acc.count:
                    d = acc.as_dict()
                    d.update(group=grp, type=t.name.lower())
                    out.append(d)
        return out

    def report_types(self) -> Dict[str, dict]:
        if self._cube is not None:
            return self._cube.report_types()
        with self._lock:
            return {FsType(t).name.lower(): a.as_dict()
                    for t, a in self.per_type.items() if a.count}

    def report_hsm(self) -> Dict[str, dict]:
        if self._cube is not None:
            return self._cube.report_hsm()
        with self._lock:
            return {HsmState(h).name.lower(): a.as_dict()
                    for h, a in self.per_hsm.items() if a.count}

    def user_size_profile(self, user: str) -> Dict[str, int]:
        if self._cube is not None:
            return self._cube.user_size_profile(user)
        code = self.strings.code_of(user)
        out = {lbl: 0 for lbl in SIZE_PROFILE_LABELS}
        if code is None:
            return out
        with self._lock:
            for (ucode, bucket), n in self.size_profile.items():
                if ucode == code and n:
                    out[SIZE_PROFILE_LABELS[bucket]] += n
        return out

    def top_users(self, by: str = "volume", k: int = 10,
                  type_: FsType = FsType.FILE) -> List[dict]:
        """Rank users without scanning entries (aggregates only)."""
        if self._cube is not None:
            return self._cube.top_users(by=by, k=k, type_=type_)
        with self._lock:
            rows = []
            for (ucode, t), acc in self.per_user.items():
                if t != int(type_) or not acc.count:
                    continue
                d = acc.as_dict()
                d["user"] = self.strings.lookup(ucode)
                rows.append(d)
        rows.sort(key=lambda d: d.get(by, 0), reverse=True)
        return rows[:k]


class ChangelogCounters:
    """Per-type / per-user / per-jobid changelog counters (SIII-C)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.per_type: Dict[int, int] = defaultdict(int)
        self.per_user: Dict[str, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
        self.per_job: Dict[str, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
        self.total = 0

    def on_record(self, rec: ChangelogRecord) -> None:
        with self._lock:
            self.total += 1
            self.per_type[int(rec.type)] += 1
            if rec.uid:
                self.per_user[rec.uid][int(rec.type)] += 1
            if rec.jobid:
                self.per_job[rec.jobid][int(rec.type)] += 1

    def on_records(self, recs) -> None:
        """Count a whole read batch under one lock (columnar ingest)."""
        with self._lock:
            per_type, per_user, per_job = \
                self.per_type, self.per_user, self.per_job
            self.total += len(recs)
            for rec in recs:
                t = int(rec.type)
                per_type[t] += 1
                if rec.uid:
                    per_user[rec.uid][t] += 1
                if rec.jobid:
                    per_job[rec.jobid][t] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "total": self.total,
                "per_type": dict(self.per_type),
                "per_user": {u: dict(c) for u, c in self.per_user.items()},
                "per_job": {j: dict(c) for j, c in self.per_job.items()},
            }


class DirUsage:
    """Per-directory recursive usage counters up to ``max_depth`` (SIII-C).

    Makes ``du`` at shallow namespace levels O(1): each file delta is
    propagated to its ancestor directories (bounded by ``max_depth``).
    Ancestors are resolved from entry paths, so no catalog walk is needed.

    **Depth contract**: attribution stops at ``max_depth`` path components
    — a directory deeper than that accumulates nothing, so a naive lookup
    there would silently report zero usage and disagree with the
    index-backed ``Reports.du``. :meth:`du` therefore routes queries
    deeper than ``max_depth`` to ``deep_du`` (wire it to ``Reports.du``
    via :meth:`Reports.bind_dir_usage`) and raises if no deep path is
    bound, rather than returning a silently-truncated answer.
    """

    def __init__(self, max_depth: int = 3, deep_du=None) -> None:
        self.max_depth = max_depth
        # fallback for paths deeper than max_depth: callable(path) -> dict
        # in Reports.du shape ({count, files, volume, spc_used})
        self.deep_du = deep_du
        self._lock = threading.Lock()
        self.usage: Dict[str, _Acc] = defaultdict(_Acc)

    @staticmethod
    def _ancestors(path: str, max_depth: int) -> List[str]:
        parts = [p for p in path.split("/") if p]
        out = ["/"]
        for i in range(min(len(parts) - 1, max_depth)):
            out.append("/" + "/".join(parts[: i + 1]))
        return out

    def on_file(self, sign: int, path: str, size: int, blocks: int) -> None:
        with self._lock:
            for d in self._ancestors(path, self.max_depth):
                self.usage[d].add(sign, size, blocks)

    def du(self, path: str) -> dict:
        parts = [p for p in path.split("/") if p]
        path = "/" + "/".join(parts) if parts else "/"
        if len(parts) > self.max_depth:
            # counters were never attributed this deep — answer from the
            # sorted-prefix-range index instead of a silent zero
            if self.deep_du is None:
                raise ValueError(
                    f"path {path!r} is deeper than max_depth="
                    f"{self.max_depth} and no deep_du fallback is bound "
                    "(see Reports.bind_dir_usage)")
            deep = self.deep_du(path)
            files = deep.get("files", deep.get("count", 0))
            return {"count": files, "volume": deep["volume"],
                    "spc_used": deep["spc_used"],
                    "avg_size": deep["volume"] / files if files else 0.0}
        with self._lock:
            return self.usage[path].as_dict() if path in self.usage else \
                {"count": 0, "volume": 0, "spc_used": 0, "avg_size": 0.0}
