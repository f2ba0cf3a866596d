"""`rbh-report` / `rbh-find` / `rbh-du` clones (C6, C9) — answer from the DB.

All queries here run against the catalog (vectorized column masks), the
pre-aggregated stats, or the on-device profile cube — never against the
filesystem, which is the paper's point: *"all these metadata queries do not
generate extra load on the filesystem"*.

With :meth:`Reports.attach_device_store`, ``find``/``top_files``/``du``
additionally go **store-resident**: predicates evaluate and top-k/range
aggregates reduce over the resident ``(D, C+1+4, Rp)`` tensor of a
:class:`~repro_torch.core.device_store.DeviceColumnStore` on its device,
and only the winning rows' paths come back through the store's host
mirrors — a warm query never calls ``Catalog.arrays()``.
Queries the resident plane cannot serve (glob predicates, non-kernel
columns) raise :class:`~repro_torch.core.policy.PolicyError` inside the store
and fall back to the host folds below, which also stay on as the
byte-identical differential oracle (``tests/test_torch_mesh_reports.py``).
The fallback is recorded in :attr:`Reports.last_fallback_reason` —
cleared again by the next store-served success, so the telemetry always
describes the *most recent* query, not a sticky historical one.

With :meth:`Reports.attach_grants`, every serving query additionally
accepts ``subject=`` (multi-tenant scoping): the store path ANDs that
subject's pre-materialized permission bitset into the kernel's match
mask (``DeviceColumnStore`` permissions plane), and the host folds
filter by :meth:`~repro_torch.core.grants.GrantTable.visible_mask` — the two
stay byte-identical (``tests/core/test_tenant_scoping.py``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .catalog import Catalog
from .policy import Expr, KERNEL_COLUMNS, PolicyError, parse_expr
from .profiles import ProfileCube
from .stats import DirUsage, StatsAggregator
from .telemetry import counter_attr, slug, state_attr
from .types import FsType, format_size


class _PathIndex:
    """Sorted path column + subtree prefix sums for O(log n) ``du``.

    Built once per **shard** version: every path under ``prefix/`` is
    contiguous in the sorted order — bounded below by ``prefix + "/"`` and
    above by ``prefix + "0"`` ('0' is the successor of '/') — so a subtree
    aggregate is two binary searches into precomputed prefix sums instead
    of a per-path scan.
    """

    def __init__(self, cols) -> None:
        paths = np.asarray(cols["_paths"])
        order = np.argsort(paths, kind="stable")
        self.spaths = paths[order]
        is_file = (cols["type"][order] == int(FsType.FILE))
        fsize = np.where(is_file, cols["size"][order], 0)
        fblocks = np.where(is_file, cols["blocks"][order], 0)
        # leading 0 so any [lo, hi) range sum is csum[hi] - csum[lo]
        self.csize = np.concatenate([[0], np.cumsum(fsize)])
        self.cblocks = np.concatenate([[0], np.cumsum(fblocks)])
        self.cfiles = np.concatenate([[0], np.cumsum(is_file.astype(np.int64))])

    def _range(self, lo_key: str, hi_key: str, side_hi: str = "left") -> dict:
        lo = int(np.searchsorted(self.spaths, lo_key, side="left"))
        hi = int(np.searchsorted(self.spaths, hi_key, side=side_hi))
        return {
            "count": hi - lo,
            "files": int(self.cfiles[hi] - self.cfiles[lo]),
            "volume": int(self.csize[hi] - self.csize[lo]),
            "spc_used": int(self.cblocks[hi] - self.cblocks[lo]),
        }

    def du(self, path_prefix: str) -> dict:
        prefix = path_prefix.rstrip("/")
        sub = self._range(prefix + "/", prefix + "0")
        root = self._range(prefix, prefix, side_hi="right")
        return {k: sub[k] + root[k] for k in sub}


class Reports:
    # serving counters, registry-backed (attach_device_store): they
    # mirror the engine's RunReport telemetry — store_served /
    # host_served tally where each query answered, index_rebuilds counts
    # sorted-path index rebuilds, last_fallback_reason says why the most
    # recent query fell back to the host fold (None = none did)
    store_served = counter_attr(
        "reports_store_served", "queries answered mesh-resident")
    host_served = counter_attr(
        "reports_host_served", "queries answered by host folds")
    index_rebuilds = counter_attr(
        "reports_index_rebuilds", "sorted-path index rebuilds")
    last_fallback_reason = state_attr(
        "reports_last_fallback_reason",
        "why the most recent query fell back to the host fold")

    def __init__(self, catalog: Catalog, stats: Optional[StatsAggregator] = None,
                 clock=time.time, profiles: Optional[ProfileCube] = None
                 ) -> None:
        self.catalog = catalog
        self.stats = stats
        self.profiles = profiles
        self.clock = clock
        self.telemetry = catalog.telemetry
        self._tlabels = {"reports": catalog.telemetry.instance("reports")}
        # one path index per shard, rebuilt only when THAT shard's version
        # ticked — churn in one shard leaves the other indexes warm
        self._pindexes: Dict[int, _PathIndex] = {}
        self._pversions: Dict[int, int] = {}
        self.index_rebuilds = 0
        self.device_store = None
        self.store_served = 0
        self.host_served = 0
        self.last_fallback_reason = None
        # multi-tenant scoping (attach_grants): the shared GrantTable
        # behind every subject= query
        self.grants = None

    def attach_device_store(self, store) -> "Reports":
        """Serve ``find``/``top_files``/``du`` from a
        device column store.

        Enables the store's reports plane (sorted-path rank row + host
        path mirrors beside the resident columns) — and, when a
        :class:`~repro_torch.core.grants.GrantTable` is already attached, its
        permissions plane too. Host folds stay available as the
        automatic fallback for queries the plane cannot express — and as
        the differential oracle.
        """
        if store.catalog is not self.catalog:
            raise ValueError("device store is bound to a different catalog")
        store.enable_reports_plane()
        self.device_store = store
        if self.grants is not None:
            store.enable_permissions_plane(self.grants)
        return self

    def tiering_counters(self) -> Dict[str, int]:
        """Tiered-residency telemetry of the attached device store
        (demotions / promotions / segments_streamed / windows_streamed /
        window_stalls, plus resident_groups / demoted_groups gauges) —
        empty when no store is attached or the store holds everything
        resident. Serving queries over demoted groups stream their warm
        segments through the double-buffered device window instead of
        falling back to the host folds (see docs/architecture.md,
        "Tiered residency"); the permissions plane scopes streamed
        windows exactly like resident rows."""
        if self.device_store is None:
            return {}
        return self.device_store.tiering_counters()

    def attach_grants(self, grants) -> "Reports":
        """Wire a :class:`~repro_torch.core.grants.GrantTable` so every serving
        query accepts ``subject=``. With a device store attached this
        enables its permissions plane (scoping becomes one fused AND on
        the mesh); without one the host folds filter by
        :meth:`GrantTable.visible_mask`."""
        self.grants = grants
        if self.device_store is not None:
            self.device_store.enable_permissions_plane(grants)
        return self

    def _grant_mask(self, subject: str, cols) -> np.ndarray:
        """Host-side visibility mask for ``subject`` — the scalar oracle
        the store's bitset path is pinned to byte-for-byte."""
        if self.grants is None:
            raise RuntimeError(
                "subject= scoping needs attach_grants(GrantTable)")
        return self.grants.visible_mask(subject, cols,
                                        self.catalog.strings)

    def reset_counters(self) -> None:
        """Scrape boundary: delegates to
        :meth:`~repro_torch.core.telemetry.MetricRegistry.reset`, so the
        serving counters, ``last_fallback_reason``, the tiering and
        permission counters of any attached device store, and every
        other counter family on this catalog's registry clear
        *together* — a scrape never sees serving zeroed but tiering
        still accumulating."""
        self.telemetry.reset()

    # -- serving telemetry ------------------------------------------------------
    def _observe(self, kind: str, subject: Optional[str], source: str,
                 t0: float) -> None:
        """Per-query-kind serve latency histogram
        (``reports_serve_seconds{kind=,scoped=,source=}``)."""
        self.telemetry.histogram(
            "reports_serve_seconds", help="report query latency",
            kind=kind, scoped=str(subject is not None).lower(),
            source=source, **self._tlabels
        ).observe(time.perf_counter() - t0)

    def _fallback(self, kind: str, exc: Exception) -> None:
        """Count a host-fold downgrade (``fallback{stage=,reason=}``) —
        the counter sibling of ``last_fallback_reason``, so exports can
        assert "no silent fallback" without string-scraping."""
        self.telemetry.counter(
            "fallback", help="evaluator/serving downgrades",
            stage=f"reports.{kind}", reason=slug(str(exc)),
            **self._tlabels).inc()

    def _shard_indexes(self) -> List[_PathIndex]:
        """(Re)build the per-shard sorted path indexes that went stale.

        A rebuild snapshots only the columns the index reads (type/size/
        blocks + the path gather) — not the shard's full column stack.
        """
        out = []
        for sid, shard in enumerate(self.catalog.shards):
            version = shard.version
            if self._pversions.get(sid) != version:
                cols, snap = shard.snapshot(names=("type", "size", "blocks"))
                cols["_paths"] = snap.gather("_paths")  # type: ignore
                self._pindexes[sid] = _PathIndex(cols)
                self._pversions[sid] = version
                self.index_rebuilds += 1
            out.append(self._pindexes[sid])
        return out

    # -- rbh-report ---------------------------------------------------------------
    def _backend(self):
        if self.profiles is not None:
            return self.profiles
        if self.stats is None:
            raise RuntimeError("no stats aggregator or profile cube attached")
        return self.stats

    def _profiles_backend(self):
        """Scoped (``subject=``) report queries need the profile cube —
        the scalar aggregator keeps no per-row grant information."""
        if self.profiles is None:
            raise RuntimeError(
                "subject= report scoping needs an attached ProfileCube")
        return self.profiles

    def report_user(self, user: str,
                    subject: Optional[str] = None) -> List[dict]:
        """O(1) per-user summary (pre-aggregated / profile cube)."""
        if subject is not None:
            return self._profiles_backend().report_user(user,
                                                        subject=subject)
        return self._backend().report_user(user)

    def report_group(self, grp: str,
                     subject: Optional[str] = None) -> List[dict]:
        if subject is not None:
            return self._profiles_backend().report_group(grp,
                                                         subject=subject)
        return self._backend().report_group(grp)

    def report_types(self, subject: Optional[str] = None) -> Dict[str, dict]:
        if subject is not None:
            return self._profiles_backend().report_types(subject=subject)
        return self._backend().report_types()

    def report_hsm(self, subject: Optional[str] = None) -> Dict[str, dict]:
        if subject is not None:
            return self._profiles_backend().report_hsm(subject=subject)
        return self._backend().report_hsm()

    def user_size_profile(self, user: str,
                          subject: Optional[str] = None) -> Dict[str, int]:
        if subject is not None:
            return self._profiles_backend().user_size_profile(
                user, subject=subject)
        return self._backend().user_size_profile(user)

    def top_users(self, by: str = "volume", k: int = 10,
                  type_: FsType = FsType.FILE,
                  subject: Optional[str] = None) -> List[dict]:
        if subject is not None:
            return self._profiles_backend().top_users(by=by, k=k,
                                                      type_=type_,
                                                      subject=subject)
        return self._backend().top_users(by=by, k=k, type_=type_)

    def age_profile(self, user: Optional[str] = None,
                    subject: Optional[str] = None) -> Dict[str, dict]:
        """Data-age profile (profile-cube only — the scalar aggregator
        keeps no age axis)."""
        if self.profiles is None:
            raise RuntimeError("age profiles need an attached ProfileCube")
        return self.profiles.age_profile(user, subject=subject)

    def format_user_report(self, user: str) -> str:
        rows = self.report_user(user)
        lines = ["user, type, count, spc_used, avg_size"]
        for r in rows:
            lines.append(f"{r['user']}, {r['type']}, {r['count']}, "
                         f"{format_size(r['spc_used'])}, "
                         f"{format_size(r['avg_size'])}")
        return "\n".join(lines)

    # -- rbh-find -----------------------------------------------------------------
    def find(self, criteria: str, limit: int = 0,
             subject: Optional[str] = None) -> List[str]:
        """DB-backed `find`: returns matching paths.

        Store-backed when a device store is attached: the predicate runs
        as one mesh program over the resident columns and only winning
        rows' paths return (same order as the host fold). Predicates the
        kernel can't compile (e.g. name globs) fall back to the host.
        ``subject=`` scopes the listing to that subject's grants."""
        t0 = time.perf_counter()
        expr = parse_expr(criteria)
        if self.device_store is not None:
            try:
                out = self.device_store.find_paths(expr, self.clock(),
                                                   limit=limit,
                                                   subject=subject)
                self.store_served += 1
                self.last_fallback_reason = None
                self._observe("find", subject, "store", t0)
                return out
            except PolicyError as exc:
                self.last_fallback_reason = f"find: {exc}"
                self._fallback("find", exc)
        self.host_served += 1
        cols = self.catalog.arrays()
        mask = expr.mask(cols, self.catalog.strings, self.clock())
        if subject is not None:
            mask = mask & self._grant_mask(subject, cols)
        idx = np.nonzero(mask)[0]
        if limit:
            idx = idx[:limit]
        paths = cols["_paths"]
        out = [paths[i] for i in idx]
        self._observe("find", subject, "host", t0)
        return out

    # -- rbh-du --------------------------------------------------------------------
    def _du_host(self, path_prefix: str,
                 subject: Optional[str] = None) -> dict:
        """Host `du` fold. Unscoped queries answer from the per-shard
        sorted-path prefix sums; scoped ones cannot (the visibility mask
        varies per subject, invalidating the precomputed sums), so they
        fold the grant-filtered columns directly — which is also the
        shape of the differential oracle the store path is pinned to."""
        if subject is None:
            out = {"count": 0, "files": 0, "volume": 0, "spc_used": 0}
            for index in self._shard_indexes():
                part = index.du(path_prefix)
                for k in out:
                    out[k] += part[k]
            return out
        cols = self.catalog.arrays()
        vis = self._grant_mask(subject, cols)
        prefix = path_prefix.rstrip("/")
        p = np.asarray(cols["_paths"])
        m = vis & ((p == prefix) | np.char.startswith(p, prefix + "/"))
        f = m & (cols["type"] == int(FsType.FILE))
        return {"count": int(m.sum()), "files": int(f.sum()),
                "volume": int(np.asarray(cols["size"],
                                         np.int64)[f].sum()),
                "spc_used": int(np.asarray(cols["blocks"],
                                           np.int64)[f].sum())}

    def du(self, path_prefix: str, subject: Optional[str] = None) -> dict:
        """DB-backed `du -s`: subtree aggregate via sorted-prefix-range.

        Answers from per-shard sorted path indexes + prefix sums cached
        per :attr:`CatalogShard.version` — two binary searches per shard
        per query, rebuilding only the indexes of shards that churned
        (see ``benchmarks/bench_find_du.py``).

        Store-backed when a device store is attached: rank bounds from
        the host path mirrors, one fused on-device range-aggregate psum.
        ``subject=`` counts only rows that subject may see.
        """
        t0 = time.perf_counter()
        if self.device_store is not None:
            try:
                out = self.device_store.du(path_prefix, subject=subject)
                self.store_served += 1
                self.last_fallback_reason = None
                self._observe("du", subject, "store", t0)
                return out
            except PolicyError as exc:
                self.last_fallback_reason = f"du: {exc}"
                self._fallback("du", exc)
        self.host_served += 1
        out = self._du_host(path_prefix, subject)
        self._observe("du", subject, "host", t0)
        return out

    def du_many(self, path_prefixes: List[str],
                subject: Optional[str] = None) -> List[dict]:
        """Batched `du -s`: one index refresh amortized over many subtrees
        (the store-backed path needs no host index prefetch).

        If the store rejects mid-batch (detach, structural churn, an
        unservable prefix), the FIRST ``PolicyError`` flips the whole
        remainder to the host path and prefetches the shard indexes
        once — instead of every remaining prefix paying its own fallback
        round-trip through the store."""
        if self.device_store is None and subject is None:
            self._shard_indexes()
        use_store = self.device_store is not None
        out = []
        for p in path_prefixes:
            t0 = time.perf_counter()
            if use_store:
                try:
                    out.append(self.device_store.du(p, subject=subject))
                    self.store_served += 1
                    self.last_fallback_reason = None
                    self._observe("du_many", subject, "store", t0)
                    continue
                except PolicyError as exc:
                    self.last_fallback_reason = f"du: {exc}"
                    self._fallback("du", exc)
                    use_store = False
                    if subject is None:
                        self._shard_indexes()   # one prefetch, not per-prefix
            self.host_served += 1
            out.append(self._du_host(p, subject))
            self._observe("du_many", subject, "host", t0)
        return out

    def bind_dir_usage(self, du: DirUsage) -> DirUsage:
        """Route a :class:`DirUsage`'s deeper-than-``max_depth`` queries to
        the index-backed :meth:`du` (the documented depth contract)."""
        du.deep_du = self.du
        return du

    # -- top-N listings (paper SII-B3) ----------------------------------------------
    def top_files(self, by: str = "size", k: int = 10,
                  desc: bool = True,
                  subject: Optional[str] = None) -> List[dict]:
        """Top-N files by any kernel column (size/atime/...), exact ties.

        Store-backed when a device store is attached: per-device top-k
        establishes the global threshold, a mask pass recovers every
        candidate (incl. cross-device ties), and only those rows' paths
        come back — ordering matches the host fold byte-for-byte.
        ``subject=`` ranks only rows that subject may see."""
        t0 = time.perf_counter()
        if self.device_store is not None and by in KERNEL_COLUMNS:
            try:
                out = self.device_store.top_files(by=by, k=k, desc=desc,
                                                  now=self.clock(),
                                                  subject=subject)
                self.store_served += 1
                self.last_fallback_reason = None
                self._observe("top_files", subject, "store", t0)
                return out
            except PolicyError as exc:
                self.last_fallback_reason = f"top_files: {exc}"
                self._fallback("top_files", exc)
        self.host_served += 1
        cols = self.catalog.arrays()
        sel = cols["type"] == int(FsType.FILE)
        if subject is not None:
            sel = sel & self._grant_mask(subject, cols)
        fidx = np.nonzero(sel)[0]
        vals = cols[by][fidx]
        if vals.size == 0:
            return []
        k = min(k, vals.size)
        order = np.argsort(vals, kind="stable")
        order = order[::-1][:k] if desc else order[:k]
        paths = cols["_paths"]
        out = [{"path": paths[fidx[o]], by: float(vals[o]),
                "fid": int(cols["fid"][fidx[o]])} for o in order]
        self._observe("top_files", subject, "host", t0)
        return out

    def top_dirs_by_count(self, k: int = 10) -> List[dict]:
        """Top directories by direct child count (one vector groupby)."""
        cols = self.catalog.arrays()
        parents = cols["parent_fid"]
        uniq, counts = np.unique(parents[parents >= 0], return_counts=True)
        if uniq.size == 0:
            return []
        k = min(k, uniq.size)
        top = np.argsort(counts)[::-1][:k]
        out = []
        for i in top:
            e = self.catalog.get(int(uniq[i]))
            out.append({"path": e.path if e else f"fid:{int(uniq[i])}",
                        "children": int(counts[i])})
        return out

    def oldest_files(self, k: int = 10,
                     subject: Optional[str] = None) -> List[dict]:
        return self.top_files(by="atime", k=k, desc=False, subject=subject)
