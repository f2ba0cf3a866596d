"""The port's store reports and cube planes: store-backed reports == host.

1. The non-slow cases of ``tests/core/test_mesh_reports.py`` on the port's
   ``DeviceColumnStore(..., device="cpu")``; its 8-device subprocess case
   becomes ``groups=8`` in this process.
2. Differential runs against the JAX package: one catalog built in both
   packages (same entries, same order), the JAX store on a 1-device mesh
   and the port's at ``groups=1``. Across in-place, insert/remove, rename
   and age-rollover rounds, ``find`` / ``top_files`` / ``du`` and every
   ``ProfileCube`` report are identical (tolerance 0), and so are the
   counters ``full_uploads``, ``cube_rebuilds``, ``rollovers`` and
   ``store_queries``.
3. The five store ops (``mesh_column_topk``, ``mesh_threshold_rows``,
   ``mesh_range_aggregate``, ``mesh_profile_cube``, ``mesh_cube_combine``)
   against the JAX ops on a ``(1, 21, Rp)`` tensor from a seed; and the
   plain cube past 4,096 groups against the JAX ``profile_cube_ref``.
   Tolerance 0 throughout: masks, orders and counts are exact, and every
   sum is of f32-exact integers.
4. Tests marked ``cuda`` (they skip here): the planes on the card equal to
   the same store on the CPU, ``profile_cube_cuda`` past 4,096 groups equal
   to its plain version, and a planted bad argument raising with the
   launch counters unmoved.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T
from repro_torch.core import (Catalog, DeviceColumnStore, Entry, FsType,
                              HsmState, PolicyDefinition, PolicyEngine)
from repro_torch.core.device_store import (_AB_COL, _GID_COL, _ORD_COL,
                                           _SB_COL, _VALID_COL)
from repro_torch.core.policy import KERNEL_COLUMNS
from repro_torch.core.profiles import ProfileCube
from repro_torch.core.reports import Reports
from repro_torch.kernels.policy_scan import kernel as tk
from repro_torch.kernels.policy_scan import ops as tops
from repro_torch.kernels.profile_cube import kernel as pk
from repro_torch.kernels.profile_cube import ops as pops
from repro_torch.kernels.profile_cube import ref as pref

NOW = float(2 ** 20)          # f32-exact "now"
SIZE = KERNEL_COLUMNS.index("size")
BLOCKS = KERNEL_COLUMNS.index("blocks")
TYPE = KERNEL_COLUMNS.index("type")
N_ROWS = _AB_COL + 1          # 21: kernel columns, validity, 4 analytics
FILE = float(int(FsType.FILE))


def _entry(rng, i, pkg=T, **over):
    kw = dict(
        fid=i + 1, name=f"f{i + 1}", path=f"/p/d{i % 5}/f{i + 1}",
        type=pkg.FsType.FILE if rng.random() < 0.9 else pkg.FsType.DIR,
        size=int(rng.integers(0, 2 ** 12)) * 1024,       # narrow: many ties
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{int(rng.integers(0, 4))}",
        group=f"grp{int(rng.integers(0, 3))}",
        hsm_state=pkg.HsmState(int(rng.integers(0, 5))),
        atime=NOW - float(rng.integers(0, 10_000)),      # f32-exact
        mtime=NOW - float(rng.integers(0, 10_000)))
    kw.update(over)
    return pkg.Entry(**kw)


def _random_catalog(rng, n, n_shards=8):
    cat = Catalog(n_shards=n_shards)
    cat.upsert_batch([_entry(rng, i) for i in range(n)])
    return cat


def _churn(cat, rng, n_total, k):
    for f in rng.choice(np.arange(1, n_total + 1), size=k, replace=False):
        cat.upsert(_entry(rng, int(f) - 1,
                          size=int(rng.integers(0, 2 ** 12)) * 1024,
                          atime=NOW - float(rng.integers(0, 10_000))))


class _Clock:
    def __init__(self, t=NOW):
        self.t = t

    def __call__(self):
        return self.t


def _store(cat, groups=1):
    return DeviceColumnStore(cat, groups=groups, device="cpu")


def _oracle(cat, now):
    o = ProfileCube(cat, clock=lambda: now, device="cpu")
    o.rebuild(now=now)
    return o


# -- 1. tests/core/test_mesh_reports.py on the port ---------------------------

FIND_CRITERIA = [
    "size > 2M",
    "size <= 1M and owner == 'user1'",
    "type == file and last_access > 1000s",
    "hsm_state == archived or size > 3M",
    "not (size <= 1M or last_access <= 500s)",
]


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_reports_differential_across_churn_rounds(seed, groups):
    rng = np.random.default_rng(seed)
    cat = _random_catalog(rng, 400)
    clock = _Clock()
    store = _store(cat, groups)
    r_store = Reports(cat, clock=clock).attach_device_store(store)
    r_host = Reports(cat, clock=clock)
    for round_ in range(3):
        for crit in FIND_CRITERIA:
            assert r_store.find(crit) == r_host.find(crit), crit
        assert r_store.find("size > 1M", limit=7) \
            == r_host.find("size > 1M", limit=7)
        for by in ("size", "atime"):
            for desc in (True, False):
                for k in (1, 10, 64):
                    assert r_store.top_files(by=by, k=k, desc=desc) \
                        == r_host.top_files(by=by, k=k, desc=desc), (by, k)
        for p in ("/p/d0", "/p/d1/", "/p", "/nope", "/p/d4"):
            assert r_store.du(p) == r_host.du(p), p
        assert r_store.du_many(["/p/d0", "/p/d2"]) \
            == r_host.du_many(["/p/d0", "/p/d2"])
        _churn(cat, rng, 400, 40)
    assert r_store.last_fallback_reason is None
    assert r_store.host_served == 0 and r_store.store_served > 0


def test_top_files_tie_storm_matches_host_order():
    """Every file the same size: candidate recovery crosses all groups
    and ordering falls back to the host's stable-argsort tie semantics."""
    rng = np.random.default_rng(7)
    cat = Catalog(n_shards=8)
    cat.upsert_batch([_entry(rng, i, type=FsType.FILE, size=1024 * 1024)
                      for i in range(100)])
    clock = _Clock()
    for groups in (1, 8):
        store = _store(cat, groups)
        r_store = Reports(cat, clock=clock).attach_device_store(store)
        r_host = Reports(cat, clock=clock)
        for desc in (True, False):
            assert r_store.top_files(k=10, desc=desc) \
                == r_host.top_files(k=10, desc=desc)
        store.detach()


def test_find_glob_predicate_falls_back_to_host():
    rng = np.random.default_rng(3)
    cat = _random_catalog(rng, 60)
    clock = _Clock()
    r_store = Reports(cat, clock=clock).attach_device_store(_store(cat))
    out = r_store.find("name == 'f7'")
    assert out == Reports(cat, clock=clock).find("name == 'f7'")
    assert r_store.last_fallback_reason is not None
    assert "find" in r_store.last_fallback_reason
    assert r_store.host_served == 1


def test_warm_reports_never_touch_host_columns():
    """The acceptance counter: after the cold upload, serving find/
    top_files/du + profile reports does not call Catalog.arrays(), and a
    warm round after in-place churn makes no full upload and no cube
    rebuild."""
    rng = np.random.default_rng(5)
    cat = _random_catalog(rng, 300)
    clock = _Clock()
    store = _store(cat, 2)
    r_store = Reports(cat, clock=clock).attach_device_store(store)
    pc = ProfileCube(cat, clock=clock, device="cpu") \
        .attach_device_store(store)
    r_store.find("size > 2M")                     # cold upload happens here
    pc.report_user("user1", NOW)                  # cold cube build
    baseline = cat.arrays_calls
    uploads, rebuilds = store.full_uploads, store.cube_rebuilds
    for _ in range(2):
        r_store.find("size > 1M")
        r_store.top_files(k=5)
        r_store.du("/p/d1")
        pc.report_user("user1", NOW)
        pc.top_users("volume", 3, NOW)
        _churn(cat, rng, 300, 10)                 # warm scatter, not arrays()
    assert cat.arrays_calls == baseline
    assert store.store_queries > 0
    assert store.full_uploads == uploads and store.cube_rebuilds == rebuilds
    assert store.rows_scattered > 0


# -- profile cube plane -------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 4])
def test_profile_reports_differential_with_rollovers(groups):
    rng = np.random.default_rng(11)
    cat = _random_catalog(rng, 350)
    clock = _Clock()
    store = _store(cat, groups)
    pc = ProfileCube(cat, clock=clock, device="cpu") \
        .attach_device_store(store)
    for dt in (0.0, 5000.0, 50_000.0):            # crosses age-bucket edges
        now = NOW + dt
        clock.t = now
        o = _oracle(cat, now)
        for u in ("user0", "user1", "user2", "user3"):
            assert pc.report_user(u, now) == o.report_user(u, now)
            assert pc.user_size_profile(u, now) == o.user_size_profile(u, now)
        assert pc.report_types(now) == o.report_types(now)
        assert pc.report_hsm(now) == o.report_hsm(now)
        assert pc.age_profile(now=now) == o.age_profile(now=now)
        assert pc.top_users("volume", 5, now) == o.top_users("volume", 5, now)
        assert pc.totals() == o.totals()
        _churn(cat, rng, 350, 30)
    assert store.cube_rebuilds == 1               # warm rounds scatter-add
    assert store.rollovers > 0


def test_cube_rebuild_is_invalidation_and_group_growth_rebuilds():
    rng = np.random.default_rng(13)
    cat = _random_catalog(rng, 200)
    clock = _Clock()
    store = _store(cat)
    pc = ProfileCube(cat, clock=clock, device="cpu") \
        .attach_device_store(store)
    pc.cube(NOW)
    assert store.cube_rebuilds == 1
    pc.rebuild()                                  # = invalidate, not host work
    pc.cube(NOW)
    assert store.cube_rebuilds == 2
    # minting more groups than the padded axis forces a resized rebuild
    cat.upsert_batch([_entry(rng, 200 + i, owner=f"newuser{i}")
                      for i in range(len(pc.groups) + 8)])
    o = ProfileCube(cat, clock=clock, device="cpu")
    o.rebuild(now=NOW)
    assert pc.totals() == o.totals()
    assert store.cube_rebuilds >= 3


def test_delta_feed_claimed_once():
    """One delta batch updates columns + cube + mirrors exactly once: the
    store owns the single catalog hook, the cube's own hook is dead, and a
    second feed claim raises."""
    rng = np.random.default_rng(17)
    cat = _random_catalog(rng, 120)
    clock = _Clock()
    store = _store(cat)
    pc = ProfileCube(cat, clock=clock, device="cpu") \
        .attach_device_store(store)
    with pytest.raises(ValueError):
        pc.attach()                               # feed already claimed
    pc.cube(NOW)
    # exactly one delta application: totals track a batch that rewrites
    # the same fid twice (no double-fold)
    cat.upsert(_entry(rng, 0, size=2048 * 1024, type=FsType.FILE))
    cat.upsert(_entry(rng, 0, size=1024 * 1024, type=FsType.FILE))
    o = ProfileCube(cat, clock=clock, device="cpu")
    o.rebuild(now=NOW)
    assert pc.totals() == o.totals()
    # the cube's own shard buffers stayed empty: the store fed the plane
    assert all(len(s.pending) == 0 if hasattr(s, "pending") else True
               for s in pc._shards)


# -- a store full scan primes the incremental cache ---------------------------

def _lru_policy(rule="size > 2M and last_access > 1000s", sort_by="atime"):
    return PolicyDefinition.from_config(
        name="p", action=lambda e, p: True, scope="type == file",
        rules=[("r0", rule, {})], sort_by=sort_by, n_threads=1,
        batch_size=64, mutates=False, dry_run=True)


def test_mesh_scan_primes_incremental_cache():
    rng = np.random.default_rng(19)
    cat = _random_catalog(rng, 300)
    eng = PolicyEngine(cat, clock=_Clock(), device="cpu")
    eng.register(_lru_policy())
    eng.enable_incremental()
    eng.attach_device_store(_store(cat))
    r1 = eng.run("p", evaluator="policy_scan_mesh")
    assert r1.evaluator == "policy_scan_mesh" and r1.mode == "full"
    assert not r1.fallback_reason
    r2 = eng.run("p")                             # primed: no rebuild
    assert r2.mode == "incremental"
    assert r2.matched == r1.matched
    assert eng._inc["p"].full_rebuilds == 1


def test_mesh_primed_cache_identical_to_host_primed():
    """The cache a store full scan leaves behind matches what a host full
    scan of the same state builds — same matched table, same flips."""
    def scenario(prime_mesh):
        rng = np.random.default_rng(23)
        cat = _random_catalog(rng, 300)
        eng = PolicyEngine(cat, clock=_Clock(), device="cpu")
        eng.register(_lru_policy())
        eng.enable_incremental()
        if prime_mesh:
            eng.attach_device_store(_store(cat))
            eng.run("p", evaluator="policy_scan_mesh")
        else:
            eng.run("p", evaluator="numpy", matching="full")
        st = eng._inc["p"]
        fids, sizes, sorts, rules = st.plan_arrays()
        ffids, fcols = st.flips.live()
        order, forder = np.argsort(fids), np.argsort(ffids)
        return (fids[order].tolist(), sizes[order].tolist(),
                sorts[order].tolist(), rules[order].tolist(),
                ffids[forder].tolist(), fcols["flip"][forder].tolist())

    assert scenario(True) == scenario(False)


def test_mesh_scan_with_extra_criteria_does_not_corrupt_cache():
    from repro_torch.core import parse_expr
    rng = np.random.default_rng(29)
    cat = _random_catalog(rng, 200)
    eng = PolicyEngine(cat, clock=_Clock(), device="cpu")
    eng.register(_lru_policy("size > 1M", "size"))
    eng.enable_incremental()
    eng.attach_device_store(_store(cat))
    eng.run("p", evaluator="policy_scan_mesh")    # primes
    rebuilds = eng._inc["p"].full_rebuilds
    r = eng.run("p", evaluator="policy_scan_mesh", matching="full",
                extra_criteria=parse_expr("size > 2M"))
    assert r.evaluator == "policy_scan_mesh"
    assert eng._inc["p"].full_rebuilds == rebuilds   # no partial-scope prime
    r3 = eng.run("p")
    assert r3.mode == "incremental"               # cache still valid


# -- structural fallbacks -----------------------------------------------------

def _moved(e, fid, path):
    return Entry(fid=fid, name=e.name, path=path, type=e.type, size=e.size,
                 blocks=e.blocks, owner=e.owner, group=e.group,
                 hsm_state=e.hsm_state, atime=e.atime, mtime=e.mtime)


def test_rename_degrades_to_full_reupload_and_stays_correct():
    """A path change shifts sorted-path ranks: the warm scatter must not
    serve stale du ranges — the group re-uploads instead."""
    rng = np.random.default_rng(31)
    cat = _random_catalog(rng, 150)
    clock = _Clock()
    store = _store(cat, 2)
    r_store = Reports(cat, clock=clock).attach_device_store(store)
    r_host = Reports(cat, clock=clock)
    assert r_store.du("/p/d1") == r_host.du("/p/d1")
    uploads = store.full_uploads
    cat.upsert(_moved(cat.get(7), 7, "/q/moved/f7"))
    assert r_store.du("/q/moved") == r_host.du("/q/moved")
    assert r_store.du("/p/d2") == r_host.du("/p/d2")
    assert store.full_uploads == uploads + 1      # the renamed group only


# -- the reference's 8-device case: groups=8 in this process ------------------

def test_mesh_reports_differential_on_eight_groups():
    rng = np.random.default_rng(0)
    cat = Catalog(n_shards=16)
    cat.upsert_batch([Entry(
        fid=i + 1, name=f"f{i + 1}", path=f"/p/d{i % 7}/f{i + 1}",
        type=FsType.FILE if rng.random() < 0.9 else FsType.DIR,
        size=int(rng.integers(0, 2 ** 12)) * 1024,
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{i % 4}", group=f"grp{i % 3}",
        hsm_state=HsmState(int(rng.integers(0, 5))),
        atime=NOW - float(rng.integers(0, 10_000)),
        mtime=NOW - float(rng.integers(0, 10_000))) for i in range(3000)])
    clock = lambda: NOW  # noqa: E731
    store = _store(cat, 8)
    rs = Reports(cat, clock=clock).attach_device_store(store)
    rh = Reports(cat, clock=clock)
    pc = ProfileCube(cat, clock=clock, device="cpu") \
        .attach_device_store(store)
    oracle = _oracle(cat, NOW)
    assert rs.find("size > 2M") == rh.find("size > 2M")
    assert rs.top_files(k=25) == rh.top_files(k=25)
    assert rs.top_files(by="atime", k=25, desc=False) \
        == rh.top_files(by="atime", k=25, desc=False)
    for p in ("/p/d0", "/p/d3", "/nope"):
        assert rs.du(p) == rh.du(p)
    for u in ("user0", "user1"):
        assert pc.report_user(u, NOW) == oracle.report_user(u, NOW)
    assert pc.totals() == oracle.totals()
    # warm churn touching every group, then re-verify
    cat.update_fields_batch(list(range(1, 3000, 31)), size=3 << 20)
    assert rs.find("size > 2M") == rh.find("size > 2M")
    assert rs.top_files(k=25) == rh.top_files(k=25)
    assert rs.du("/p/d5") == rh.du("/p/d5")
    assert pc.totals() == _oracle(cat, NOW).totals()
    assert store.delta_refreshes >= 8 and store.cube_rebuilds == 1
    assert rs.last_fallback_reason is None and rs.host_served == 0


# -- 2. differential against the JAX package ----------------------------------

def _jax():
    pytest.importorskip("jax")
    import repro.core as J
    from repro.core.profiles import ProfileCube as JProfileCube
    from repro.core.reports import Reports as JReports
    from repro.launch.mesh import make_shards_mesh
    return J, JProfileCube, JReports, make_shards_mesh


def _rows(seed, n):
    """n entries as plain dicts (both packages build theirs from these),
    every value f32-exact, several paths per directory."""
    rng = np.random.default_rng(seed)
    return [dict(
        fid=i + 1, name=f"f{i + 1}", path=f"/p/d{i % 5}/s{i % 3}/f{i + 1}",
        type=0 if rng.random() < 0.9 else 1,
        size=int(rng.integers(0, 2 ** 12)) * 1024,
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{int(rng.integers(0, 4))}",
        group=f"grp{int(rng.integers(0, 3))}",
        hsm_state=int(rng.integers(0, 5)),
        atime=NOW - float(rng.integers(0, 100_000)),
        mtime=NOW - float(rng.integers(0, 10_000))) for i in range(n)]


def _make(pkg, row):
    return pkg.Entry(**dict(row, type=pkg.FsType(row["type"]),
                            hsm_state=pkg.HsmState(row["hsm_state"])))


def _cube_reports(pc, now):
    out = {}
    for u in ("user0", "user1", "user2", "user3"):
        out["report_user", u] = pc.report_user(u, now)
        out["user_size_profile", u] = pc.user_size_profile(u, now)
    for g in ("grp0", "grp1", "grp2"):
        out["report_group", g] = pc.report_group(g, now)
    out["report_types"] = pc.report_types(now)
    out["report_hsm"] = pc.report_hsm(now)
    out["age_profile"] = pc.age_profile(now=now)
    out["age_profile_user1"] = pc.age_profile("user1", now=now)
    for by in ("volume", "count", "spc_used"):
        out["top_users", by] = pc.top_users(by, 3, now)
    out["totals"] = pc.totals()
    out["cube"] = pc.cube(now).tobytes()
    return out


def _store_reports(r):
    out = {}
    for crit in FIND_CRITERIA:
        out["find", crit] = r.find(crit)
    out["find_limit"] = r.find("size > 1M", limit=9)
    for by in ("size", "atime", "blocks"):
        for desc in (True, False):
            out["top", by, desc] = r.top_files(by=by, k=12, desc=desc)
    for p in ("/p", "/p/d0", "/p/d1/s2", "/p/d3/", "/q", "/nope"):
        out["du", p] = r.du(p)
    return out


def test_store_reports_match_jax_across_rounds():
    """find / top_files / du and every ProfileCube report identical to the
    JAX store's (1-device mesh) at groups=1, cold and after in-place,
    insert/remove, rename and age-rollover rounds; the stores' counters
    equal too."""
    J, JProfileCube, JReports, make_mesh = _jax()
    rows = _rows(41, 500)
    clock = _Clock()
    side = {}
    for name, pkg in (("jax", J), ("port", T)):
        cat = pkg.Catalog(n_shards=8)
        cat.upsert_batch([_make(pkg, r) for r in rows])
        if name == "jax":
            store = J.DeviceColumnStore(cat, make_mesh(), tile=128)
            rep = JReports(cat, clock=clock).attach_device_store(store)
            pc = JProfileCube(cat, clock=clock).attach_device_store(store)
        else:
            store = T.DeviceColumnStore(cat, groups=1, device="cpu",
                                        tile=128)
            rep = Reports(cat, clock=clock).attach_device_store(store)
            pc = ProfileCube(cat, clock=clock, device="cpu") \
                .attach_device_store(store)
        side[name] = (pkg, cat, store, rep, pc)
    rng = np.random.default_rng(43)
    for round_i in range(5):
        live = sorted(e.fid for e in side["port"][1].entries())
        if round_i == 1:            # in place
            upd = rng.choice(live, size=60, replace=False).tolist()
            kw = dict(size=int(rng.integers(0, 2 ** 12)) * 1024,
                      atime=NOW - float(rng.integers(0, 100_000)),
                      owner=f"user{int(rng.integers(0, 4))}")
            for pkg, cat, *_ in side.values():
                cat.update_fields_batch(upd, **kw)
        elif round_i == 2:          # inserts and removes
            gone = rng.choice(live, size=20, replace=False).tolist()
            new = _rows(round_i, 30)
            for r in new:
                r["fid"] += 10_000
                r["path"] = r["path"].replace("/p/", "/q/")
            for pkg, cat, *_ in side.values():
                for f in gone:
                    cat.remove(int(f))
                cat.upsert_batch([_make(pkg, r) for r in new])
        elif round_i == 3:          # a rename
            f = int(live[5])
            for pkg, cat, *_ in side.values():
                e = cat.get(f)
                cat.upsert(pkg.Entry(
                    fid=f, name=e.name, path="/p/d0/renamed", type=e.type,
                    size=e.size, blocks=e.blocks, owner=e.owner,
                    group=e.group, hsm_state=e.hsm_state, atime=e.atime,
                    mtime=e.mtime))
        elif round_i == 4:          # age rollovers
            clock.t = NOW + 3 * 86400.0
        got = {}
        for name, (pkg, cat, store, rep, pc) in side.items():
            got[name] = (_store_reports(rep), _cube_reports(pc, clock()))
        assert got["port"] == got["jax"], round_i
        js, ts = side["jax"][2], side["port"][2]
        for c in ("full_uploads", "cube_rebuilds", "rollovers",
                  "store_queries", "delta_refreshes", "rows_scattered"):
            assert getattr(ts, c) == getattr(js, c), (round_i, c)
        for name in side:
            assert side[name][3].last_fallback_reason is None
    assert side["port"][2].rollovers > 0


# -- 3. the store ops against the JAX ops -------------------------------------

def _store_cols(seed, rp, n_groups=12, d=1):
    """(d, 21, rp) f32: kernel columns with f32-exact values and ties, 1/8
    of rows invalid, ord a permutation a group, gid/sb/ab in range."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 3, (d, N_ROWS, rp)).astype(np.float32)
    cols[:, SIZE] = rng.integers(0, 64, (d, rp)) * 4096
    cols[:, BLOCKS] = rng.integers(0, 1 << 12, (d, rp))
    cols[:, TYPE] = rng.random((d, rp)) < 0.8
    cols[:, KERNEL_COLUMNS.index("atime")] = NOW - rng.integers(0, 10_000,
                                                                (d, rp))
    cols[:, _VALID_COL] = rng.random((d, rp)) < 0.875
    for g in range(d):
        cols[g, _ORD_COL] = rng.permutation(rp)
    cols[:, _GID_COL] = rng.integers(0, n_groups, (d, rp))
    cols[:, _SB_COL] = rng.integers(0, pref.S_BUCKETS, (d, rp))
    cols[:, _AB_COL] = rng.integers(0, pref.A_BUCKETS, (d, rp))
    return cols


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("by", ["size", "atime"])
def test_topk_and_threshold_ops_match_jax(by, desc):
    _jax()
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ops as jops
    from repro.launch.mesh import make_shards_mesh
    cols = _store_cols(1, 1024)
    col = KERNEL_COLUMNS.index(by)
    kw = dict(col=col, valid_col=_VALID_COL, type_col=TYPE, file_code=FILE)
    mesh = make_shards_mesh()
    vals, idx = tops.mesh_column_topk(torch.from_numpy(cols), k=37,
                                      desc=desc, **kw)
    jvals, _ = jops.mesh_column_topk(jnp.asarray(cols), mesh=mesh, k=37,
                                     desc=desc, **kw)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    # each index points at a row holding its value (ties in any order)
    np.testing.assert_array_equal(cols[0, col, idx[0].numpy()], vals[0])
    thr = float(vals[0, -1])
    mask = tops.mesh_threshold_rows(torch.from_numpy(cols), thr, ge=desc,
                                    **kw)
    jmask = jops.mesh_threshold_rows(jnp.asarray(cols), thr, mesh=mesh,
                                     ge=desc, **kw)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask) > 0.5)
    assert int(mask.sum()) >= 37                  # ties at the threshold


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_range_aggregate_op_matches_jax(seed):
    _jax()
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ops as jops
    from repro.launch.mesh import make_shards_mesh
    rp = 2048
    cols = _store_cols(seed, rp)
    rng = np.random.default_rng(seed + 100)
    lo, lo2 = np.sort(rng.integers(0, rp, 2)), np.sort(rng.integers(0, rp,
                                                                    2))
    bounds = np.array([[lo[0], lo[1], lo2[0], lo2[1]]], np.float32)
    kw = dict(ord_col=_ORD_COL, type_col=TYPE, size_col=SIZE,
              blocks_col=BLOCKS, valid_col=_VALID_COL, file_code=FILE)
    got = tops.mesh_range_aggregate(torch.from_numpy(cols), bounds, **kw)
    want = jops.mesh_range_aggregate(jnp.asarray(cols), jnp.asarray(bounds),
                                     mesh=make_shards_mesh(), **kw)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want, np.float64))
    o = cols[0, _ORD_COL]
    m = (cols[0, _VALID_COL] > 0.5) & (((o >= lo[0]) & (o < lo[1]))
                                       | ((o >= lo2[0]) & (o < lo2[1])))
    f = m & (cols[0, TYPE] == FILE)
    assert got.tolist() == [m.sum(), f.sum(), cols[0, SIZE][f].sum(),
                            cols[0, BLOCKS][f].sum()]


@pytest.mark.parametrize("d", [1, 3])
def test_mesh_profile_cube_and_combine_match_jax(d):
    _jax()
    import jax.numpy as jnp
    from repro.kernels.profile_cube import ops as jpops
    from repro.launch.mesh import make_shards_mesh
    cols = _store_cols(7 + d, 1024, n_groups=16, d=d)
    kw = dict(n_groups=16, gid_col=_GID_COL, size_col=SIZE,
              blocks_col=BLOCKS, sb_col=_SB_COL, ab_col=_AB_COL,
              valid_col=_VALID_COL)
    partials, combined = pops.mesh_profile_cube(torch.from_numpy(cols),
                                                **kw)
    mesh = make_shards_mesh()
    jparts = [np.asarray(jpops.mesh_profile_cube(
        jnp.asarray(cols[g: g + 1]), mesh=mesh, use_kernel=False, **kw)[0])
        for g in range(d)]
    assert partials.dtype == combined.dtype == torch.float64
    np.testing.assert_array_equal(partials.numpy(), np.concatenate(jparts))
    np.testing.assert_array_equal(
        combined.numpy(), np.sum(jparts, axis=0).reshape(combined.shape))
    jcomb = jpops.mesh_cube_combine(jnp.asarray(jparts[0]), mesh=mesh)
    np.testing.assert_array_equal(
        pops.mesh_cube_combine(partials[:1]).numpy(), np.asarray(jcomb))
    with pytest.raises(ValueError, match="use_kernel=True"):
        pops.mesh_profile_cube(torch.from_numpy(cols), use_kernel=True,
                               **kw)


def test_plain_cube_past_the_op_cap_matches_jax():
    """Past 4,096 groups (the op's cap, which stays) the plain version the
    store's CPU cube plane runs equals the JAX profile_cube_ref."""
    _jax()
    import jax.numpy as jnp
    from repro.kernels.profile_cube import ref as jref
    b = pops.MAX_GROUPS + 904
    assert pops.MAX_GROUPS == 4096 and pk.KERNEL_MAX_GROUPS == 1 << 24
    cols = _store_cols(21, 8192, n_groups=b)[0]
    kw = dict(gid_col=_GID_COL, size_col=SIZE, blocks_col=BLOCKS,
              age_col=SIZE, valid_col=_VALID_COL, sb_col=_SB_COL,
              ab_col=_AB_COL)
    got = pref.profile_cube_ref(torch.from_numpy(cols), b, **kw)
    want = jref.profile_cube_ref(jnp.asarray(cols), b, **kw)
    assert got.shape == (3, b, 10, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="host groupby"):
        pops.profile_cube(*(np.zeros(4),) * 4, n_groups=b, device="cpu")


def test_kernel_group_cap_raises_before_building():
    """The kernel's own limit is checked with a clear error, on any
    device, and no launch is counted."""
    before = pk.profile_cube_launches
    for b in (0, pk.KERNEL_MAX_GROUPS + 1):
        with pytest.raises(ValueError, match=f"n_groups={b}"):
            pk.profile_cube_cuda(torch.zeros((7, 8)),
                                 n_groups=b, gid_col=0, size_col=1,
                                 blocks_col=2, age_col=3, valid_col=6,
                                 sb_col=4, ab_col=5)
    assert pk.profile_cube_launches == before


# -- 4. on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the store's kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4])
def test_cuda_store_planes_equal_the_cpu_store(cuda_device, groups):
    """Every report and cube answer of the planes on the card equals the
    same store's on the CPU, cold and after a warm round; a cold cube is
    ``groups`` profile_cube launches and a find one lean store form."""
    answers, launches = {}, {}
    for dev in ("cpu", cuda_device):
        rng = np.random.default_rng(53)
        cat = _random_catalog(rng, 4000)
        clock = _Clock()
        store = DeviceColumnStore(cat, groups=groups, device=dev)
        rep = Reports(cat, clock=clock).attach_device_store(store)
        pc = ProfileCube(cat, clock=clock, device=dev) \
            .attach_device_store(store)
        out = []
        for round_i in range(2):
            tk.reset_counters()
            pk.reset_counters()
            out.append((_store_reports(rep), _cube_reports(pc, clock())))
            if round_i == 0:
                launches[str(dev)] = (pk.profile_cube_launches,
                                      tk.policy_scan_store_lean_launches)
            _churn(cat, rng, 4000, 200)
            clock.t += 86400.0
        answers[str(dev)] = out
        store.detach()
    assert answers[str(cuda_device)] == answers["cpu"]
    n_find = len(FIND_CRITERIA) + 1
    assert launches[str(cuda_device)] == (groups, n_find)
    assert launches["cpu"] == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4097, 7504, 20_000])
def test_cuda_profile_cube_past_4096_groups(cuda_device, b):
    assert pk.max_groups() == pk.KERNEL_MAX_GROUPS
    cols = torch.from_numpy(_store_cols(61, 1 << 18, n_groups=b)[0]) \
        .to(cuda_device)
    kw = dict(n_groups=b, gid_col=_GID_COL, size_col=SIZE,
              blocks_col=BLOCKS, age_col=SIZE, valid_col=_VALID_COL,
              sb_col=_SB_COL, ab_col=_AB_COL)
    got = pk.profile_cube_cuda(cols, **kw)
    assert pk.design(b, cuda_device) == "global"
    want = pref.profile_cube_ref(cols.double(), **kw)
    assert torch.equal(got, want.float())
    assert torch.equal(got, pk.profile_cube_cuda(cols, **kw))
    wide = pk.profile_cube_cuda(cols, out_dtype=torch.float64, **kw)
    assert wide.dtype == torch.float64 and torch.equal(wide, want)


@pytest.mark.cuda
def test_cuda_cube_plane_raises_on_a_planted_bad_argument(cuda_device,
                                                          monkeypatch):
    """With a gid row the kernel refuses, the store's cube on the card
    raises: it never runs the plain version instead, and no launch is
    counted."""
    from repro_torch.core import device_store
    cat = _random_catalog(np.random.default_rng(67), 300)
    store = DeviceColumnStore(cat, groups=2, device=cuda_device)
    pc = ProfileCube(cat, clock=_Clock(), device=cuda_device) \
        .attach_device_store(store)
    store.refresh()
    monkeypatch.setattr(device_store, "_GID_COL", N_ROWS + 5)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(pops, "profile_cube_ref", no_plain)
    before = pk.profile_cube_launches
    with pytest.raises(ValueError, match="gid_col"):
        pc.cube(NOW)
    assert pk.profile_cube_launches == before
    assert store.cube_rebuilds == 0
