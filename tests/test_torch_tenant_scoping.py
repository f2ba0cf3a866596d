"""The port's permissions plane: ``subject=`` scoping == the scalar oracle.

1. ``tests/core/test_tenant_scoping.py`` on the port's
   ``DeviceColumnStore(..., device="cpu")`` at groups 1 and 8 (its
   8-device subprocess case becomes ``groups=8`` in this process): every
   scoped ``find`` / ``top_files`` / ``du`` / ``du_many`` and every
   ``ProfileCube`` report equals the host oracle (the host folds filtered by
   ``GrantTable.visible_mask``) across churn; an unknown subject raises
   ``KeyError``, a store without the plane ``PolicyError``; pure updates
   patch the resident bitsets word by word (``perm_word_scatters``), while
   structural churn and grant changes re-materialize them
   (``perm_materializations``).
2. Differential runs against the JAX package: one catalog and one
   ``GrantTable`` built in both packages, the JAX store on a 1-device mesh
   and the port's at ``groups=1``. Through pure-update, structural, rename
   and grant-mutation rounds, every scoped answer is identical to the JAX
   store's and to the host oracle (tolerance 0: paths, orders and counts
   are exact, and every sum is of f32-exact integers), and so are the
   stores' counters.
3. The ops: ``_subject_bits`` against the reference's for random words and
   every subject; each scoped op against the reference op at one group;
   the two plain routes of the scoped store form (the CPU evaluator's AND
   after attribution, and ``ref.policy_scan_store_ref`` with the validity
   masked) agree, and so do the scoped cube's (the op and a masked
   validity row through ``mesh_profile_cube``).
4. The three copies scoped queries pass through (``core/grants.py``,
   ``core/reports.py``, ``core/profiles.py``) differ from their originals
   only as listed.
5. Tests marked ``cuda`` (they skip here): the scoped store form and the
   scoped cube against their plain versions, their launch arguments
   refused, and the scoped queries of a store on the card equal to the
   same store's on the CPU, one scoped launch a scoped ``find``.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T
from repro_torch.core import (Catalog, DeviceColumnStore, GrantTable,
                              PolicyError, parse_expr)
from repro_torch.core.catalog import StringTable
from repro_torch.core.device_store import (_AB_COL, _GID_COL, _ORD_COL,
                                           _SB_COL, _VALID_COL)
from repro_torch.core.policy import (KERNEL_COLUMNS, all_of, any_of,
                                     compile_programs)
from repro_torch.core.profiles import ProfileCube
from repro_torch.core.reports import Reports
from repro_torch.kernels.policy_scan import kernel as tk
from repro_torch.kernels.policy_scan import ops as tops
from repro_torch.kernels.policy_scan import ref as tref
from repro_torch.kernels.profile_cube import kernel as pk
from repro_torch.kernels.profile_cube import ops as pops
from repro_torch.kernels.profile_cube import ref as pref

NOW = float(2 ** 20)          # f32-exact "now"
SIZE = KERNEL_COLUMNS.index("size")
BLOCKS = KERNEL_COLUMNS.index("blocks")
TYPE = KERNEL_COLUMNS.index("type")
N_ROWS = _AB_COL + 1          # 21: kernel columns, validity, 4 analytics
FILE = float(int(T.FsType.FILE))
TOL = dict(rtol=1e-5, atol=1)
ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _entry(rng, i, pkg=T, **over):
    kw = dict(
        fid=i + 1, name=f"f{i + 1}", path=f"/p/d{i % 5}/f{i + 1}",
        type=pkg.FsType.FILE if rng.random() < 0.9 else pkg.FsType.DIR,
        size=int(rng.integers(0, 2 ** 12)) * 1024,
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{int(rng.integers(0, 4))}",
        group=f"grp{int(rng.integers(0, 3))}",
        hsm_state=pkg.HsmState(int(rng.integers(0, 5))),
        atime=NOW - float(rng.integers(0, 10_000)),
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


def _random_grants(rng, pkg=T):
    """A spread of grant shapes: uid-only, gid-only, subtree-only, mixed."""
    g = pkg.GrantTable()
    g.add_subject(f"user{int(rng.integers(0, 4))}")
    g.add_subject("grp-aud", owners=(),
                  groups=(f"grp{int(rng.integers(0, 3))}",))
    trees = rng.choice(5, size=2, replace=False)
    g.add_subject("tree-aud", owners=(),
                  subtrees=tuple(f"/p/d{int(t)}" for t in trees))
    g.add_subject("mixed", owners=(f"user{int(rng.integers(0, 4))}",),
                  groups=(f"grp{int(rng.integers(0, 3))}",),
                  subtrees=(f"/p/d{int(rng.integers(0, 5))}",))
    g.add_subject("nobody", owners=("ghost-user",))   # matches nothing
    return g


class _Clock:
    def __init__(self, t=NOW):
        self.t = t

    def __call__(self):
        return self.t


FIND_CRITERIA = [
    "size > 2M",
    "size <= 1M and owner == 'user1'",
    "type == file and last_access > 1000s",
    "hsm_state == archived or size > 3M",
]

SUBJECTS = [None, "grp-aud", "tree-aud", "mixed", "nobody"]
GROUPS = [1, 8]


def _store(cat, groups):
    return DeviceColumnStore(cat, groups=groups, device="cpu")


def _pair(cat, clock, grants, groups):
    """(store, store-backed Reports, host-only oracle Reports) over the
    same catalog."""
    store = _store(cat, groups)
    pc_s = ProfileCube(cat, clock=clock, device="cpu") \
        .attach_device_store(store)
    pc_s.attach_grants(grants)
    r_s = Reports(cat, clock=clock, profiles=pc_s) \
        .attach_device_store(store).attach_grants(grants)
    pc_h = ProfileCube(cat, clock=clock, device="cpu")
    pc_h.attach_grants(grants)
    pc_h.rebuild(now=NOW)
    r_h = Reports(cat, clock=clock, profiles=pc_h).attach_grants(grants)
    return store, r_s, r_h


# -- 1. tests/core/test_tenant_scoping.py on the port --------------------------

@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("seed", [0, 1])
def test_scoped_reports_differential_across_churn(seed, groups):
    rng = np.random.default_rng(seed)
    cat = _random_catalog(rng, 400)
    clock = _Clock()
    grants = _random_grants(rng)
    store, r_s, r_h = _pair(cat, clock, grants, groups)
    for round_ in range(3):
        for s in SUBJECTS:
            for crit in FIND_CRITERIA:
                assert r_s.find(crit, subject=s) \
                    == r_h.find(crit, subject=s), (s, crit)
            assert r_s.find("size > 1M", limit=5, subject=s) \
                == r_h.find("size > 1M", limit=5, subject=s)
            for p in ("/p/d0", "/p", "/nope"):
                assert r_s.du(p, subject=s) == r_h.du(p, subject=s), (s, p)
            assert r_s.du_many(["/p/d1", "/p/d3"], subject=s) \
                == r_h.du_many(["/p/d1", "/p/d3"], subject=s)
            for by in ("size", "atime"):
                for k in (1, 10):
                    assert r_s.top_files(by=by, k=k, subject=s) \
                        == r_h.top_files(by=by, k=k, subject=s), (s, by, k)
        _churn(cat, rng, 400, 40)
    assert r_s.last_fallback_reason is None
    assert r_s.host_served == 0 and r_s.store_served > 0


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("seed", [0, 1])
def test_scoped_profile_reports_differential(seed, groups):
    rng = np.random.default_rng(100 + seed)
    cat = _random_catalog(rng, 300)
    clock = _Clock()
    grants = _random_grants(rng)
    store, r_s, r_h = _pair(cat, clock, grants, groups)
    for round_ in range(2):
        for s in SUBJECTS:
            assert r_s.report_user("user1", subject=s) \
                == r_h.report_user("user1", subject=s), s
            assert r_s.report_group("grp0", subject=s) \
                == r_h.report_group("grp0", subject=s), s
            assert r_s.report_types(subject=s) \
                == r_h.report_types(subject=s), s
            assert r_s.report_hsm(subject=s) == r_h.report_hsm(subject=s), s
            assert r_s.user_size_profile("user2", subject=s) \
                == r_h.user_size_profile("user2", subject=s), s
            assert r_s.age_profile(subject=s) \
                == r_h.age_profile(subject=s), s
            assert r_s.top_users(k=3, subject=s) \
                == r_h.top_users(k=3, subject=s), s
        _churn(cat, rng, 300, 30)
        r_h.profiles.rebuild(now=NOW)     # host oracle fold is not live


@pytest.mark.parametrize("groups", GROUPS)
def test_unknown_subject_raises_not_falls_back(groups):
    """An unknown subject is a caller error (KeyError), never a silent
    unscoped answer via the PolicyError fallback chain."""
    rng = np.random.default_rng(2)
    cat = _random_catalog(rng, 60)
    clock = _Clock()
    grants = _random_grants(rng)
    store, r_s, r_h = _pair(cat, clock, grants, groups)
    for r in (r_s, r_h):
        with pytest.raises(KeyError, match="ghost"):
            r.find("size > 1M", subject="ghost")
        with pytest.raises(KeyError, match="ghost"):
            r.du("/p/d0", subject="ghost")
    with pytest.raises(KeyError, match="ghost"):
        store.top_files(subject="ghost")
    with pytest.raises(KeyError, match="ghost"):
        store.analytics_cube(NOW, subject="ghost")
    assert r_s.last_fallback_reason is None


@pytest.mark.parametrize("groups", GROUPS)
def test_scoped_glob_predicate_falls_back_scoped(groups):
    """Host-only predicates still fall back — and the fallback itself is
    grant-filtered, not unscoped."""
    rng = np.random.default_rng(3)
    cat = _random_catalog(rng, 80)
    clock = _Clock()
    grants = _random_grants(rng)
    store, r_s, r_h = _pair(cat, clock, grants, groups)
    out = r_s.find("name == 'f7'", subject="mixed")
    assert out == r_h.find("name == 'f7'", subject="mixed")
    assert r_s.last_fallback_reason is not None
    assert r_s.host_served == 1


@pytest.mark.parametrize("groups", GROUPS)
def test_store_without_grants_rejects_subject(groups):
    rng = np.random.default_rng(4)
    cat = _random_catalog(rng, 40)
    store = _store(cat, groups)
    store.enable_reports_plane()
    for call in (lambda: store.match([parse_expr("size > 1M")], NOW,
                                     subject="anyone"),
                 lambda: store.scan(parse_expr("size > 1M"), NOW,
                                    subject="anyone"),
                 lambda: store.find_paths(parse_expr("size > 1M"), NOW,
                                          subject="anyone"),
                 lambda: store.top_files(subject="anyone"),
                 lambda: store.du("/p", subject="anyone")):
        with pytest.raises(PolicyError, match="permissions plane"):
            call()
    r = Reports(cat, clock=_Clock())
    with pytest.raises(RuntimeError, match="attach_grants"):
        r.find("size > 1M", subject="anyone")


# -- bitmap maintenance: warm word scatter vs re-materialization --------------

@pytest.mark.parametrize("groups", GROUPS)
def test_pure_update_churn_patches_bitmap_words(groups):
    """Owner flips on existing rows reach the resident bitsets through the
    dirty-row word scatter — no full re-materialization."""
    rng = np.random.default_rng(5)
    cat = _random_catalog(rng, 240)
    clock = _Clock()
    grants = GrantTable()
    grants.add_subject("user1")
    store = _store(cat, groups)
    r_s = Reports(cat, clock=clock).attach_device_store(store) \
        .attach_grants(grants)
    r_h = Reports(cat, clock=clock).attach_grants(grants)
    assert r_s.find("size >= 0", subject="user1") \
        == r_h.find("size >= 0", subject="user1")
    mats = store.perm_materializations
    assert mats == groups and store.perm_word_scatters == 0
    # flip some rows' owner to/from user1: same fid+path => pure update
    for f in (3, 7, 11, 20):
        cat.upsert(_entry(rng, f - 1, owner="user1"))
    for f in (1, 5):
        cat.upsert(_entry(rng, f - 1, owner="user3"))
    assert r_s.find("size >= 0", subject="user1") \
        == r_h.find("size >= 0", subject="user1")
    assert store.perm_materializations == mats, \
        "pure-update churn forced a bitmap re-materialization"
    assert store.perm_word_scatters >= 1
    assert store.full_uploads == groups


@pytest.mark.parametrize("groups", GROUPS)
def test_structural_churn_rematerializes_bitmap(groups):
    """Inserting rows re-uploads the blocks; the permission plane must be
    rebuilt with them (it indexes catalog row ids)."""
    rng = np.random.default_rng(6)
    cat = _random_catalog(rng, 160)
    clock = _Clock()
    grants = GrantTable()
    grants.add_subject("tree", owners=(), subtrees=("/p/d2",))
    store = _store(cat, groups)
    r_s = Reports(cat, clock=clock).attach_device_store(store) \
        .attach_grants(grants)
    r_h = Reports(cat, clock=clock).attach_grants(grants)
    assert r_s.du("/p", subject="tree") == r_h.du("/p", subject="tree")
    mats = store.perm_materializations
    cat.upsert_batch([_entry(rng, i) for i in range(160, 200)])  # inserts
    assert r_s.du("/p", subject="tree") == r_h.du("/p", subject="tree")
    assert store.perm_materializations > mats
    assert r_s.last_fallback_reason is None


@pytest.mark.parametrize("groups", GROUPS)
def test_grant_mutation_refreshes_bitmap(groups):
    """GrantTable.grant bumps version; the next scoped query must serve
    the extended visibility, not the stale materialized bitset."""
    rng = np.random.default_rng(7)
    cat = _random_catalog(rng, 120)
    clock = _Clock()
    grants = GrantTable()
    grants.add_subject("aud", owners=(), groups=("grp0",))
    store = _store(cat, groups)
    r_s = Reports(cat, clock=clock).attach_device_store(store) \
        .attach_grants(grants)
    r_h = Reports(cat, clock=clock).attach_grants(grants)
    before = r_s.find("size >= 0", subject="aud")
    assert before == r_h.find("size >= 0", subject="aud")
    grants.grant("aud", subtrees=("/p/d4",))
    after = r_s.find("size >= 0", subject="aud")
    assert after == r_h.find("size >= 0", subject="aud")
    assert set(before) < set(after)          # strictly more visible rows
    # new subjects are also picked up (bitset row count grows)
    grants.add_subject("late", owners=("user2",))
    assert r_s.find("size >= 0", subject="late") \
        == r_h.find("size >= 0", subject="late")


# -- fallback-telemetry regressions -------------------------------------------

@pytest.mark.parametrize("groups", GROUPS)
def test_fallback_reason_cleared_on_store_success(groups):
    """A stale fallback reason must not outlive the next store-served
    query: fallback -> store-served -> reason is None again."""
    rng = np.random.default_rng(8)
    cat = _random_catalog(rng, 60)
    clock = _Clock()
    store = _store(cat, groups)
    r = Reports(cat, clock=clock).attach_device_store(store)
    r.find("name == 'f7'")                        # glob: host fallback
    assert r.last_fallback_reason is not None
    r.find("size > 1M")                           # store-served
    assert r.last_fallback_reason is None
    r.find("name == 'f9'")
    assert r.last_fallback_reason is not None
    assert r.du("/p/d0") == Reports(cat, clock=clock).du("/p/d0")
    assert r.last_fallback_reason is None         # du clears it too
    served, host = r.store_served, r.host_served
    r.reset_counters()
    assert (r.store_served, r.host_served, r.index_rebuilds) == (0, 0, 0)
    assert r.last_fallback_reason is None
    assert served == 2 and host == 2


def test_du_many_prefetches_indexes_once_on_fallback():
    """First mid-batch PolicyError switches the whole remainder to the
    host path with ONE index prefetch — not one rebuild pass per prefix."""
    rng = np.random.default_rng(9)
    cat = _random_catalog(rng, 80)
    clock = _Clock()

    calls = {"du": 0}

    class _AlwaysFalls:
        catalog = cat

        def du(self, p, subject=None):
            calls["du"] += 1
            raise PolicyError("injected")

    r = Reports(cat, clock=clock)
    r.device_store = _AlwaysFalls()
    prefixes = ["/p/d0", "/p/d1", "/p/d2", "/p/d4"]
    out = r.du_many(prefixes)
    assert out == Reports(cat, clock=clock).du_many(prefixes)
    assert calls["du"] == 1, "store retried after the first PolicyError"
    assert r.index_rebuilds == cat.n_shards, \
        f"expected one prefetch pass ({cat.n_shards} shard indexes), " \
        f"got {r.index_rebuilds}"
    assert r.host_served == len(prefixes)
    assert r.last_fallback_reason is not None


def test_scoped_serving_on_eight_groups():
    """The reference's 8-device case, as ``groups=8`` in this process."""
    rng = np.random.default_rng(0)
    cat = Catalog(n_shards=16)
    cat.upsert_batch([T.Entry(
        fid=i + 1, name=f"f{i+1}", path=f"/p/d{i % 7}/f{i+1}",
        type=T.FsType.FILE if rng.random() < 0.9 else T.FsType.DIR,
        size=int(rng.integers(0, 2 ** 12)) * 1024,
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{i % 5}", group=f"grp{i % 3}",
        hsm_state=T.HsmState(int(rng.integers(0, 5))),
        atime=NOW - float(rng.integers(0, 10_000)),
        mtime=NOW - float(rng.integers(0, 10_000))) for i in range(1200)])
    g = GrantTable()
    g.add_subject("user2")
    g.add_subject("mixed", owners=("user4",), groups=("grp1",),
                  subtrees=("/p/d5",))
    store, r_s, r_h = _pair(cat, lambda: NOW, g, 8)
    assert store.n_groups == 8
    for s in ("user2", "mixed"):
        assert r_s.find("size > 1M", subject=s) \
            == r_h.find("size > 1M", subject=s)
        assert r_s.du("/p/d5", subject=s) == r_h.du("/p/d5", subject=s)
        assert r_s.top_files(k=9, subject=s) \
            == r_h.top_files(k=9, subject=s)
        assert r_s.report_types(subject=s) == r_h.report_types(subject=s)
        assert r_s.top_users(k=4, subject=s) == r_h.top_users(k=4, subject=s)
    assert r_s.host_served == 0 and r_s.last_fallback_reason is None


def test_plane_enable_rules():
    """Idempotent for the same table; another table, or a tile that does
    not pack into whole 32-bit words, raises; the reports plane comes on."""
    cat = _random_catalog(np.random.default_rng(10), 40)
    g = GrantTable()
    store = _store(cat, 2)
    store.enable_permissions_plane(g)
    store.enable_permissions_plane(g)
    assert store._plane_reports
    with pytest.raises(PolicyError, match="different GrantTable"):
        store.enable_permissions_plane(GrantTable())
    odd = DeviceColumnStore(cat, groups=2, device="cpu", tile=48)
    with pytest.raises(PolicyError, match="multiple of 32"):
        odd.enable_permissions_plane(g)
    assert not odd._plane_reports


def test_scoped_match_scan_and_span():
    """``match``/``scan`` with ``subject=``: the matched fids are the
    unscoped ones the subject may see, rules -1 nowhere among them, the
    aggregates those of the visible rows; the ``store.match`` span says
    whether the match was scoped."""
    rng = np.random.default_rng(11)
    cat = _random_catalog(rng, 500)
    grants = _random_grants(rng)
    store = _store(cat, 3)
    store.enable_permissions_plane(grants)
    exprs = [parse_expr("size > 1M"), parse_expr("owner == 'user1'"),
             parse_expr("size > 3M")]
    full = store.match(exprs, NOW)
    fids, _, _, rules = full.plan("size")
    arrays = cat.arrays()
    for s in ("tree-aud", "mixed", "nobody"):
        vis = grants.visible_mask(s, arrays, cat.strings)
        seen = set(arrays["fid"][vis].tolist())
        m = store.match(exprs, NOW, subject=s)
        sf, ssz, _, sr = m.plan("size")
        keep = np.isin(fids, list(seen))
        assert sf.tolist() == fids[keep].tolist()
        assert sr.tolist() == rules[keep].tolist()
        assert m.agg["count"] == keep.sum()
        assert m.agg["volume"] == float(ssz.sum())
        sfids, agg = store.scan(exprs[0], NOW, subject=s)
        assert sfids.tolist() == sf.tolist() and agg["count"] == m.agg[
            "count"]
    spans = cat.telemetry.spans("store.match")
    assert {sp.attrs["scoped"] for sp in spans} == {True, False}


# -- 2. differential against the JAX package ----------------------------------

def _jax():
    pytest.importorskip("jax")
    import repro.core as J
    from repro.core.profiles import ProfileCube as JProfileCube
    from repro.core.reports import Reports as JReports
    from repro.launch.mesh import make_shards_mesh
    return J, JProfileCube, JReports, make_shards_mesh


def _rows(seed, n, fid0=1):
    """n entries as plain dicts (both packages build theirs from these),
    every value f32-exact, several paths per directory."""
    rng = np.random.default_rng(seed)
    return [dict(
        fid=fid0 + i, name=f"f{fid0 + i}",
        path=f"/p/d{i % 5}/s{i % 3}/f{fid0 + i}",
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


def _grants_of(pkg):
    g = pkg.GrantTable()
    g.add_subject("user1")
    g.add_subject("grp-aud", owners=(), groups=("grp2",))
    g.add_subject("tree-aud", owners=(), subtrees=("/p/d1", "/p/d3/s0"))
    g.add_subject("mixed", owners=("user3",), groups=("grp0",),
                  subtrees=("/p/d4",))
    g.add_subject("nobody", owners=("ghost-user",))
    return g


SCOPED = ["user1", "grp-aud", "tree-aud", "mixed", "nobody"]


def _scoped_answers(rep, now):
    out = {}
    names = [s.name for s in rep.grants.subjects()]
    for s in SCOPED + (["late"] if "late" in names else []):
        for crit in FIND_CRITERIA:
            out["find", s, crit] = rep.find(crit, subject=s)
        for by, desc in (("size", True), ("atime", False)):
            out["top", s, by] = rep.top_files(by=by, k=12, desc=desc,
                                              subject=s)
        for p in ("/p", "/p/d1", "/p/d3/s0", "/nope"):
            out["du", s, p] = rep.du(p, subject=s)
        out["types", s] = rep.report_types(subject=s)
        out["user", s] = rep.report_user("user3", subject=s)
        out["top_users", s] = rep.top_users(k=3, subject=s)
        if rep.device_store is not None:
            # group ids follow the order a cube met its groups: the two
            # stores' cubes compare cell by cell, the host's by report
            out["cube", s] = rep.profiles.cube(now, subject=s).tobytes()
    return out


COUNTERS = ("perm_materializations", "perm_word_scatters", "full_uploads",
            "delta_refreshes", "store_queries", "cube_rebuilds")


def test_scoped_queries_match_jax_across_rounds():
    """Every scoped answer identical to the JAX store's (1-device mesh) at
    groups=1 and to the host oracle, cold and after pure-update (owner
    flips), insert/remove, rename and grant-mutation rounds; the stores'
    counters equal too."""
    J, JProfileCube, JReports, make_mesh = _jax()
    rows = _rows(51, 500)
    clock = _Clock()
    side = {}
    for name, pkg in (("jax", J), ("port", T)):
        cat = pkg.Catalog(n_shards=8)
        cat.upsert_batch([_make(pkg, r) for r in rows])
        grants = _grants_of(pkg)
        if name == "jax":
            store = J.DeviceColumnStore(cat, make_mesh(), tile=128)
            pc = JProfileCube(cat, clock=clock).attach_device_store(store)
            rep_cls = JReports
        else:
            store = T.DeviceColumnStore(cat, groups=1, device="cpu",
                                        tile=128)
            pc = ProfileCube(cat, clock=clock, device="cpu") \
                .attach_device_store(store)
            rep_cls = Reports
        pc.attach_grants(grants)
        rep = rep_cls(cat, clock=clock, profiles=pc) \
            .attach_device_store(store).attach_grants(grants)
        side[name] = (pkg, cat, store, rep, grants)
    hcat = Catalog(n_shards=8)
    hcat.upsert_batch([_make(T, r) for r in rows])
    hgrants = _grants_of(T)
    hpc = ProfileCube(hcat, clock=clock, device="cpu")
    hpc.attach_grants(hgrants)
    host = Reports(hcat, clock=clock, profiles=hpc).attach_grants(hgrants)
    cats = [side["jax"][1], side["port"][1], hcat]
    tables = [side["jax"][4], side["port"][4], hgrants]
    rng = np.random.default_rng(53)
    for round_i in range(5):
        live = sorted(e.fid for e in side["port"][1].entries())
        if round_i == 1:            # pure updates: owners flip
            upd = rng.choice(live, size=40, replace=False).tolist()
            for k, f in enumerate(upd):
                for cat in cats:
                    cat.update_fields_batch([f], owner=f"user{k % 4}")
        elif round_i == 2:          # inserts and removes
            gone = rng.choice(live, size=20, replace=False).tolist()
            new = _rows(54, 30, fid0=10_000)
            for cat in cats:
                for f in gone:
                    cat.remove(f)
                cat.upsert_batch([_make(T if cat is hcat or cat is
                                        side["port"][1] else J, r)
                                  for r in new])
        elif round_i == 3:          # renames into another subtree
            moved = rng.choice(live, size=6, replace=False).tolist()
            for cat in cats:
                cat.upsert_batch([dataclasses.replace(
                    cat.get(f), path=f"/p/d1/moved/f{f}") for f in moved])
        elif round_i == 4:          # grants change; a subject arrives
            for g in tables:
                g.grant("grp-aud", subtrees=("/p/d0",))
                g.add_subject("late", owners=("user2",))
        hpc.rebuild(now=NOW)
        got = {name: _scoped_answers(side[name][3], NOW)
               for name in ("jax", "port")}
        want = _scoped_answers(host, NOW)
        assert got["port"].keys() == got["jax"].keys()
        for key in got["port"]:
            assert got["port"][key] == got["jax"][key], (round_i, key)
            if key in want:
                assert got["port"][key] == want[key], (round_i, key)
        for c in COUNTERS:
            assert getattr(side["port"][2], c) \
                == getattr(side["jax"][2], c), (round_i, c)
        assert side["port"][3].host_served == 0
    assert side["port"][2].perm_word_scatters > 0
    assert side["port"][2].perm_materializations > 1


# -- 3. the ops against the JAX ops -------------------------------------------

def _perm(seed, d, sp, rp, rows=None):
    """(d, sp, rp / 32) uint32 words with random bits; subject sp - 1 sees
    nothing and subject sp - 2 every row below ``rows``."""
    rng = np.random.default_rng(seed)
    vis = rng.random((d, sp, rp)) < 0.6
    vis[:, sp - 1] = False
    vis[:, sp - 2] = True
    if rows is not None:
        vis[:, :, rows:] = False
    return np.packbits(vis, axis=2, bitorder="little").view(np.uint32), vis


def _as_i32(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subject_bits_match_jax(seed):
    _jax()
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ops as jops
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (6, 40), dtype=np.uint64) \
        .astype(np.uint32)
    words[0, :3] = (0x80000000, 0xFFFFFFFF, 1)    # the sign bit, all, one
    for s in range(words.shape[0]):
        got = tops._subject_bits(_as_i32(words), s).numpy()
        want = np.asarray(jops._subject_bits(jnp.asarray(words),
                                             jnp.int32(s)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.unpackbits(
            words[s].view(np.uint8), bitorder="little").astype(bool))


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


CONDITIONS = ["size > 16M", "size <= 4M", "owner == 'user1'",
              "last_access > 1000s", "hsm_state == archived",
              "not (size <= 1M or last_access <= 500s)"]


def _programs(r):
    st = StringTable()
    for s in ("user0", "user1", "user2"):
        st.intern(s)
    exprs = [parse_expr(e) for e in CONDITIONS[: max(r - 1, 1)]]
    exprs = [all_of([parse_expr("type == file"), any_of(exprs)])] + exprs
    return compile_programs(exprs[:r], st, NOW)


@pytest.mark.parametrize("with_agg", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_scoped_store_op_matches_jax(seed, with_agg):
    _jax()
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ops as jops
    from repro.launch.mesh import make_shards_mesh
    rp, sp = 1024, 8
    cols = _store_cols(seed, rp)
    words, _ = _perm(seed + 10, 1, sp, rp)
    ops, colidx, operands = _programs(4)
    ops_t, colidx_t = tops._program_tuples(ops, colidx)
    kw = dict(ops_t=ops_t, colidx_t=colidx_t, size_col=SIZE,
              blocks_col=BLOCKS, valid_col=_VALID_COL, with_agg=with_agg)
    for s in range(sp):
        mask, rule, agg = tops.mesh_policy_scan_batch(
            torch.from_numpy(cols), torch.from_numpy(operands),
            perm=_as_i32(words), subject=s, **kw)
        jm, jr, ja = jops.mesh_policy_scan_batch(
            jnp.asarray(cols), jnp.asarray(operands),
            mesh=make_shards_mesh(), use_kernel=False,
            perm=jnp.asarray(words), subject=np.int32(s), **kw)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(rule.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(agg.numpy(), np.asarray(ja))
    assert not mask.any() and (rule == -1).all()     # subject sp-1: nothing


@pytest.mark.parametrize("seed", [0, 1])
def test_scoped_report_ops_match_jax(seed):
    _jax()
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ops as jops
    from repro.launch.mesh import make_shards_mesh
    mesh = make_shards_mesh()
    rp, sp = 2048, 8
    cols = _store_cols(seed + 20, rp)
    words, _ = _perm(seed + 30, 1, sp, rp)
    kw = dict(col=SIZE, valid_col=_VALID_COL, type_col=TYPE, file_code=FILE)
    rng = np.random.default_rng(seed + 40)
    lo, lo2 = np.sort(rng.integers(0, rp, 2)), np.sort(rng.integers(0, rp,
                                                                    2))
    bounds = np.array([[lo[0], lo[1], lo2[0], lo2[1]]], np.float32)
    akw = dict(ord_col=_ORD_COL, type_col=TYPE, size_col=SIZE,
               blocks_col=BLOCKS, valid_col=_VALID_COL, file_code=FILE)
    tcols, jcols = torch.from_numpy(cols), jnp.asarray(cols)
    for s in range(sp):
        scope = dict(perm=_as_i32(words), subject=s)
        jscope = dict(perm=jnp.asarray(words), subject=np.int32(s))
        for desc in (True, False):
            vals, _ = tops.mesh_column_topk(tcols, k=19, desc=desc, **kw,
                                            **scope)
            jvals, _ = jops.mesh_column_topk(jcols, mesh=mesh, k=19,
                                             desc=desc, **kw, **jscope)
            np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
            thr = float(vals[0, -1]) if np.isfinite(float(vals[0, -1])) \
                else 0.0
            mask = tops.mesh_threshold_rows(tcols, thr, ge=desc, **kw,
                                            **scope)
            jmask = jops.mesh_threshold_rows(jcols, thr, mesh=mesh,
                                             ge=desc, **kw, **jscope)
            np.testing.assert_array_equal(mask.numpy(),
                                          np.asarray(jmask) > 0.5)
        got = tops.mesh_range_aggregate(tcols, bounds, **akw, **scope)
        want = jops.mesh_range_aggregate(jcols, jnp.asarray(bounds),
                                         mesh=mesh, **akw, **jscope)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want, np.float64))


def test_scoped_cube_op_matches_jax():
    _jax()
    import jax.numpy as jnp
    from repro.kernels.profile_cube import ops as jpops
    from repro.launch.mesh import make_shards_mesh
    rp, sp = 1024, 8
    cols = _store_cols(61, rp, n_groups=16)
    words, _ = _perm(62, 1, sp, rp)
    kw = dict(n_groups=16, gid_col=_GID_COL, size_col=SIZE,
              blocks_col=BLOCKS, sb_col=_SB_COL, ab_col=_AB_COL,
              valid_col=_VALID_COL)
    for s in range(sp):
        got = pops.mesh_scoped_cube(torch.from_numpy(cols), _as_i32(words),
                                    s, **kw)
        want = jpops.mesh_scoped_cube(jnp.asarray(cols), jnp.asarray(words),
                                      np.int32(s), mesh=make_shards_mesh(),
                                      **kw)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want, np.float64))


@pytest.mark.parametrize("with_agg", [True, False])
@pytest.mark.parametrize("d", [1, 3])
def test_scoped_plain_routes_agree(d, with_agg):
    """The CPU evaluator (ANDs after attribution) and the kernel's plain
    version (validity masked first) give the same outputs."""
    rp, sp = 512, 8
    cols = torch.from_numpy(_store_cols(70 + d, rp, d=d))
    perm = _as_i32(_perm(71 + d, d, sp, rp)[0])
    ops, colidx, operands = _programs(5)
    ops_t, colidx_t = tops._program_tuples(ops, colidx)
    kw = dict(size_col=SIZE, blocks_col=BLOCKS, valid_col=_VALID_COL,
              with_agg=with_agg)
    for s in range(sp):
        a = tops.mesh_policy_scan_batch(cols, torch.from_numpy(operands),
                                        ops_t=ops_t, colidx_t=colidx_t,
                                        perm=perm, subject=s, **kw)
        b = tref.policy_scan_store_ref(
            cols, *(torch.from_numpy(x) for x in (ops, colidx, operands)),
            perm=perm, sid=s, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), s


@pytest.mark.parametrize("d", [1, 3])
def test_scoped_cube_equals_masked_validity(d):
    rp, sp = 512, 8
    cols = torch.from_numpy(_store_cols(80 + d, rp, n_groups=9, d=d))
    words, vis = _perm(81 + d, d, sp, rp)
    kw = dict(n_groups=9, gid_col=_GID_COL, size_col=SIZE,
              blocks_col=BLOCKS, sb_col=_SB_COL, ab_col=_AB_COL,
              valid_col=_VALID_COL)
    for s in range(sp):
        got = pops.mesh_scoped_cube(cols, _as_i32(words), s, **kw)
        masked = cols.clone()
        masked[:, _VALID_COL] *= torch.from_numpy(vis[:, s]).float()
        _, want = pops.mesh_profile_cube(masked, **kw)
        assert torch.equal(got, want), s
        assert int(got[0].sum()) == int(masked[:, _VALID_COL].sum())


def test_scoped_op_arguments_checked():
    cols = torch.from_numpy(_store_cols(90, 256))
    perm = _as_i32(_perm(91, 1, 8, 256)[0])
    kw = dict(col=SIZE, valid_col=_VALID_COL)
    with pytest.raises(ValueError, match="together"):
        tops.mesh_column_topk(cols, k=1, perm=perm, **kw)
    with pytest.raises(ValueError, match="together"):
        tops.mesh_threshold_rows(cols, 0.0, subject=0, **kw)
    with pytest.raises(ValueError, match="outside"):
        tops.mesh_column_topk(cols, k=1, perm=perm, subject=8, **kw)
    with pytest.raises(ValueError, match="does not cover"):
        tops.mesh_column_topk(cols, k=1, perm=perm[:, :, :4], subject=0,
                              **kw)
    ops, colidx, operands = _programs(2)
    ops_t, colidx_t = tops._program_tuples(ops, colidx)
    with pytest.raises(ValueError, match="outside"):
        tops.mesh_policy_scan_batch(
            cols, torch.from_numpy(operands), ops_t=ops_t,
            colidx_t=colidx_t, valid_col=_VALID_COL, perm=perm, subject=-1)
    with pytest.raises(ValueError, match="does not cover"):
        pops.mesh_scoped_cube(cols, perm[:, :, :4], 0, n_groups=4,
                              gid_col=_GID_COL, size_col=SIZE,
                              blocks_col=BLOCKS, sb_col=_SB_COL,
                              ab_col=_AB_COL, valid_col=_VALID_COL)


# -- 4. the copies scoped queries pass through --------------------------------

# Each copy is its original with ``repro`` renamed to ``repro_torch`` and
# these (original text, copy's text) edits, each made exactly once, after
# the copy's ``repro_torch`` is renamed back to ``repro``.
ALLOWED = {
    "core/grants.py": [
        ("* the :class:`~repro.core.device_store.DeviceColumnStore` "
         "permissions",
         "* the device column store permissions"),
    ],
    "core/reports.py": [
        ("additionally go **mesh-resident**: predicates evaluate and "
         "top-k/range\naggregates reduce over the device store's sharded "
         "column blocks under\n``shard_map``, and only the winning rows' "
         "paths come back through the\nstore's host mirrors",
         "additionally go **store-resident**: predicates evaluate and "
         "top-k/range\naggregates reduce over the resident ``(D, C+1+4, "
         "Rp)`` tensor of a\n:class:`~repro.core.device_store."
         "DeviceColumnStore` on its device,\nand only the winning rows' "
         "paths come back through the store's host\nmirrors"),
        ("(``tests/core/test_mesh_reports.py``)",
         "(``tests/test_torch_mesh_reports.py``)"),
        ("        :class:`~repro.core.device_store.DeviceColumnStore`.",
         "        device column store."),
    ],
    "core/profiles.py": [
        ("or the fused ``profile_cube`` Pallas kernel",
         "or the fused ``profile_cube`` CUDA kernel"),
        ("  f32 accumulation, see :attr:`ProfileCube.use_kernel`);",
         "  cells rounded to f32, see :attr:`ProfileCube.use_kernel`);"),
        ("to the :class:`~repro.core.device_store.DeviceColumnStore` cube "
         "plane",
         "to the device column store cube plane"),
        ("import numpy as np\n\nfrom .fidtable",
         "import numpy as np\n\nfrom ..device import resolve_device\n"
         "from .fidtable"),
        ("                 use_kernel: bool = False) -> None:",
         "                 use_kernel: bool = False, device=None) -> None:"),
        ("""        # True: full rebuilds run through the Pallas kernel (on TPU; the
        # interpret-mode kernel off-TPU is for differential tests). The
        # kernel accumulates in f32 — exact only while per-cell sums stay
        # below 2**24 — so the DEFAULT is the int64 host groupby; opt in
        # for on-device builds where that precision envelope holds (or
        # approximate trends are acceptable).
        self.use_kernel = use_kernel
""", """        # True: full rebuilds run through the profile_cube op on
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
"""),
        ("default), or the fused Pallas kernel when opted in (f32 sums —",
         "default), or the fused CUDA kernel when opted in (f32 cells —"),
        ("ab=age_buckets_np(age), n_groups=len(self.groups))",
         "ab=age_buckets_np(age), n_groups=len(self.groups),\n"
         "                        device=self.device)"),
    ],
}


def _apply(name, ref):
    text = ref
    for old, new in ALLOWED[name]:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("name", sorted(ALLOWED))
def test_copies_differ_only_as_listed(name):
    """``core/grants.py``, ``core/reports.py`` and ``core/profiles.py``
    are the JAX package's with ``repro`` renamed and exactly the listed
    edits: any other drift fails."""
    ref = (SRC / "repro" / name).read_text()
    port = (SRC / "repro_torch" / name).read_text()
    renamed = re.sub(r"\brepro_torch\b", "repro", port)
    assert renamed == _apply(name, ref)


# -- 5. on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scoped kernels run only there")
    return torch.device("cuda")


def _who(kind, d, sp, rp, rows, seed):
    """(perm (d, sp, rp / 32) u32, sid): a subject that sees no row, some
    rows or every row."""
    words, _ = _perm(seed, d, sp, rp, rows)
    sid = {"none": sp - 1, "some": 1, "all": sp - 2}[kind]
    return words, sid


@pytest.mark.cuda
@pytest.mark.parametrize("who", ["none", "some", "all"])
@pytest.mark.parametrize("with_agg", [True, False], ids=["agg", "lean"])
@pytest.mark.parametrize("r", [1, 4, 6])
@pytest.mark.parametrize("d, rp, rows", [(3, 32 * 37, 32 * 37 - 5),
                                         (1, (1 << 16) + 96, 60_001)])
def test_cuda_scoped_store_form_matches_plain_version(cuda_device, d, rp,
                                                      rows, r, with_agg,
                                                      who):
    cols = torch.from_numpy(_store_cols(d * 11 + r, rp, d=d))
    cols[:, _VALID_COL, rows:] = 0.0              # an unaligned group size
    cols = cols.to(cuda_device)
    words, sid = _who(who, d, 8, rp, rows, d + r)
    perm = _as_i32(words).to(cuda_device)
    prog = [torch.from_numpy(a).to(cuda_device) for a in _programs(r)]
    kw = dict(size_col=SIZE, blocks_col=BLOCKS, valid_col=_VALID_COL,
              with_agg=with_agg)
    tk.reset_counters()
    got = tk.policy_scan_store_cuda(cols, *prog, perm=perm, sid=sid, **kw)
    assert (tk.policy_scan_store_scoped_launches,
            tk.policy_scan_store_scoped_lean_launches,
            tk.policy_scan_store_launches,
            tk.policy_scan_store_lean_launches) == \
        ((1, 0, 0, 0) if with_agg else (0, 1, 0, 0))
    want = tref.policy_scan_store_ref(cols, *prog, perm=perm, sid=sid, **kw)
    assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if with_agg:
        torch.testing.assert_close(got[2], want[2], **TOL)
        assert torch.equal(got[2][:, 3:13], want[2][:, 3:13])  # counts
    else:
        assert not got[2].any()
    cpu = tops.mesh_policy_scan_batch(
        cols.cpu(), prog[2].cpu(), ops_t=tops._program_tuples(
            prog[0].cpu().numpy(), prog[1].cpu().numpy())[0],
        colidx_t=tops._program_tuples(prog[0].cpu().numpy(),
                                      prog[1].cpu().numpy())[1],
        perm=perm.cpu(), subject=sid, **kw)
    assert torch.equal(got[0].cpu(), cpu[0]) and torch.equal(got[1].cpu(),
                                                            cpu[1])
    if who == "none":
        assert not got[0].any() and bool((got[1] == -1).all())
    if who == "all":
        plain = tk.policy_scan_store_cuda(cols, *prog, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    again = tk.policy_scan_store_cuda(cols, *prog, perm=perm, sid=sid, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("who", ["none", "some", "all"])
@pytest.mark.parametrize("b", [16, 7504])
def test_cuda_scoped_cube_matches_plain_version(cuda_device, b, who):
    d, rp = 3, 1 << 16
    cols = torch.from_numpy(_store_cols(b, rp, n_groups=b, d=d))
    words, sid = _who(who, d, 8, rp, rp, b)
    kw = dict(n_groups=b, gid_col=_GID_COL, size_col=SIZE,
              blocks_col=BLOCKS, sb_col=_SB_COL, ab_col=_AB_COL,
              valid_col=_VALID_COL)
    pk.reset_counters()
    got = pops.mesh_scoped_cube(cols.to(cuda_device),
                                _as_i32(words).to(cuda_device), sid, **kw)
    assert (pk.profile_cube_scoped_launches, pk.profile_cube_launches) == \
        (d, 0)
    want = pops.mesh_scoped_cube(cols, _as_i32(words), sid, **kw)
    assert got.dtype == torch.float64 and torch.equal(got.cpu(), want)
    if who == "all":
        _, unscoped = pops.mesh_profile_cube(cols.to(cuda_device), **kw)
        assert torch.equal(got, unscoped)


@pytest.mark.cuda
def test_cuda_scoped_launch_arguments_rejected(cuda_device):
    rp = 1024
    cols = torch.from_numpy(_store_cols(3, rp, d=2)).to(cuda_device)
    perm = _as_i32(_perm(4, 2, 8, rp)[0]).to(cuda_device)
    prog = [torch.from_numpy(a).to(cuda_device) for a in _programs(3)]
    kw = dict(size_col=SIZE, blocks_col=BLOCKS, valid_col=_VALID_COL,
              with_agg=True)
    tk.reset_counters()
    pk.reset_counters()
    with pytest.raises(ValueError, match="sid=8 outside"):
        tk.policy_scan_store_cuda(cols, *prog, perm=perm, sid=8, **kw)
    with pytest.raises(ValueError, match="sid=-1 outside"):
        tk.policy_scan_store_cuda(cols, *prog, perm=perm, sid=-1, **kw)
    with pytest.raises(ValueError, match="multiple of 32"):
        tk.policy_scan_store_cuda(cols[:, :, :100].contiguous(), *prog,
                                  perm=perm[:, :, :4].contiguous(), sid=0,
                                  **kw)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.policy_scan_store_cuda(cols, *prog, perm=perm.cpu(), sid=0, **kw)
    with pytest.raises(ValueError, match="together"):
        tk.policy_scan_store_cuda(cols, *prog, perm=perm, **kw)
    with pytest.raises(TypeError, match="int32"):
        tk.policy_scan_store_cuda(cols, *prog, perm=perm.long(), sid=0,
                                  **kw)
    ckw = dict(n_groups=4, gid_col=_GID_COL, size_col=SIZE,
               blocks_col=BLOCKS, age_col=SIZE, sb_col=_SB_COL,
               ab_col=_AB_COL, valid_col=_VALID_COL)
    with pytest.raises(ValueError, match="sid=8 outside"):
        pk.profile_cube_cuda(cols[0], perm=perm[0], sid=8, **ckw)
    with pytest.raises(ValueError, match="must be a tensor on"):
        pk.profile_cube_cuda(cols[0], perm=perm[0].cpu(), sid=0, **ckw)
    with pytest.raises(ValueError, match="does not cover"):
        pk.profile_cube_cuda(cols[0], perm=perm[0, :, :3].contiguous(),
                             sid=0, **ckw)
    assert (tk.policy_scan_store_scoped_launches,
            tk.policy_scan_store_launches,
            pk.profile_cube_scoped_launches) == (0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4])
def test_cuda_scoped_store_equals_the_cpu_store(cuda_device, groups):
    """Every scoped answer of the store on the card equals the same store's
    on the CPU, cold and after a warm round; a scoped find is one lean
    scoped launch, and a warm scoped cube one scoped launch a group."""
    answers, launches = {}, {}
    for dev in ("cpu", cuda_device):
        rng = np.random.default_rng(57)
        cat = _random_catalog(rng, 4000)
        clock = _Clock()
        grants = _random_grants(rng)
        store = DeviceColumnStore(cat, groups=groups, device=dev)
        pc = ProfileCube(cat, clock=clock, device=dev) \
            .attach_device_store(store)
        pc.attach_grants(grants)
        rep = Reports(cat, clock=clock, profiles=pc) \
            .attach_device_store(store).attach_grants(grants)
        out = []
        for round_i in range(2):
            tk.reset_counters()
            finds = [rep.find(c, subject="mixed") for c in FIND_CRITERIA]
            lean = tk.policy_scan_store_scoped_lean_launches
            pk.reset_counters()
            cube = pc.cube(clock(), subject="tree-aud")
            launches[str(dev), round_i] = (
                lean, pk.profile_cube_scoped_launches)
            out.append((finds, cube.tobytes(), [
                (rep.top_files(k=10, subject=s), rep.du("/p", subject=s))
                for s in SUBJECTS]))
            _churn(cat, rng, 4000, 200)
        answers[str(dev)] = out
        store.detach()
    assert answers[str(cuda_device)] == answers["cpu"]
    for round_i in range(2):
        assert launches[str(cuda_device), round_i] == (len(FIND_CRITERIA),
                                                       groups)
        assert launches["cpu", round_i] == (0, 0)
