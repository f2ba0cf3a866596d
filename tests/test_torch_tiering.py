"""The port's tiered residency: placement under ``hbm_budget_rows``,
``PackedSegment`` demote/promote, and demoted groups streamed in windows.

1. ``tests/core/test_tiering.py`` on the port's
   ``DeviceColumnStore(..., device="cpu")``: its in-process cases at
   ``groups=1`` (everything demoted, every query streams), and its two
   8-device subprocess cases at ``groups=8`` in this process (mixed
   residency, heat-driven promotion, growth re-padding only the grown
   group); the unknown-subject diagnostics of the port's ``GrantTable``.
   Then the port's own layout: the compact ``(Dr, C+1(+4), Rp)`` tensor
   holds only the resident groups in gid order, and so do the permissions
   plane and the partial cubes; a group whose rows are not a multiple of
   the window streams its pad rows as invalid; a raced async pack is
   discarded; read-only mmap segments stream and promote.
2. Differential runs against the JAX package at one device: the same
   catalog, planes and ``GrantTable`` in both packages, the same budget and
   window; through cold, in-place churn, structural churn and a grant
   change every query, scoped and unscoped, gives the same answers
   (tolerance 0: paths, orders and counts are exact, and every sum is of
   f32-exact integers), and ``tiering_counters()`` are equal after each
   round (``window_stalls`` aside: the JAX CPU backend dispatches
   asynchronously, so its count depends on timing, and the port's CPU
   branch is synchronous and counts none).
3. One ``slow`` subprocess case: the JAX store on 8 fake devices beside the
   port at ``groups=8``; after cold, churn and structural rounds the same
   gids are resident, with equal answers and counters.
4. Tests marked ``cuda`` (they skip here): a streamed match on the card
   equal to the CPU store's, bit for bit on a second call, one store-form
   launch a window; the same with planted host and device delays in the
   staging and the copy.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T
from repro_torch.core import (Catalog, DeviceColumnStore, Entry, FsType,
                              GrantTable, PolicyDefinition, PolicyEngine,
                              parse_expr)
from repro_torch.core.profiles import GroupIndex
from repro_torch.kernels.policy_scan import kernel as tk
from repro_torch.kernels.profile_cube import kernel as pk

NOW = float(2 ** 20)          # f32-exact "now"
SRC = Path(__file__).resolve().parents[1] / "src"
EXPR = "size > 1M and last_access > 1000s"


def _entry(rng, i, pkg=T):
    return pkg.Entry(
        fid=i + 1, name=f"f{i + 1}", path=f"/p/d{i % 5}/f{i + 1}",
        type=pkg.FsType.FILE if rng.random() < 0.9 else pkg.FsType.DIR,
        size=int(rng.integers(0, 2 ** 12)) * 1024,           # f32-exact
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{int(rng.integers(0, 4))}",
        group=f"grp{int(rng.integers(0, 3))}",
        hsm_state=pkg.HsmState(int(rng.integers(0, 5))),
        atime=NOW - float(rng.integers(0, 10_000)),          # f32-exact
        mtime=NOW - float(rng.integers(0, 10_000)))


def _random_catalog(rng, n, n_shards=8, pkg=T):
    cat = pkg.Catalog(n_shards=n_shards)
    cat.upsert_batch([_entry(rng, i, pkg) for i in range(n)])
    return cat


def _grants(pkg=T):
    g = pkg.GrantTable()
    g.add_subject("user1")
    g.add_subject("aud", owners=(), subtrees=("/p/d2",))
    return g


def _full_setup(store, gi, pkg=T):
    store.enable_reports_plane()
    store.enable_cube_plane(gi, clock=lambda: NOW)
    store.enable_permissions_plane(_grants(pkg))


def _store(cat, **kw):
    return DeviceColumnStore(cat, device="cpu", tile=128, **kw)


def _pair(rng_seed=0, n=600, groups=1, **tier_kw):
    """(catalog, unbudgeted store, tiered store), the planes shared."""
    cat = _random_catalog(np.random.default_rng(rng_seed), n)
    gi = GroupIndex()
    ref = _store(cat, groups=groups)
    _full_setup(ref, gi)
    tier = _store(cat, groups=groups, **tier_kw)
    _full_setup(tier, gi)
    return cat, ref, tier


def _scan(store, expr, subject=None):
    """(sorted fids, aggregates) of one match with aggregates (the JAX
    store's ``scan`` takes no subject, so both go through ``match``)."""
    m = store.match([expr], NOW, subject=subject)
    return sorted(m.plan("size")[0].tolist()), m.agg


def _answers(store, expr, subjects=(None, "user1", "aud"), k=9):
    """Every query of the store, scoped and unscoped, as plain values."""
    out = {}
    for s in subjects:
        out["scan", s] = _scan(store, expr, s)
        out["find", s] = store.find_paths(expr, NOW, subject=s)
        out["cube", s] = store.analytics_cube(NOW, subject=s).tolist()
        for by in ("size", "atime"):
            for desc in (True, False):
                out["top", s, by, desc] = store.top_files(
                    by=by, k=k, desc=desc, now=NOW, subject=s)
        for pref in ("/p", "/p/d2", "/q"):
            out["du", s, pref] = store.du(pref, subject=s)
    return out


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


# -- 1. tests/core/test_tiering.py on the port ----------------------------------

def test_streaming_matches_resident_store_all_queries():
    # budget below one padded block: every group demotes, all queries
    # stream (the window reserve is carved out of the budget, so this
    # also covers "budget smaller than the reserve")
    cat, ref, tier = _pair(hbm_budget_rows=256, window_rows=128)
    expr = parse_expr("size > 1M and last_access > 1000s")
    f_ref, a_ref = ref.scan(expr, NOW)
    f_t, a_t = tier.scan(expr, NOW)
    assert tier.demotions >= 1
    assert tier.tiering_counters()["resident_groups"] == 0
    assert sorted(f_ref.tolist()) == sorted(f_t.tolist())
    assert a_ref == a_t
    for subj in (None, "user1", "aud"):
        assert (ref.find_paths(expr, NOW, subject=subj)
                == tier.find_paths(expr, NOW, subject=subj))
        assert np.array_equal(ref.analytics_cube(NOW, subject=subj),
                              tier.analytics_cube(NOW, subject=subj))
    for by in ("size", "atime"):
        assert (ref.top_files(by=by, k=7, now=NOW)
                == tier.top_files(by=by, k=7, now=NOW))
    for pref in ("/p", "/p/d2"):
        for subj in (None, "aud"):
            assert ref.du(pref, subject=subj) == tier.du(pref, subject=subj)
    tc = tier.tiering_counters()
    assert tc["segments_streamed"] > 0 and tc["windows_streamed"] > 0
    assert tier._buf is None and tier._slots == {}


def test_streamed_match_survives_churn_and_repack():
    cat, ref, tier = _pair(rng_seed=3, hbm_budget_rows=256, window_rows=128)
    expr = parse_expr("size > 2M")
    rng = np.random.default_rng(99)
    for _ in range(3):
        upd = rng.choice(np.arange(1, 601), size=50, replace=False)
        cat.update_fields_batch(upd.tolist(),
                                size=int(rng.integers(1, 2 ** 12)) * 1024,
                                atime=NOW - 321.0)
        f_ref, a_ref = ref.scan(expr, NOW)
        f_t, a_t = tier.scan(expr, NOW)
        assert sorted(f_ref.tolist()) == sorted(f_t.tolist())
        assert a_ref == a_t
        assert np.array_equal(ref.analytics_cube(NOW),
                              tier.analytics_cube(NOW))
    assert tier.segment_repacks >= 1      # churned segments re-encoded


def test_unlimited_budget_never_demotes():
    cat, ref, tier = _pair(rng_seed=5, hbm_budget_rows=None)
    f_ref, _ = ref.scan(parse_expr("size > 4M"), NOW)
    f_t, _ = tier.scan(parse_expr("size > 4M"), NOW)
    assert sorted(f_ref.tolist()) == sorted(f_t.tolist())
    assert tier.demotions == 0 and tier.segments_streamed == 0
    assert tier.tiering_counters()["demoted_groups"] == 0


def test_async_demote_commits_and_stays_correct():
    cat, ref, tier = _pair(rng_seed=7, hbm_budget_rows=256,
                           window_rows=128, demote_async=True)
    expr = parse_expr("size > 1M")
    f0, a0 = tier.scan(expr, NOW)         # launches the async pack
    tier.drain_demotions()
    f1, a1 = tier.scan(expr, NOW)         # served from the segment now
    f_ref, a_ref = ref.scan(expr, NOW)
    assert sorted(f1.tolist()) == sorted(f_ref.tolist()) \
        == sorted(f0.tolist())
    assert a1 == a_ref == a0
    assert tier.demotions >= 1 and tier.segments_streamed > 0


def test_segment_persists_beside_sqlite_mirror(tmp_path):
    db = str(tmp_path / "cat.db")
    cat = Catalog(n_shards=8, db_path=db)
    cat.upsert_batch([Entry(fid=i + 1, name=f"f{i}", path=f"/p/f{i}",
                            type=FsType.FILE, size=(i % 7) << 20,
                            atime=NOW - 50.0) for i in range(300)])
    store = _store(cat, hbm_budget_rows=128, window_rows=128)
    fids, _ = store.scan(parse_expr("size > 3M"), NOW)
    segs = [f for f in os.listdir(tmp_path) if ".seg" in f]
    assert store.demotions >= 1 and segs, segs
    ref = cat.arrays()
    want = ref["fid"][parse_expr("size > 3M").mask(ref, cat.strings, NOW)]
    assert sorted(fids.tolist()) == sorted(want.tolist())


def test_run_report_surfaces_tiering_counters():
    cat = _random_catalog(np.random.default_rng(21), 400)
    calls = []

    def act(e, p):
        return True
    act.action_batch = lambda b, p: (calls.extend(b.fids.tolist()),
                                     [True] * len(b))[1]
    eng = PolicyEngine(cat, clock=lambda: NOW, device="cpu")
    eng.register(PolicyDefinition.from_config(
        name="p", action=act, scope="type == file",
        rules=[("big", "size > 2M", {})], sort_by="atime", mutates=False))
    eng.attach_device_store(_store(cat, hbm_budget_rows=256,
                                   window_rows=128))
    r = eng.run("p", evaluator="policy_scan_mesh")
    assert r.evaluator == "policy_scan_mesh" and not r.fallback_reason
    assert r.tiering["demotions"] >= 1
    assert r.tiering["segments_streamed"] > 0
    assert r.tiering["resident_groups"] == 0
    calls_mesh = list(calls)
    calls.clear()
    rn = eng.run("p", evaluator="numpy")
    assert rn.tiering == {}               # host path: no store involved
    assert r.matched == rn.matched and calls_mesh == calls


def test_reports_facade_exposes_tiering_counters():
    from repro_torch.core.reports import Reports
    cat = _random_catalog(np.random.default_rng(23), 300)
    rep = Reports(cat, clock=lambda: NOW)
    assert rep.tiering_counters() == {}
    rep.attach_device_store(_store(cat, hbm_budget_rows=256,
                                   window_rows=128))
    paths = rep.find("size > 4M")
    assert rep.store_served >= 1 and rep.last_fallback_reason is None
    tc = rep.tiering_counters()
    assert tc["demotions"] >= 1 and tc["segments_streamed"] > 0
    ref = cat.arrays()
    mask = parse_expr("size > 4M").mask(ref, cat.strings, NOW)
    assert len(paths) == int(mask.sum())


def test_unknown_subject_error_names_known_subjects():
    g = GrantTable()
    with pytest.raises(KeyError, match="<none registered>"):
        g.subject_id("ghost")
    g.add_subject("alice")
    g.add_subject("bob")
    with pytest.raises(KeyError, match="alice, bob") as ei:
        g.subject("ghost")
    assert "unknown subject 'ghost'" in str(ei.value)


def test_mixed_residency_differential_on_eight_groups():
    """The reference's 8-device subprocess case at ``groups=8`` in this
    process: mixed residency, then heat-driven promotion of a churned
    demoted group."""
    rng = np.random.default_rng(0)
    cat = Catalog(n_shards=8)
    cat.upsert_batch([Entry(
        fid=i + 1, name=f"f{i}", path=f"/p/d{i % 5}/f{i}", type=FsType.FILE,
        size=int(rng.integers(0, 2 ** 12)) * 1024,
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{i % 4}", group=f"grp{i % 3}",
        atime=NOW - float(rng.integers(0, 10_000)))
        for i in range(2000)])
    gi = GroupIndex()
    ref = _store(cat, groups=8)
    _full_setup(ref, gi)
    # 2000 rows / 8 groups -> rp 384; budget 3000 holds 2 resident blocks
    # plus the 2*8*128 window reserve -> mixed residency
    tier = _store(cat, groups=8, hbm_budget_rows=3000, window_rows=128)
    _full_setup(tier, gi)
    expr = parse_expr(EXPR)
    f_ref, a_ref = ref.scan(expr, NOW)
    f_t, a_t = tier.scan(expr, NOW)
    tc = tier.tiering_counters()
    assert 0 < tc["resident_groups"] < 8, tc     # genuinely mixed
    assert tier._buf.shape[0] == tc["resident_groups"]
    assert sorted(f_ref.tolist()) == sorted(f_t.tolist())
    assert a_ref == a_t
    for subj in (None, "user1", "aud"):
        assert (ref.find_paths(expr, NOW, subject=subj)
                == tier.find_paths(expr, NOW, subject=subj)), subj
        assert np.array_equal(ref.analytics_cube(NOW, subject=subj),
                              tier.analytics_cube(NOW, subject=subj)), subj
    for by in ("size", "atime"):
        for subj in (None, "user1"):
            assert (ref.top_files(by=by, k=9, now=NOW, subject=subj)
                    == tier.top_files(by=by, k=9, now=NOW, subject=subj))
    for pref in ("/p", "/p/d2"):
        for subj in (None, "aud"):
            assert ref.du(pref, subject=subj) == tier.du(pref, subject=subj)
    # heat-driven promotion: churn one demoted group hard, watch it return
    # (shard = fid % n_shards; 8 shards over 8 groups puts shard g in
    # group g, so the demoted group's rows are the fids congruent to it)
    demoted = [g.gid for g in tier._groups if not g.resident]
    target_shard = tier._groups[demoted[0]].shard_ids[0]
    victim_fids = [f for f in range(1, 2001) if f % 8 == target_shard][:200]
    for _ in range(3):
        cat.update_fields_batch(victim_fids,
                                size=int(rng.integers(1, 2 ** 12)) * 1024)
        tier.scan(expr, NOW)
    assert tier.promotions >= 1, tier.tiering_counters()
    assert tier._groups[demoted[0]].resident
    f_ref2, a_ref2 = ref.scan(expr, NOW)
    f_t2, a_t2 = tier.scan(expr, NOW)
    assert sorted(f_ref2.tolist()) == sorted(f_t2.tolist()) and a_ref2 == a_t2
    assert np.array_equal(ref.analytics_cube(NOW), tier.analytics_cube(NOW))
    _assert_same(_answers(tier, expr), _answers(ref, expr))


def test_growth_repads_only_grown_group_on_eight_groups():
    """Growing ONE shard group must not re-upload the untouched groups:
    they are copied into the wider tensor on the device and keep serving
    identical results."""
    rng = np.random.default_rng(1)
    cat = Catalog(n_shards=8)
    cat.upsert_batch([Entry(fid=i + 1, name=f"f{i}", path=f"/p/f{i}",
                            type=FsType.FILE,
                            size=int(rng.integers(0, 2 ** 12)) * 1024,
                            atime=NOW - float(rng.integers(0, 10_000)))
                      for i in range(800)])
    store = _store(cat, groups=8)
    store.refresh()
    rp0 = store._rp
    full0 = store.full_uploads
    # shard = fid % 8 and shard s lives in group s: fids congruent to 0
    # grow ONLY group 0, far past the padded capacity
    cat.upsert_batch([Entry(fid=100_000 + 8 * i, name=f"g{i}",
                            path=f"/p/g{i}", type=FsType.FILE,
                            size=2 << 20, atime=NOW - 10.0)
                      for i in range(2000)])
    stats = store.refresh()
    assert store._rp > rp0
    assert store.full_uploads == full0 + 1, stats
    assert store.device_pads >= 7 and stats["padded"] >= 7, stats
    assert all(store._groups[g].uploaded for g in range(1, 8))
    fids, _ = store.scan(parse_expr("size > 1M"), NOW)
    ref = cat.arrays()
    want = ref["fid"][parse_expr("size > 1M").mask(ref, cat.strings, NOW)]
    assert sorted(fids.tolist()) == sorted(want.tolist())


# -- the port's compact resident tensor and its windows ----------------------------

def test_compact_tensor_holds_the_resident_groups_in_gid_order():
    """Under a budget the column tensor, the permissions plane and the
    partial cubes have one slice a resident group, in gid order, and a
    placement change copies the kept groups' slices on the device."""
    cat, ref, tier = _pair(rng_seed=11, n=2000, groups=8,
                           hbm_budget_rows=3000, window_rows=128)
    expr = parse_expr(EXPR)
    want = _answers(ref, expr)
    _assert_same(_answers(tier, expr), want)
    res = [g.gid for g in tier._groups if g.resident]
    assert tier._slots == {gid: i for i, gid in enumerate(res)}
    assert tier._buf.shape[0] == len(res) == \
        tier.tiering_counters()["resident_groups"]
    assert tier._perm_buf.shape[0] == len(res)
    assert tier._cube_partials.shape[0] == len(res)
    for gid, slot in tier._slots.items():
        # each slice is the group's own block, as the unbudgeted store's
        # (whose Rp may be wider: it pads for all 8 groups)
        n = tier._groups[gid].rows
        assert torch.equal(tier._buf[slot, :, :n],
                           ref._buf[ref._slots[gid], :, :n])
        assert not tier._buf[slot, :, n:].any()
        w = -(-n // 32)
        assert torch.equal(tier._perm_buf[slot, :, :w],
                           ref._perm_buf[ref._slots[gid], :, :w])
        assert torch.equal(tier._cube_partials[slot],
                           ref._cube_partials[ref._slots[gid]])
    # churn a demoted group until it promotes: the kept groups' slices
    # are copied, not re-uploaded, and their words are not repacked
    victim = [g for g in tier._groups if not g.resident][0]
    fids = [f for f in range(1, 2001)
            if f % 8 == victim.shard_ids[0]][:40]    # under refresh_frac
    uploads = tier.full_uploads
    for i in range(3):
        cat.update_fields_batch(fids, size=(i + 1) << 20)
        tier.refresh()
    assert victim.resident and tier.promotions >= 1
    assert tier.demotions >= 3
    # one upload for the promoted group, none for the kept one
    assert tier.full_uploads == uploads + tier.promotions
    _assert_same(_answers(tier, expr), _answers(ref, expr))
    res = [g.gid for g in tier._groups if g.resident]
    assert list(tier._slots) == res and tier._buf.shape[0] == len(res)


def test_partial_final_window_reads_its_pad_rows_invalid():
    """A group of 600 rows through windows of 1 x 256 rows: the last
    window holds 88 rows and 168 zero rows, which must match nothing,
    count nowhere and never be listed."""
    cat, ref, tier = _pair(rng_seed=13, n=600, hbm_budget_rows=256,
                           window_rows=256)
    assert tier._window_rows() == 256
    expr = parse_expr("size >= 0")          # every valid row
    _assert_same(_answers(tier, expr), _answers(ref, expr))
    fids, agg = tier.scan(expr, NOW)
    assert agg["count"] == 600 and len(fids) == 600
    assert tier.windows_streamed % 3 == 0   # 3 windows a sweep
    # ascending top-k over sizes of 0 would pick zero pad rows if their
    # validity were not 0
    low = tier.top_files(by="size", k=5, desc=False)
    assert low == ref.top_files(by="size", k=5, desc=False)


def test_streamed_age_buckets_follow_the_cube_reference():
    """A scoped cube over a demoted group bins by the age buckets as of
    the query's ``now``: the cached stack's AB row re-derives when the
    cube reference moves, and the frozen partial refreezes."""
    cat, ref, tier = _pair(rng_seed=17, hbm_budget_rows=256,
                           window_rows=128)
    for dt in (0.0, 3 * 86400.0, 40 * 86400.0, 400 * 86400.0):
        for s in (None, "user1", "aud"):
            assert np.array_equal(ref.analytics_cube(NOW + dt, subject=s),
                                  tier.analytics_cube(NOW + dt, subject=s))
    assert tier.rollovers > 0


def test_async_pack_raced_by_churn_is_discarded():
    """A pack whose group churned before its commit is thrown away
    (``demote_races``) and the group keeps serving resident."""
    cat, ref, tier = _pair(rng_seed=19, hbm_budget_rows=256,
                           window_rows=128, demote_async=True)
    expr = parse_expr("size > 1M")
    with tier._lock:                        # the worker cannot commit yet
        tier.refresh()
        assert tier._groups[0].pending_demote
        cat.update_fields_batch([1, 2, 3], size=5 << 20)
    tier.drain_demotions()
    assert tier.demote_races == 1 and tier.demotions == 0
    assert tier._groups[0].resident
    f_ref, a_ref = ref.scan(expr, NOW)
    f_t, a_t = tier.scan(expr, NOW)
    assert sorted(f_ref.tolist()) == sorted(f_t.tolist()) and a_ref == a_t


def test_mmap_segments_stream_and_promote(tmp_path):
    """Segments saved beside the sqlite mirror load as read-only maps:
    streaming copies out of them and a promotion copies them into
    writable mirrors, which a later delta refresh patches in place."""
    db = str(tmp_path / "cat.db")
    rng = np.random.default_rng(29)
    cat = Catalog(n_shards=8, db_path=db)
    cat.upsert_batch([_entry(rng, i) for i in range(600)])
    gi = GroupIndex()
    ref = _store(cat)
    _full_setup(ref, gi)
    tier = _store(cat, hbm_budget_rows=256, window_rows=128)
    _full_setup(tier, gi)
    expr = parse_expr(EXPR)
    _assert_same(_answers(tier, expr), _answers(ref, expr))
    seg = tier._groups[0].segment
    assert any(isinstance(a, np.memmap) for a in seg._arrays.values())
    tier.hbm_budget_rows = None             # everything promotes
    tier.refresh()
    g = tier._groups[0]
    assert g.resident and tier.promotions == 1
    assert all(a.flags.writeable for a in g.cols.values())
    cat.update_fields_batch([5, 6], size=3 << 20)
    _assert_same(_answers(tier, expr), _answers(ref, expr))
    assert tier.delta_refreshes >= 1


# -- 2. differential against the JAX package at one device -----------------------

def _jax():
    pytest.importorskip("jax")
    import repro.core as J
    from repro.core.profiles import GroupIndex as JGroupIndex
    from repro.launch.mesh import make_shards_mesh
    return J, JGroupIndex, make_shards_mesh


def _tiering(store):
    tc = store.tiering_counters()
    tc.pop("window_stalls")
    return tc


@pytest.mark.parametrize("kw", [
    dict(hbm_budget_rows=256, window_rows=128),
    dict(hbm_budget_rows=256, window_rows=256, demote_async=True),
    dict(hbm_budget_rows=900, window_rows=128)],
    ids=["demoted", "async", "budget-fits"])
def test_queries_and_counters_match_jax(kw):
    J, JGI, make_mesh = _jax()
    cats = {name: _random_catalog(np.random.default_rng(31), 600, pkg=pkg)
            for name, pkg in (("jax", J), ("port", T))}
    stores = {
        "jax": J.DeviceColumnStore(cats["jax"], make_mesh(), tile=128, **kw),
        "port": _store(cats["port"], **kw)}
    gis = {"jax": JGI(), "port": GroupIndex()}
    grants = {}
    for name, pkg in (("jax", J), ("port", T)):
        _full_setup(stores[name], gis[name], pkg)
        grants[name] = stores[name]._grants
    rng = np.random.default_rng(37)
    for round_i in range(4):
        live = sorted(e.fid for e in cats["port"].entries())
        if round_i == 1:
            upd = rng.choice(live, size=60, replace=False).tolist()
            for cat in cats.values():
                cat.update_fields_batch(upd, size=7 << 20,
                                        atime=NOW - 5.0, owner="user1")
        elif round_i == 2:
            gone = rng.choice(live, size=20, replace=False).tolist()
            fresh = rng.integers(0, 10 ** 6)
            for name, pkg in (("jax", J), ("port", T)):
                for f in gone:
                    cats[name].remove(int(f))
                r = np.random.default_rng(fresh)
                cats[name].upsert_batch([_entry(r, max(live) + i, pkg)
                                         for i in range(30)])
        elif round_i == 3:
            for g in grants.values():
                g.grant("aud", subtrees=("/p/d4",))
                g.add_subject("late", owners=("user2",))
        subjects = (None, "user1", "aud") + (("late",) if round_i == 3
                                             else ())
        out = {}
        for name, store in stores.items():
            store.refresh()
            store.drain_demotions()
            out[name] = _answers(store, parse_expr(EXPR), subjects)
        _assert_same(out["port"], out["jax"])
        assert _tiering(stores["port"]) == _tiering(stores["jax"]), round_i
        for c in ("full_uploads", "delta_refreshes", "rows_scattered",
                  "cube_rebuilds", "rollovers", "store_queries",
                  "perm_materializations", "perm_word_scatters"):
            assert (getattr(stores["port"], c)
                    == getattr(stores["jax"], c)), (round_i, c)
    assert stores["port"].windows_streamed > 0 or kw["hbm_budget_rows"] > 256


# -- 3. the JAX store on 8 fake devices beside the port at groups=8 --------------

_EIGHT = """
import numpy as np
import repro.core as J
import repro_torch.core as T
from repro.core.profiles import GroupIndex as JGI
from repro_torch.core.profiles import GroupIndex as TGI
from repro.launch.mesh import make_shards_mesh

NOW = float(2 ** 20)
rows = []
rng = np.random.default_rng(0)
for i in range(2000):
    rows.append(dict(
        fid=i + 1, name=f"f{i}", path=f"/p/d{i % 5}/f{i}",
        size=int(rng.integers(0, 2 ** 12)) * 1024,
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{i % 4}", group=f"grp{i % 3}",
        atime=NOW - float(rng.integers(0, 10_000))))

def entries(pkg, rs):
    return [pkg.Entry(type=pkg.FsType.FILE, **r) for r in rs]

cats, stores = {}, {}
for name, pkg, gi in (("jax", J, JGI()), ("port", T, TGI())):
    cat = pkg.Catalog(n_shards=8)
    cat.upsert_batch(entries(pkg, rows))
    kw = dict(tile=128, hbm_budget_rows=3000, window_rows=128)
    store = (J.DeviceColumnStore(cat, make_shards_mesh(8), **kw)
             if name == "jax" else
             T.DeviceColumnStore(cat, groups=8, device="cpu", **kw))
    store.enable_reports_plane()
    store.enable_cube_plane(gi, clock=lambda: NOW)
    g = pkg.GrantTable()
    g.add_subject("user1")
    g.add_subject("aud", owners=(), subtrees=("/p/d2",))
    store.enable_permissions_plane(g)
    cats[name], stores[name] = cat, store

expr = {n: pkg.parse_expr("size > 1M and last_access > 1000s")
        for n, pkg in (("jax", J), ("port", T))}

def answers(name):
    s, e = stores[name], expr[name]
    out = {}
    for subj in (None, "user1", "aud"):
        m = s.match([e], NOW, subject=subj)
        out["scan", subj] = (sorted(m.plan("size")[0].tolist()), m.agg)
        out["find", subj] = s.find_paths(e, NOW, subject=subj)
        out["cube", subj] = s.analytics_cube(NOW, subject=subj).tolist()
        for by in ("size", "atime"):
            out["top", subj, by] = s.top_files(by=by, k=9, now=NOW,
                                               subject=subj)
        for pref in ("/p", "/p/d2"):
            out["du", subj, pref] = s.du(pref, subject=subj)
    return out

def check(tag):
    a = {n: answers(n) for n in stores}
    for key in a["jax"]:
        assert a["port"][key] == a["jax"][key], (tag, key)
    res = {n: [g.gid for g in s._groups if g.resident]
           for n, s in stores.items()}
    assert res["port"] == res["jax"], (tag, res)
    tc = {}
    for n, s in stores.items():
        tc[n] = s.tiering_counters()
        tc[n].pop("window_stalls")
    assert tc["port"] == tc["jax"], (tag, tc)
    assert stores["port"]._buf.shape[0] == len(res["port"])
    print(tag, res["port"], tc["port"])

check("cold")
assert 0 < len([g for g in stores["port"]._groups if g.resident]) < 8
demoted = [g.gid for g in stores["port"]._groups if not g.resident]
victims = [f for f in range(1, 2001) if f % 8 == demoted[0]][:200]
for i in range(3):
    for cat in cats.values():
        cat.update_fields_batch(victims, size=(i + 1) * 1024 * 1024)
    check(f"churn{i}")
assert stores["port"].promotions >= 1
gone = [f for f in range(1, 2001) if f % 8 == 3][:40]
for name, pkg in (("jax", J), ("port", T)):
    for f in gone:
        cats[name].remove(f)
    cats[name].upsert_batch(entries(pkg, [dict(r, fid=10_000 + r["fid"])
                                          for r in rows[:40]]))
check("structural")
print("OK")
"""


@pytest.mark.slow
def test_same_gids_resident_as_jax_on_eight_devices():
    pytest.importorskip("jax")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _EIGHT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-3000:]}"
    assert "OK" in out.stdout


# -- 4. on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the store-form and cube kernels run "
                    "only there")
    return torch.device("cuda")


def _same_on_card(got, want):
    """``_assert_same`` for a card store against the CPU store: the
    aggregates' sums are f32 on both sides, rounded in another order, so
    they agree within the repo's tolerance; everything else is exact."""
    assert got.keys() == want.keys()
    for key in want:
        if key[0] != "scan":
            assert got[key] == want[key], key
            continue
        (gf, ga), (wf, wa) = got[key], want[key]
        assert gf == wf and ga.keys() == wa.keys(), key
        for k in wa:
            if k in ("volume", "spc_used", "rule_volume", "rule_spc_used"):
                np.testing.assert_allclose(ga[k], wa[k], rtol=1e-5, atol=1)
            else:
                assert ga[k] == wa[k], (key, k)


def _card_pair(device, seed=41, n=5000, **kw):
    """The same catalog under a CPU store and a budgeted store on the
    card (tile 128: 4 groups of about 1,250 rows, windows of 4 x 128)."""
    cat = _random_catalog(np.random.default_rng(seed), n)
    gi = GroupIndex()
    host = DeviceColumnStore(cat, groups=4, device="cpu", tile=128)
    _full_setup(host, gi)
    card = DeviceColumnStore(cat, groups=4, device=device, tile=128,
                             hbm_budget_rows=2 * 1664 + 2 * 4 * 128,
                             window_rows=128, **kw)
    _full_setup(card, gi)
    return cat, host, card


@pytest.mark.cuda
def test_cuda_streamed_match_one_launch_a_window(cuda_device):
    cat, host, card = _card_pair(cuda_device)
    expr = parse_expr(EXPR)
    card.refresh()
    tc = card.tiering_counters()
    assert tc["resident_groups"] == 2 and tc["demoted_groups"] == 2
    for subject in (None, "aud"):
        runs = []
        for _ in range(2):
            w0 = card.windows_streamed
            tk.reset_counters()
            m = card.match([expr], NOW, subject=subject)
            forms = (tk.policy_scan_store_scoped_launches if subject
                     else tk.policy_scan_store_launches)
            assert forms == 1 + card.windows_streamed - w0
            runs.append((m.plan("fid"), m.agg))
        want = host.match([expr], NOW, subject=subject)
        for a, b in zip(runs[0][0], runs[1][0]):
            assert a.tobytes() == b.tobytes()   # bit for bit, twice
        for a, b in zip(runs[0][0], want.plan("fid")):
            assert np.array_equal(np.sort(a), np.sort(b))
        assert runs[0][1] == runs[1][1]
        _same_on_card({("scan", subject): ([], runs[0][1])},
                      {("scan", subject): ([], want.agg)})
    pk.reset_counters()
    got = card.analytics_cube(NOW, subject="user1")
    assert np.array_equal(got, host.analytics_cube(NOW, subject="user1"))
    # one a resident group, one a window (3 a demoted group)
    assert pk.profile_cube_scoped_launches == 2 + 2 * 3
    _same_on_card(_answers(card, expr), _answers(host, expr))


@pytest.mark.cuda
def test_cuda_streaming_holds_under_planted_delays(cuda_device, monkeypatch):
    """A host delay in the staging and a device delay ahead of each copy
    on the side stream: a missing wait on a copy or a launch event would
    let a launch read a window before it lands, or a staging buffer be
    rewritten under its copy; the answers stay those of the CPU store."""
    from repro_torch.core import device_store as ds
    cat, host, card = _card_pair(cuda_device, seed=43)
    stage, copy = ds.DeviceColumnStore._stage_window, \
        ds.DeviceColumnStore._copy_window

    def slow_stage(self, *a):
        time.sleep(0.002)
        return stage(self, *a)

    def slow_copy(self, side, *a):
        with torch.cuda.stream(side):
            torch.cuda._sleep(2_000_000)     # ~1 ms of the side stream
        return copy(self, side, *a)
    monkeypatch.setattr(ds.DeviceColumnStore, "_stage_window", slow_stage)
    monkeypatch.setattr(ds.DeviceColumnStore, "_copy_window", slow_copy)
    expr = parse_expr(EXPR)
    _same_on_card(_answers(card, expr), _answers(host, expr))
    assert card.windows_streamed > 0
