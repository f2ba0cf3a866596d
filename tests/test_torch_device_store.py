"""The port's resident column store and its ``policy_scan_mesh`` evaluator.

1. The cases of ``tests/core/test_device_store.py`` on the port's
   ``DeviceColumnStore(..., device="cpu")``: its 8-device subprocess case
   becomes ``groups=8`` in this process, and the foreign-catalog /
   missing-axis case becomes a foreign-catalog case and a ``groups < 1``
   case. (``test_trajectory_creates_missing_dir`` tests the JAX package's
   benchmark runner, not the store, and stays there.)
2. Differential runs against the JAX package: one catalog built in both
   packages (same entries, same order); ``numpy``, ``policy_scan`` and
   ``policy_scan_mesh`` in each must action identical (fid, rule params)
   sequences for ``groups`` 1 and 8, with and without budgets, across
   in-place churn, inserts and removes, and growth past ``Rp``; at
   ``groups=1`` the refresh counters, ``MeshMatch.plan`` arrays (byte for
   byte) and aggregates must equal the reference store's.
3. The op: the port's plain ``mesh_policy_scan_batch`` over a
   ``(D, C+1, Rp)`` tensor against the reference's
   ``mesh_policy_scan_batch(use_kernel=False)`` one group at a time on a
   1-device mesh, aggregates summed over the groups: masks and rule
   identical, aggregates equal (tolerance 0) on f32-exact data; and the
   kernel's plain version (``ref.policy_scan_store_ref``) equal to both.
4. The kernel's store-form tile walk and lean stage plan, built for the
   host with a C++ compiler.
5. Tests marked ``cuda`` hold the store-form kernel to its plain version
   on the card (they skip here).
"""
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T
from repro_torch.core import (Catalog, DeviceColumnStore, Entry, FsType,
                              PolicyDefinition, PolicyEngine, parse_expr)
from repro_torch.core.catalog import StringTable
from repro_torch.core.policy import (KERNEL_COLUMNS, PolicyError, all_of,
                                     any_of, compile_programs)
from repro_torch.kernels.policy_scan import kernel as tk
from repro_torch.kernels.policy_scan import ops as tops
from repro_torch.kernels.policy_scan import ref as tref

NOW = float(2 ** 20)          # f32-exact "now"
SIZE = KERNEL_COLUMNS.index("size")
BLOCKS = KERNEL_COLUMNS.index("blocks")
VALID = len(KERNEL_COLUMNS)
N_COLS = VALID + 1
TOL = dict(rtol=1e-5, atol=1)
CSRC = Path(tk.__file__).resolve().parent / "csrc"

CONDITIONS = [
    "size > 16M",
    "size <= 4M",
    "owner == 'user1'",
    "last_access > 1000s",
    "hsm_state == archived",
    "size > 8M or owner == 'user0'",
    "not (size <= 1M or last_access <= 500s)",
]


def _entry_rows(rng, n, fid0=1):
    """n entries as plain dicts (both packages build theirs from these),
    every value f32-exact."""
    return [dict(
        fid=fid0 + i, name=f"f{fid0 + i}", path=f"/p/d{i % 5}/f{fid0 + i}",
        type=0 if rng.random() < 0.9 else 1,
        size=int(rng.integers(0, 2 ** 15)) * 1024,
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{int(rng.integers(0, 4))}",
        group=f"grp{int(rng.integers(0, 3))}",
        hsm_state=int(rng.integers(0, 5)),
        atime=NOW - float(rng.integers(0, 10_000)),
        mtime=NOW - float(rng.integers(0, 10_000)),
    ) for i in range(n)]


def _entries(pkg, rows):
    return [pkg.Entry(**dict(r, type=pkg.FsType(r["type"]),
                             hsm_state=pkg.HsmState(r["hsm_state"])))
            for r in rows]


def _random_catalog(rng, n, n_shards=8, pkg=T):
    cat = pkg.Catalog(n_shards=n_shards)
    cat.upsert_batch(_entries(pkg, _entry_rows(rng, n)))
    return cat


def _policy_config(rng):
    n_rules = int(rng.integers(1, 4))
    conds = rng.choice(len(CONDITIONS), size=n_rules, replace=False)
    return dict(
        name="p",
        scope=["true", "type == file"][int(rng.integers(0, 2))],
        rules=[(f"r{i}", CONDITIONS[int(c)], {"tag": f"r{i}"})
               for i, c in enumerate(conds)],
        sort_by=["atime", "size", "mtime"][int(rng.integers(0, 3))],
        sort_desc=bool(rng.integers(0, 2)),
        n_threads=1, batch_size=64, mutates=False)


def _random_policy(rng, action, pkg=T, **extra):
    return pkg.PolicyDefinition.from_config(
        action=action, **dict(_policy_config(rng), **extra))


class BatchRecorder:
    """Records the actioned fids, or (fid, rule tag) pairs with ``tags``."""

    def __init__(self, tags=False):
        self.lock = threading.Lock()
        self.calls = []

        def action_batch(batch, params):
            with self.lock:
                self.calls.extend(
                    [(f, params.get("tag")) for f in batch.fids.tolist()]
                    if tags else batch.fids.tolist())
            return [True] * len(batch)

        self.action_batch = action_batch
        self.tags = tags

    def __call__(self, e, params):
        with self.lock:
            self.calls.append((e.fid, params.get("tag")) if self.tags
                              else e.fid)
        return True


def _engine_with_store(cat, policy, clock_t=NOW, groups=1, **kw):
    eng = PolicyEngine(cat, clock=lambda: clock_t, device="cpu")
    eng.register(policy)
    eng.attach_device_store(DeviceColumnStore(cat, groups=groups,
                                              device="cpu", **kw))
    return eng


# -- 1. tests/core/test_device_store.py on the port ---------------------------

@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_matches_numpy_and_single_launch(seed, groups):
    rng = np.random.default_rng(seed)
    cat = _random_catalog(rng, 500)
    results = {}
    for evaluator in ("numpy", "policy_scan", "policy_scan_mesh"):
        rec = BatchRecorder()
        policy = _random_policy(np.random.default_rng(seed + 100), rec)
        eng = _engine_with_store(cat, policy, groups=groups)
        r = eng.run("p", evaluator=evaluator)
        assert r.evaluator == evaluator, r.fallback_reason
        assert r.fallback_reason == ""
        results[evaluator] = (r.matched, r.succeeded, r.volume,
                              list(rec.calls))
    assert results["policy_scan_mesh"] == results["numpy"]
    assert results["policy_scan"] == results["numpy"]


@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_mesh_differential_across_churn_rounds(seed, groups):
    """Warm store (delta-scatter refreshed) keeps actioning the exact
    sequence a cold numpy scan of the same catalog state produces."""
    rng = np.random.default_rng(seed + 50)
    cat = _random_catalog(rng, 600)
    rec = BatchRecorder()
    policy = _random_policy(np.random.default_rng(seed + 150), rec)
    eng = _engine_with_store(cat, policy, groups=groups)
    eng.run("p", evaluator="policy_scan_mesh")       # cold upload
    store = eng.device_store
    live = np.arange(1, 601)
    for round_i in range(3):
        upd = rng.choice(live, size=40, replace=False)
        cat.update_fields_batch(
            upd.tolist(), size=int(rng.integers(0, 2 ** 15)) * 1024,
            atime=NOW - float(rng.integers(0, 10_000)))
        before = store.delta_refreshes
        rec.calls.clear()
        r_mesh = eng.run("p", evaluator="policy_scan_mesh")
        mesh_calls = list(rec.calls)
        assert store.delta_refreshes > before     # warm path: scatter, not restack
        rec.calls.clear()
        r_np = eng.run("p", evaluator="numpy")
        assert r_mesh.matched == r_np.matched
        assert mesh_calls == list(rec.calls), f"round {round_i}"


def test_scatter_refresh_equals_cold_upload_after_churn():
    rng = np.random.default_rng(7)
    cat = _random_catalog(rng, 400)
    expr = parse_expr("size > 8M and last_access > 2000s")
    warm = DeviceColumnStore(cat, device="cpu")
    warm.refresh()                                   # cold upload now
    upd = rng.choice(np.arange(1, 401), size=30, replace=False)
    cat.update_fields_batch(upd.tolist(), size=100 << 20, atime=NOW - 5000.0)
    fids_warm, agg_warm = warm.scan(expr, NOW)
    assert warm.delta_refreshes > 0 and warm.rows_scattered >= 30
    cold = DeviceColumnStore(cat, device="cpu")      # fresh: full upload
    fids_cold, agg_cold = cold.scan(expr, NOW)
    assert cold.delta_refreshes == 0 and cold.full_uploads > 0
    assert sorted(fids_warm.tolist()) == sorted(fids_cold.tolist())
    assert agg_warm["count"] == agg_cold["count"]
    assert agg_warm["volume"] == agg_cold["volume"]


def test_add_remove_rows_forces_full_reupload():
    rng = np.random.default_rng(9)
    cat = _random_catalog(rng, 300)
    expr = parse_expr("size > 1M")
    store = DeviceColumnStore(cat, device="cpu")
    store.scan(expr, NOW)
    uploads0 = store.full_uploads
    cat.remove(11)
    cat.upsert(Entry(fid=5001, name="n", path="/p/n", type=FsType.FILE,
                     size=64 << 20, atime=NOW - 100.0))
    fids, _ = store.scan(expr, NOW)
    assert store.full_uploads > uploads0             # structural fallback
    ref = cat.arrays()
    ref_fids = ref["fid"][expr.mask(ref, cat.strings, NOW)]
    assert sorted(fids.tolist()) == sorted(ref_fids.tolist())
    assert 11 not in fids.tolist() and 5001 in fids.tolist()


def test_churn_threshold_falls_back_to_full_upload():
    rng = np.random.default_rng(11)
    cat = _random_catalog(rng, 200)
    store = DeviceColumnStore(cat, device="cpu", refresh_frac=0.05)
    store.refresh()
    # churn far above 5% of every group's rows
    cat.update_fields_batch(list(range(1, 150)), size=99 << 20)
    stats = store.refresh()
    assert stats["delta"] == 0 and stats["full"] > 0
    fids, _ = store.scan(parse_expr("size > 90M"), NOW)
    assert sorted(fids.tolist()) == list(range(1, 150))


@pytest.mark.parametrize("groups", [1, 8])
def test_growth_repads_and_stays_correct(groups):
    rng = np.random.default_rng(13)
    cat = _random_catalog(rng, 100)
    store = DeviceColumnStore(cat, groups=groups, device="cpu", tile=128)
    store.refresh()
    rp0 = store._rp
    cat.upsert_batch([Entry(fid=10_000 + i, name=f"g{i}", path=f"/p/g{i}",
                            type=FsType.FILE, size=2 << 20,
                            atime=NOW - 10.0) for i in range(3000)])
    fids, _ = store.scan(parse_expr("size > 1M"), NOW)
    assert store._rp > rp0
    assert store._buf.shape == (groups, N_COLS, store._rp)
    ref = cat.arrays()
    ref_fids = ref["fid"][parse_expr("size > 1M").mask(ref, cat.strings, NOW)]
    assert sorted(fids.tolist()) == sorted(ref_fids.tolist())


def test_growth_of_one_group_pads_the_others_on_the_device():
    """Inserts into one shard grow its group past Rp: only that group
    uploads from the host, the clean ones are copied into the wider
    tensor (``device_pads``) and still match."""
    rng = np.random.default_rng(14)
    cat = _random_catalog(rng, 400, n_shards=4)
    store = DeviceColumnStore(cat, groups=4, device="cpu", tile=128)
    store.refresh()
    rp0, uploads0 = store._rp, store.full_uploads
    grow = [f for f in range(20_000, 40_000)
            if cat._shard_id(f) == 2][:600]
    cat.upsert_batch([Entry(fid=f, name=f"g{f}", path=f"/p/g{f}",
                            type=FsType.FILE, size=3 << 20,
                            atime=NOW - 10.0) for f in grow])
    stats = store.refresh()
    assert store._rp > rp0
    assert stats == {"full": 1, "delta": 0, "fresh": 3, "padded": 3}
    assert store.full_uploads == uploads0 + 1 and store.device_pads == 3
    expr = parse_expr("size > 2M")
    fids, _ = store.scan(expr, NOW)
    ref = cat.arrays()
    assert sorted(fids.tolist()) == sorted(
        ref["fid"][expr.mask(ref, cat.strings, NOW)].tolist())


def test_fresh_store_skips_upload_when_quiet():
    cat = _random_catalog(np.random.default_rng(15), 150)
    store = DeviceColumnStore(cat, device="cpu")
    store.refresh()
    stats = store.refresh()                          # no churn in between
    assert stats == {"full": 0, "delta": 0,
                     "fresh": store.n_groups, "padded": 0}


def test_scan_catalog_routes_through_store():
    from repro_torch.kernels.policy_scan.ops import scan_catalog
    cat = _random_catalog(np.random.default_rng(17), 250)
    expr = parse_expr("size > 4M and last_access > 1000s")
    store = DeviceColumnStore(cat, device="cpu")
    fids_store, agg_store = scan_catalog(cat, expr, NOW, store=store)
    fids_up, agg_up = scan_catalog(cat, expr, NOW, use_kernel=False,
                                   device="cpu")
    assert sorted(fids_store.tolist()) == sorted(fids_up.tolist())
    assert agg_store["count"] == agg_up["count"]
    assert agg_store["volume"] == agg_up["volume"]
    assert agg_store["size_profile"] == agg_up["size_profile"]


def test_match_programs_mesh_agrees_with_match_programs():
    from repro_torch.kernels.policy_scan.ops import (match_programs,
                                                     match_programs_mesh)
    rng = np.random.default_rng(19)
    cat = _random_catalog(rng, 350)
    policy = _random_policy(np.random.default_rng(20), None)
    rule_exprs = [r.condition for r in policy.rules]
    exprs = [all_of([policy.scope, any_of(rule_exprs)])] + rule_exprs
    store = DeviceColumnStore(cat, device="cpu")
    mesh = match_programs_mesh(store, exprs, NOW)
    masks, agg, rule_idx = match_programs(cat.arrays(), exprs, cat.strings,
                                          NOW, use_kernel=False,
                                          device="cpu")
    fids, sizes, _sort, ridx = mesh.plan(policy.sort_by)
    arrays = cat.arrays()
    ref_fids = arrays["fid"][masks[0]]
    order = np.argsort(fids)
    ref_order = np.argsort(ref_fids)
    np.testing.assert_array_equal(fids[order], ref_fids[ref_order])
    np.testing.assert_array_equal(sizes[order],
                                  arrays["size"][masks[0]][ref_order])
    np.testing.assert_array_equal(ridx[order],
                                  rule_idx[masks[0]][ref_order])
    assert mesh.agg["count"] == agg["count"]
    assert mesh.agg["rule_count"] == agg["rule_count"]


def test_store_rejects_foreign_catalog():
    cat = _random_catalog(np.random.default_rng(23), 50)
    other = _random_catalog(np.random.default_rng(24), 50)
    eng = PolicyEngine(cat, device="cpu")
    store = DeviceColumnStore(other, device="cpu")
    with pytest.raises(PolicyError):
        eng.attach_device_store(store)


@pytest.mark.parametrize("groups", [0, -1])
def test_store_rejects_fewer_than_one_group(groups):
    cat = _random_catalog(np.random.default_rng(23), 50)
    with pytest.raises(PolicyError):
        DeviceColumnStore(cat, groups=groups, device="cpu")
    assert not cat._hooks                  # raised before subscribing


def test_mesh_differential_on_eight_groups():
    """The reference's 8-device subprocess case as 8 shard groups here."""
    rng = np.random.default_rng(0)
    cat = Catalog(n_shards=16)
    cat.upsert_batch([Entry(fid=i + 1, name=f"f{i}", path=f"/p/f{i}",
                            type=FsType.FILE,
                            size=int(rng.integers(0, 2 ** 15)) * 1024,
                            owner=f"user{i % 4}",
                            atime=NOW - float(rng.integers(0, 10_000)))
                      for i in range(3000)])
    acted = []

    def act(e, p):
        return True
    act.action_batch = lambda b, p: (acted.extend(b.fids.tolist()),
                                     [True] * len(b))[1]
    eng = PolicyEngine(cat, clock=lambda: NOW, device="cpu")
    eng.register(PolicyDefinition.from_config(
        name="p", action=act, scope="type == file",
        rules=[("big", "size > 16M", {}), ("cold", "last_access > 5000s", {})],
        sort_by="atime", mutates=False))
    store = DeviceColumnStore(cat, groups=8, device="cpu")
    assert store._buf is None and store.n_groups == 8
    eng.attach_device_store(store)
    r = eng.run("p", evaluator="policy_scan_mesh")
    assert r.evaluator == "policy_scan_mesh" and not r.fallback_reason
    assert store._buf.shape[0] == 8
    mesh_calls = list(acted)
    acted.clear()
    rn = eng.run("p", evaluator="numpy")
    assert r.matched == rn.matched and mesh_calls == acted
    # warm delta refresh on every group
    cat.update_fields_batch(list(range(1, 3000, 37)), size=200 << 20)
    acted.clear()
    eng.run("p", evaluator="policy_scan_mesh")
    assert store.delta_refreshes == 8        # every group scattered, none restacked
    mesh_calls = list(acted)
    acted.clear()
    eng.run("p", evaluator="numpy")
    assert mesh_calls == acted
    # the store's plain op agrees with the host mask (the kernel's
    # agreement is held on the card by the cuda tests below)
    expr = parse_expr("size > 16M")
    fids_r, _ = store.scan(expr, NOW)
    arrays = cat.arrays()
    assert sorted(fids_r.tolist()) == sorted(
        arrays["fid"][expr.mask(arrays, cat.strings, NOW)].tolist())


def test_sort_by_fid_plans_and_parent_fid_falls_back():
    """fid is a valid mirror sort key; parent_fid (not mirrored) must
    degrade to the host path with a recorded reason, not crash."""
    cat = _random_catalog(np.random.default_rng(31), 200)
    rec = BatchRecorder()
    policy = PolicyDefinition.from_config(
        name="p", action=rec, scope="type == file",
        rules=[("any", "size >= 0", {})], sort_by="fid", mutates=False)
    eng = _engine_with_store(cat, policy)
    r = eng.run("p", evaluator="policy_scan_mesh")
    assert r.evaluator == "policy_scan_mesh" and not r.fallback_reason
    mesh_calls = list(rec.calls)
    rec.calls.clear()
    eng.run("p", evaluator="numpy")
    assert mesh_calls == rec.calls
    policy2 = PolicyDefinition.from_config(
        name="q", action=rec, scope="type == file",
        rules=[("any", "size >= 0", {})], sort_by="parent_fid",
        mutates=False)
    eng.register(policy2)
    r2 = eng.run("q", evaluator="policy_scan_mesh")
    assert r2.evaluator in ("policy_scan", "numpy")
    assert "policy_scan_mesh->" in r2.fallback_reason
    assert "sort_by" in r2.fallback_reason


def test_glob_predicates_fall_back_with_the_reason_recorded():
    """A policy the kernel programs cannot express (a glob on the path)
    makes ``policy_scan_mesh`` fall back as the reference's engine does,
    and the report says why; the actions equal ``numpy``'s."""
    cat = _random_catalog(np.random.default_rng(32), 200)
    rec = BatchRecorder()
    policy = PolicyDefinition.from_config(
        name="p", action=rec, scope="path == '/p/d1/*'",
        rules=[("big", "size > 8M", {})], sort_by="atime", mutates=False)
    eng = _engine_with_store(cat, policy, groups=3)
    r = eng.run("p", evaluator="policy_scan_mesh")
    assert r.evaluator == "numpy"
    assert r.fallback_reason.startswith("policy_scan_mesh->policy_scan")
    assert "policy_scan->numpy" in r.fallback_reason
    mesh_calls = list(rec.calls)
    rec.calls.clear()
    eng.run("p", evaluator="numpy")
    assert mesh_calls == rec.calls and mesh_calls


def test_more_groups_than_shards_leaves_empty_groups():
    """Groups without a shard hold no rows and match nothing; the others
    still agree with the host mask."""
    cat = _random_catalog(np.random.default_rng(34), 300, n_shards=3)
    store = DeviceColumnStore(cat, groups=5, device="cpu")
    expr = parse_expr("size > 4M")
    fids, agg = store.scan(expr, NOW)
    assert [g.rows for g in store._groups][3:] == [0, 0]
    ref = cat.arrays()
    want = ref["fid"][expr.mask(ref, cat.strings, NOW)]
    assert sorted(fids.tolist()) == sorted(want.tolist())
    assert agg["count"] == len(want)


def test_stale_mesh_match_plan_raises():
    cat = _random_catalog(np.random.default_rng(33), 150)
    store = DeviceColumnStore(cat, device="cpu")
    match = store.match([parse_expr("size >= 0")], NOW)
    cat.update_fields_batch([1, 2, 3], size=77 << 20)
    store.refresh()                      # mirrors mutated since the match
    with pytest.raises(PolicyError, match="stale"):
        match.plan("size")
    # a fresh match plans fine again
    store.match([parse_expr("size >= 0")], NOW).plan("size")


def test_scan_catalog_rejects_mismatched_store():
    from repro_torch.kernels.policy_scan.ops import scan_catalog
    cat = _random_catalog(np.random.default_rng(35), 60)
    other = _random_catalog(np.random.default_rng(36), 60)
    store = DeviceColumnStore(other, device="cpu")
    with pytest.raises(PolicyError, match="different catalog"):
        scan_catalog(cat, parse_expr("size >= 0"), NOW, store=store)


def test_incremental_run_records_requested_evaluator_override():
    cat = _random_catalog(np.random.default_rng(37), 120)
    rec = BatchRecorder()
    policy = PolicyDefinition.from_config(
        name="p", action=rec, scope="type == file",
        rules=[("any", "size >= 0", {})], sort_by="atime", mutates=False)
    eng = _engine_with_store(cat, policy)
    eng.enable_incremental()
    eng.run("p")                                   # prime the cache
    eng.mark_dirty([1])
    r = eng.run("p", evaluator="policy_scan_mesh", matching="incremental")
    assert r.mode == "incremental" and r.evaluator == "numpy"
    assert "policy_scan_mesh->incremental" in r.fallback_reason


def test_detach_unregisters_hook_and_store_stays_correct():
    cat = _random_catalog(np.random.default_rng(41), 100)
    store = DeviceColumnStore(cat, device="cpu")
    store.refresh()
    assert store._on_delta in cat._hooks
    store.detach()
    assert store._on_delta not in cat._hooks
    cat.update_fields(1, size=99 << 20)       # no dirty intake anymore
    assert all(not g.dirty for g in store._groups)
    # matching still works: hook-less mutations force cold full uploads
    fids, _ = store.scan(parse_expr("size > 90M"), NOW)
    assert fids.tolist() == [1]
    store.detach()                             # idempotent


def test_refresh_repads_when_group_outgrows_capacity_mid_refresh():
    """A snapshot that exceeds the padded capacity (concurrent insert
    race) must re-pad and retry, not crash the stack staging."""
    from repro_torch.core.device_store import _RepadNeeded
    cat = _random_catalog(np.random.default_rng(43), 100)
    store = DeviceColumnStore(cat, device="cpu", tile=128)
    store.refresh()
    # simulate the race: capacity says _rp, but the snapshot will see more
    # rows than refresh()'s initial need-check observed
    store._rp = store.tile                 # force an undersized capacity
    for g in store._groups:
        g.uploaded = False                 # every group must re-upload
    cat.upsert_batch([Entry(fid=20_000 + i, name=f"r{i}", path=f"/p/r{i}",
                            type=FsType.FILE, size=5 << 20,
                            atime=NOW - 1.0) for i in range(2000)])
    stats = store.refresh()                # would raise before the retry fix
    assert stats["full"] == store.n_groups
    fids, _ = store.scan(parse_expr("size > 4M"), NOW)
    ref = cat.arrays()
    ref_fids = ref["fid"][parse_expr("size > 4M").mask(ref, cat.strings, NOW)]
    assert sorted(fids.tolist()) == sorted(ref_fids.tolist())
    # the retry path itself: a snapshot larger than Rp raises inside
    # _stage_upload and refresh re-pads
    with pytest.raises(_RepadNeeded):
        store._stage_upload(store._groups[0], store._groups[0].rows - 1)


# -- store modes ----------------------------------------------------------------

@pytest.mark.parametrize("call, item", [
    (lambda s: s.drain_demotions(), 7),
    (lambda s: (s.enable_permissions_plane(T.GrantTable()),
                s.drain_demotions()), 7),
], ids=["drain_demotions", "drain_demotions_with_permissions"])
def test_planes_not_ported_raise_naming_their_item(call, item):
    """Tiered residency (queue 1 item 7) still raises, with or without the
    permissions plane (item 6, ported: ``test_torch_tenant_scoping.py``)."""
    cat = _random_catalog(np.random.default_rng(45), 40)
    store = DeviceColumnStore(cat, device="cpu")
    with pytest.raises(NotImplementedError, match=f"queue 1 item {item}"):
        call(store)


@pytest.mark.parametrize("kw", [dict(hbm_budget_rows=1024),
                                dict(window_rows=128),
                                dict(demote_async=True)],
                         ids=["hbm_budget_rows", "window_rows",
                              "demote_async"])
def test_tiering_arguments_raise_naming_item_7(kw):
    cat = _random_catalog(np.random.default_rng(46), 40)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        DeviceColumnStore(cat, device="cpu", **kw)


def test_tiering_counters_report_every_group_resident():
    cat = _random_catalog(np.random.default_rng(47), 80)
    rec = BatchRecorder()
    policy = _random_policy(np.random.default_rng(48), rec)
    eng = _engine_with_store(cat, policy, groups=3)
    r = eng.run("p", evaluator="policy_scan_mesh")
    assert r.tiering["resident_groups"] == 3
    assert r.tiering["demoted_groups"] == 0
    assert set(r.tiering) == {
        "demotions", "promotions", "segments_streamed", "windows_streamed",
        "window_stalls", "segment_repacks", "demote_races", "device_pads",
        "resident_groups", "demoted_groups"}


def test_store_use_kernel_on_cpu_raises():
    cat = _random_catalog(np.random.default_rng(49), 40)
    store = DeviceColumnStore(cat, device="cpu")
    before = (tk.policy_scan_store_launches,
              tk.policy_scan_store_lean_launches)
    with pytest.raises(ValueError):
        store.scan(parse_expr("size > 0"), NOW, use_kernel=True)
    with pytest.raises(ValueError):
        tk.policy_scan_store_cuda(
            torch.zeros((1, N_COLS, 8)), *(torch.zeros((1, 1), dtype=dt)
                                           for dt in (torch.int32,
                                                      torch.int32,
                                                      torch.float32)),
            size_col=SIZE, blocks_col=BLOCKS, valid_col=VALID,
            with_agg=False)
    assert (tk.policy_scan_store_launches,
            tk.policy_scan_store_lean_launches) == before


# -- 2. differential against the JAX package ----------------------------------

def _jax():
    pytest.importorskip("jax")
    import repro.core as J
    from repro.launch.mesh import make_shards_mesh
    return J, make_shards_mesh


def _both(seed, n, tile=0):
    """(pkg, catalog, store) for the JAX package (1-device mesh) and the
    port (groups set later), one catalog of the same entries in each."""
    J, make_mesh = _jax()
    rows = _entry_rows(np.random.default_rng(seed), n)
    cats = {}
    for name, pkg in (("jax", J), ("port", T)):
        cat = pkg.Catalog(n_shards=8)
        cat.upsert_batch(_entries(pkg, rows))
        cats[name] = cat
    return J, make_mesh, cats


def _churn(cats, pkgs, rng, round_i, grow_rows):
    """The same churn on both catalogs: 0 in-place updates, 1 inserts and
    removes, 2 ``grow_rows`` inserts (growth past the store's Rp)."""
    live = sorted(e.fid for e in cats["port"].entries())
    if round_i == 0:
        upd = rng.choice(live, size=len(live) // 10, replace=False).tolist()
        kw = dict(size=int(rng.integers(0, 2 ** 15)) * 1024,
                  atime=NOW - float(rng.integers(0, 10_000)))
        for cat in cats.values():
            cat.update_fields_batch(upd, **kw)
    elif round_i == 1:
        gone = rng.choice(live, size=25, replace=False).tolist()
        rows = _entry_rows(rng, 40, fid0=max(live) + 1)
        for name, cat in cats.items():
            for f in gone:
                cat.remove(int(f))
            cat.upsert_batch(_entries(pkgs[name], rows))
    else:
        rows = _entry_rows(rng, grow_rows, fid0=max(live) + 1)
        for name, cat in cats.items():
            cat.upsert_batch(_entries(pkgs[name], rows))


@pytest.mark.parametrize("groups, budget", [
    (1, None), (1, "max_actions"), (8, None), (8, "target")])
def test_engine_runs_match_jax(groups, budget):
    """numpy, policy_scan and policy_scan_mesh in both packages action the
    same (fid, rule tag) sequence, cold and after three churn rounds
    (in-place, inserts and removes, growth past Rp with tile=128); at
    groups=1 the stores' refresh counters agree too."""
    J, make_mesh, cats = _both(3, 500)
    recs = {name: BatchRecorder(tags=True) for name in cats}
    cfg_rng = 77
    extra = dict(max_actions_per_run=60) if budget == "max_actions" else {}
    target = 3 << 30 if budget == "target" else 0
    engines = {}
    for name, pkg in (("jax", J), ("port", T)):
        policy = _random_policy(np.random.default_rng(cfg_rng), recs[name],
                                pkg=pkg, **extra)
        if name == "jax":
            eng = J.PolicyEngine(cats[name], clock=lambda: NOW)
            store = J.DeviceColumnStore(cats[name], make_mesh(), tile=128)
        else:
            eng = T.PolicyEngine(cats[name], clock=lambda: NOW, device="cpu")
            store = T.DeviceColumnStore(cats[name], groups=groups,
                                        device="cpu", tile=128)
        eng.register(policy)
        eng.attach_device_store(store)
        engines[name] = eng
    rng = np.random.default_rng(5)
    for round_i in range(4):
        if round_i:
            _churn(cats, dict(jax=J, port=T), rng, round_i - 1,
                   engines["port"].device_store._rp * groups)
        seqs = {}
        for name, eng in engines.items():
            for evaluator in ("numpy", "policy_scan", "policy_scan_mesh"):
                recs[name].calls.clear()
                r = eng.run("p", evaluator=evaluator, target_volume=target)
                assert r.evaluator == evaluator and not r.fallback_reason, (
                    name, evaluator, r.fallback_reason)
                seqs[name, evaluator] = (r.matched, r.succeeded, r.volume,
                                         list(recs[name].calls))
        want = seqs["jax", "numpy"]
        assert want[3], "the policy actioned nothing"
        for key, got in seqs.items():
            assert got == want, (round_i, key)
        if groups == 1:
            js, ts = (engines[n].device_store for n in ("jax", "port"))
            for c in ("full_uploads", "delta_refreshes", "rows_scattered",
                      "device_pads"):
                assert getattr(ts, c) == getattr(js, c), (round_i, c)
            assert ts._rp == js._rp
    assert engines["port"].device_store._rp > 128


@pytest.mark.parametrize("with_agg", [True, False])
def test_mesh_match_plan_and_agg_match_jax(with_agg):
    """``MeshMatch.plan`` arrays equal the reference store's byte for byte
    (dtype included) for every sort key, and the aggregates are equal, on
    a groups=1 store, before and after churn."""
    J, make_mesh, cats = _both(11, 400)
    stores = {"jax": J.DeviceColumnStore(cats["jax"], make_mesh()),
              "port": T.DeviceColumnStore(cats["port"], device="cpu")}
    cfg = _policy_config(np.random.default_rng(12))
    rng = np.random.default_rng(13)
    for round_i in range(3):
        if round_i:
            _churn(cats, dict(jax=J, port=T), rng, round_i - 1, 64)
        out = {}
        for name, pkg in (("jax", J), ("port", T)):
            policy = pkg.PolicyDefinition.from_config(action=None, **cfg)
            exprs = pkg.PolicyEngine._programs(policy, None)
            m = stores[name].match(exprs, NOW, with_agg=with_agg)
            out[name] = (m, {k: m.plan(k) for k in ("fid", "size", "atime",
                                                    "owner", "mtime")})
        (jm, jplan), (tm, tplan) = out["jax"], out["port"]
        assert tm.matched == jm.matched and tm.reval == jm.reval
        for key in jplan:
            for a, b in zip(jplan[key], tplan[key]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
        assert tm.agg == jm.agg
        if with_agg:
            assert tm.agg["count"] == tm.matched


def _op_inputs(seed, d, rp):
    """(D, C+1, Rp) f32-exact columns (sizes below 2^20 so every sum is
    exact in f32), about 1/8 of rows invalid, and programs."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 5, (d, N_COLS, rp)).astype(np.float32)
    cols[:, SIZE] = rng.integers(0, 1024, (d, rp)) * 1024
    cols[:, BLOCKS] = rng.integers(0, 1024, (d, rp))
    cols[:, KERNEL_COLUMNS.index("atime")] = NOW - rng.integers(0, 10_000,
                                                                (d, rp))
    cols[:, VALID] = rng.random((d, rp)) < 0.875
    st = StringTable()
    for s in ("user0", "user1", "user2"):
        st.intern(s)
    exprs = [parse_expr(e) for e in CONDITIONS[: 1 + seed % 4]]
    exprs = [all_of([parse_expr("type == file"), any_of(exprs)])] + exprs
    ops, colidx, operands = compile_programs(exprs, st, NOW)
    return cols, ops, colidx, operands


@pytest.mark.parametrize("with_agg", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mesh_op_matches_reference_op(seed, with_agg):
    J, make_mesh = _jax()
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ops as jops
    cols, ops, colidx, operands = _op_inputs(seed, 3, 256)
    ops_t, colidx_t = tops._program_tuples(ops, colidx)
    kw = dict(ops_t=ops_t, colidx_t=colidx_t, size_col=SIZE,
              blocks_col=BLOCKS, valid_col=VALID, with_agg=with_agg)
    mask, rule, agg = tops.mesh_policy_scan_batch(
        torch.from_numpy(cols), torch.from_numpy(operands), **kw)
    mesh = make_mesh()
    jmask, jrule, jaggs = [], [], []
    for d in range(cols.shape[0]):
        m, r, a = jops.mesh_policy_scan_batch(
            jnp.asarray(cols[d: d + 1]), jnp.asarray(operands), mesh=mesh,
            use_kernel=False, **kw)
        jmask.append(np.asarray(m)[0])
        jrule.append(np.asarray(r)[0])
        jaggs.append(np.asarray(a))
    jagg = jaggs[0].copy()
    for a in jaggs[1:]:                     # the reference's psum / pmax
        jagg[:, :-1] += a[:, :-1]
        jagg[:, -1] = np.maximum(jagg[:, -1], a[:, -1])
    assert mask.dtype == (torch.float32 if with_agg else torch.bool)
    np.testing.assert_array_equal(mask.numpy(), np.stack(jmask))
    np.testing.assert_array_equal(rule.numpy(), np.stack(jrule))
    np.testing.assert_array_equal(agg.numpy(), jagg)    # tolerance 0
    # the kernel's plain version gives the same
    pm, pr, pa = tref.policy_scan_store_ref(
        torch.from_numpy(cols), *(torch.from_numpy(a)
                                  for a in (ops, colidx, operands)),
        size_col=SIZE, blocks_col=BLOCKS, valid_col=VALID, with_agg=with_agg)
    assert torch.equal(pm, mask) and torch.equal(pr, rule)
    assert torch.equal(pa, agg)


def test_unrolled_evaluator_matches_jax():
    """``policy_scan_batch_unrolled`` and ``policy_scan_multi`` (plain
    ops with no kernel in either package) against the reference's."""
    _jax()
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ops as jops
    cols, ops, colidx, operands = _op_inputs(5, 1, 300)
    cols = cols[0]
    ops_t, colidx_t = tops._program_tuples(ops, colidx)
    assert ops_t == jops._program_tuples(ops, colidx)[0]
    kw = dict(ops_t=ops_t, colidx_t=colidx_t, size_col=SIZE,
              blocks_col=BLOCKS, valid_col=VALID)
    got = tops.policy_scan_batch_unrolled(torch.from_numpy(cols),
                                          torch.from_numpy(operands), **kw)
    want = jops.policy_scan_batch_unrolled(jnp.asarray(cols),
                                           jnp.asarray(operands), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tops.policy_scan_multi(*(torch.from_numpy(a) for a in (
        cols, ops, colidx, operands)), size_col=SIZE, blocks_col=BLOCKS)
    want = jops.policy_scan_multi(*(jnp.asarray(a) for a in (
        cols, ops, colidx, operands)), size_col=SIZE, blocks_col=BLOCKS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- 4. the kernel's tile walk and lean stage plan on the host ------------------

HOST_WALK = r"""
#include <cstdio>
#include <vector>
#include "policy_scan.cuh"
using namespace policy_scan;
// stdin: rows groups, then n_cols count size blocks valid agg, ops, colidx
// stdout: TILE, each tile's group and first row, then the staged columns
int main() {
  long long rows, groups;
  if (scanf("%lld %lld", &rows, &groups) != 2) return 1;
  const long long per = tiles_per_group(rows);
  printf("%d\n", TILE);
  for (long long t = 0; t < groups * per; ++t) {
    const long long g = tile_group(t, per);
    printf("%lld %lld\n", g, tile_row0(t, g, per));
  }
  int n_cols, count, size_col, blocks_col, valid_col, agg;
  if (scanf("%d %d %d %d %d %d", &n_cols, &count, &size_col, &blocks_col,
            &valid_col, &agg) != 6) return 1;
  std::vector<int> ops(count), col(count), stage(MAX_COLS);
  for (auto& v : ops) scanf("%d", &v);
  for (auto& v : col) scanf("%d", &v);
  const int n = stage_plan(ops.data(), col.data(), count, n_cols, size_col,
                           blocks_col, valid_col, stage.data(), agg != 0);
  printf("stage");
  for (int s = 0; s < n; ++s) printf(" %d", stage[s]);
  printf("\n");
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/policy_scan.cuh")
    d = tmp_path_factory.mktemp("policy_scan_walk")
    (d / "main.cpp").write_text(HOST_WALK)
    exe = d / "walk"
    subprocess.run([cxx, "-O1", "-std=c++17", f"-I{CSRC}", "-o", str(exe),
                    str(d / "main.cpp")], check=True, capture_output=True,
                   timeout=120)

    def run(rows, groups, ops, colidx, agg):
        ops = np.asarray(ops, np.int32).ravel()
        colidx = np.asarray(colidx, np.int32).ravel()
        text = " ".join(str(v) for v in [rows, groups, N_COLS, ops.size,
                                         SIZE, BLOCKS, VALID, int(agg),
                                         *ops.tolist(), *colidx.tolist()])
        out = subprocess.run([str(exe)], input=text, capture_output=True,
                             text=True, timeout=60, check=True).stdout
        lines = out.strip().split("\n")
        tiles = [tuple(map(int, ln.split())) for ln in lines[1:-1]]
        return int(lines[0]), tiles, [int(c) for c in lines[-1].split()[1:]]
    return run


@pytest.mark.parametrize("rows, groups", [(128, 1), (1664, 3), (1024, 8),
                                          (65664, 8), (3, 2)])
def test_store_tile_walk_covers_each_group_once(host_walk, rows, groups):
    """Tile t of the store form lies in one group: the tiles of a group
    start at 0, TILE, 2 TILE, ... below its rows, in order, and every
    group has ceil(rows / TILE) of them."""
    tile, tiles, _ = host_walk(rows, groups, [-1], [0], True)
    per = -(-rows // tile)
    assert len(tiles) == groups * per
    for g in range(groups):
        mine = [r0 for gg, r0 in tiles if gg == g]
        assert mine == [k * tile for k in range(per)]
        assert all(r0 < rows for r0 in mine)
    assert [gg for gg, _ in tiles] == sorted(gg for gg, _ in tiles)


@pytest.mark.parametrize("seed", range(4))
def test_lean_stage_plan_stages_only_what_is_read(host_walk, seed):
    """The lean form stages validity, then the read columns in increasing
    order; size and blocks only when a compare reads them. With
    aggregates: size, blocks, validity first, as the 2-D form."""
    st = StringTable()
    for s in ("user0", "user1", "user2"):
        st.intern(s)
    rng = np.random.default_rng(seed)
    conds = rng.choice(len(CONDITIONS), size=1 + seed, replace=False)
    exprs = [parse_expr(CONDITIONS[int(c)]) for c in conds]
    ops, colidx, _ = compile_programs(exprs, st, NOW)
    live = (ops >= 0) & (ops < 6)
    read = sorted(set(colidx[live].tolist()))
    _, _, lean = host_walk(128, 1, ops, colidx, False)
    assert lean == [VALID] + [c for c in read if c != VALID]
    assert (SIZE in lean) == (SIZE in read)
    assert (BLOCKS in lean) == (BLOCKS in read)
    _, _, full = host_walk(128, 1, ops, colidx, True)
    assert full[:3] == [SIZE, BLOCKS, VALID]
    assert set(full) == set(read) | {SIZE, BLOCKS, VALID}


# -- 5. on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the policy_scan kernels run only "
                    "there")
    return torch.device("cuda")


BATCH = ["(size > 1GB or owner == 'u1') and type == file", "size > 1GB",
         "owner == 'u1'", "not (type == file and size <= 32M)"]
MORE = ["last_access > 90d", "nlink == 2 or ost_idx == 3",
        "mode >= 256 and not (dirty == 1)", "group == 1 and pool != 2",
        "size <= 4M"]
WIDE = [
    "(size > 1GB or blocks < 4096) and (nlink == 2 or ost_idx == 3 or "
    "archive_id == 1) or (mode >= 256 and dirty == 1) or last_access > 90d "
    "or last_mod > 30d or creation > 1d or type == file or "
    "hsm_state == archived or owner == 'u1' or group == 'u2' or "
    "pool == 'u0' or status == 'u1'",
    "size <= 32M and blocks >= 8 and nlink != 1 and ost_idx < 5 and "
    "archive_id != 2 and mode < 448 and dirty == 0 and "
    "not (last_access > 10d and last_mod > 20d and creation > 30d) and "
    "type == file and hsm_state != released and owner != 'u0' and "
    "(group == 'u1' or pool == 'u2' or status != 'u0')"]


def card_programs(exprs, device):
    st = StringTable()
    for s in ("u0", "u1", "u2"):
        st.intern(s)
    host = compile_programs([parse_expr(e) for e in exprs], st, now=1e6)
    return [torch.from_numpy(a).to(device) for a in host]


def card_store_cols(d, rp, seed, device):
    """(d, 17, rp) f32 on the card, integer-valued, about 1/20 invalid."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 8, (d, N_COLS, rp)).astype(np.float32)
    cols[:, SIZE] = rng.integers(0, 1 << 32, (d, rp))
    cols[:, BLOCKS] = rng.integers(0, 1 << 24, (d, rp))
    cols[:, KERNEL_COLUMNS.index("atime")] = 1e6 - rng.integers(0, 2e7,
                                                                (d, rp))
    cols[:, VALID] = rng.random((d, rp)) < 0.95
    return torch.from_numpy(cols).to(device)


KW = dict(size_col=SIZE, blocks_col=BLOCKS, valid_col=VALID)


@pytest.mark.cuda
@pytest.mark.parametrize("with_agg", [True, False], ids=["agg", "lean"])
@pytest.mark.parametrize("r", [1, 4, 9])
@pytest.mark.parametrize("rp", [128 * 13, (1 << 16) + 128])
@pytest.mark.parametrize("d", [1, 3, 8])
def test_cuda_store_matches_plain_version(cuda_device, d, rp, r, with_agg):
    cols = card_store_cols(d, rp, d * 7 + r, cuda_device)
    prog = card_programs((BATCH + MORE)[:r], cuda_device)
    mask, rule, agg = tk.policy_scan_store_cuda(cols, *prog, with_agg=with_agg,
                                                **KW)
    pm, pr, pa = tref.policy_scan_store_ref(cols, *prog, with_agg=with_agg,
                                            **KW)
    assert mask.dtype == pm.dtype and torch.equal(mask, pm)
    assert torch.equal(rule, pr)
    if with_agg:
        torch.testing.assert_close(agg, pa, **TOL)
    else:
        assert not agg.any()
    again = tk.policy_scan_store_cuda(cols, *prog, with_agg=with_agg, **KW)
    assert all(torch.equal(a, b) for a, b in zip(again, (mask, rule, agg)))


@pytest.mark.cuda
@pytest.mark.parametrize("with_agg", [True, False], ids=["agg", "lean"])
def test_cuda_store_wide_programs_stage_part_tiles(cuda_device, with_agg):
    cols = card_store_cols(3, 128 * 21, 5, cuda_device)
    prog = card_programs(BATCH + WIDE, cuda_device)
    shape = tk.launch_shape(cols, prog[0], prog[1], with_agg=with_agg, **KW)
    ring = shape["passes"][0]
    assert len(ring["staged_cols"]) == N_COLS
    assert ring["stage_rows"] < shape["tile_rows"]
    mask, rule, agg = tk.policy_scan_store_cuda(cols, *prog, with_agg=with_agg,
                                                **KW)
    pm, pr, pa = tref.policy_scan_store_ref(cols, *prog, with_agg=with_agg,
                                            **KW)
    assert torch.equal(mask, pm) and torch.equal(rule, pr)
    if with_agg:
        torch.testing.assert_close(agg, pa, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 4, 9])
def test_cuda_store_one_group_equals_the_2d_kernel(cuda_device, r):
    cols = card_store_cols(1, (1 << 16) + 128, 31 + r, cuda_device)
    prog = card_programs((BATCH + MORE)[:r], cuda_device)
    masks, rule2, agg2 = tk.policy_scan_batch_cuda(cols[0], *prog, **KW)
    for with_agg in (True, False):
        mask, rule, agg = tk.policy_scan_store_cuda(cols, *prog,
                                                    with_agg=with_agg, **KW)
        want = masks[0] if with_agg else masks[0] > 0.5
        assert torch.equal(mask[0], want) and torch.equal(rule[0], rule2)
        if with_agg:
            assert torch.equal(agg[:, [0] + list(range(3, 14))],
                               agg2[:, [0] + list(range(3, 14))])
            torch.testing.assert_close(agg, agg2, **TOL)


@pytest.mark.cuda
def test_cuda_store_engine_matches_numpy_in_one_lean_launch(cuda_device):
    cat = _random_catalog(np.random.default_rng(61), 5000, n_shards=4)
    out = {}
    for evaluator in ("numpy", "policy_scan_mesh"):
        rec = BatchRecorder(tags=True)
        policy = _random_policy(np.random.default_rng(62), rec)
        eng = PolicyEngine(cat, clock=lambda: NOW, device=cuda_device)
        eng.register(policy)
        store = DeviceColumnStore(cat, groups=4, device=cuda_device)
        eng.attach_device_store(store)
        tk.reset_counters()
        r = eng.run("p", evaluator=evaluator)
        assert r.evaluator == evaluator and not r.fallback_reason
        out[evaluator] = (list(rec.calls), tk.policy_scan_store_launches,
                          tk.policy_scan_store_lean_launches,
                          tk.policy_scan_batch_launches)
        store.detach()
    assert out["policy_scan_mesh"][0] == out["numpy"][0]
    assert out["policy_scan_mesh"][1:] == (0, 1, 0)
    assert out["numpy"][1:] == (0, 0, 0)


@pytest.mark.cuda
def test_cuda_store_match_raises_on_a_planted_bad_argument(cuda_device,
                                                           monkeypatch):
    """With a validity column the kernel refuses, the store's match on the
    card raises: it never runs the plain version instead."""
    from repro_torch.core import device_store
    cat = _random_catalog(np.random.default_rng(63), 300)
    store = DeviceColumnStore(cat, groups=2, device=cuda_device)
    store.refresh()
    monkeypatch.setattr(device_store, "_VALID_COL", N_COLS + 5)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(tops, "_unrolled_masks", no_plain)
    monkeypatch.setattr(tref, "policy_scan_batch_ref", no_plain)
    before = (tk.policy_scan_store_launches,
              tk.policy_scan_store_lean_launches)
    with pytest.raises(ValueError, match="valid_col"):
        store.match([parse_expr("size > 1M")], NOW, with_agg=False)
    assert (tk.policy_scan_store_launches,
            tk.policy_scan_store_lean_launches) == before
    with pytest.raises(ValueError):
        store.match([parse_expr("size > 1M")], NOW, use_kernel=False)
