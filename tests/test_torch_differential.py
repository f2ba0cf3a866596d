"""``tests/core/test_differential.py`` on the port, held against ``repro``.

On randomized catalogs and policies every execution and matching path of
one engine (scalar, columnar, batched under the numpy and ``policy_scan``
evaluators, the incremental planner, the ColumnBatch batch action) must
action the identical fid sequence; each case runs on both packages from
the same seeds and the port's sequences, counts and volumes must equal
the reference's. The matcher cases hold ``match_programs`` (single launch
and one launch a program) to the numpy masks and to the reference's
matcher: its jitted oracle, and in the ``slow`` case its Pallas kernels in
interpret mode. The ``cuda`` case runs the same seeds through the port's
hand-written ``policy_scan_batch`` and ``policy_scan`` kernels against
their plain version; it skips without a card.

All values are f32-exact (sizes are multiples of 1 KiB below 2^25, times
integers below 2^24), so every path agrees bit for bit, sums included.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_pair import both, port, ref

NOW = float(2 ** 20)          # f32-exact "now"

SCOPES = [
    "true",
    "type == file",
    "type == file and size > 0",
    "not type == dir",
]

CONDITIONS = [
    "size > 16M",
    "size <= 4M",
    "size >= 1M and size < 64M",
    "owner == 'user1'",
    "not owner == 'user2'",
    "group == 'grp0'",
    "last_access > 1000s",
    "last_access <= 5000s",
    "last_mod > 2000s",
    "hsm_state == none",
    "hsm_state == archived",
    "pool == 'ssd'",
    "size > 8M or owner == 'user0'",
    "size > 2M and last_access > 3000s",
    "not (size <= 1M or last_access <= 500s)",
]


class Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.calls = []

    def __call__(self, e, params):
        with self.lock:
            self.calls.append(e.fid)
        return True


class BatchRecorder(Recorder):
    """Recorder exposing the ColumnBatch batch-action interface."""

    def __init__(self):
        super().__init__()

        def action_batch(batch, params):
            with self.lock:
                self.calls.extend(batch.fids.tolist())
            return [True] * len(batch)

        self.action_batch = action_batch


def _random_catalog(P, rng, n):
    cat = P.Catalog(n_shards=4)
    entries = []
    for i in range(n):
        fid = i + 1
        entries.append(P.Entry(
            fid=fid, name=f"f{fid}", path=f"/p/d{fid % 5}/f{fid}",
            type=P.FsType.FILE if rng.random() < 0.9 else P.FsType.DIR,
            size=int(rng.integers(0, 2 ** 15)) * 1024,       # f32-exact
            blocks=int(rng.integers(0, 2 ** 10)),
            owner=f"user{int(rng.integers(0, 4))}",
            group=f"grp{int(rng.integers(0, 3))}",
            pool=["", "ssd", "hdd"][int(rng.integers(0, 3))],
            hsm_state=P.HsmState(int(rng.integers(0, 5))),
            atime=NOW - float(rng.integers(0, 10_000)),      # f32-exact
            mtime=NOW - float(rng.integers(0, 10_000))))
    cat.upsert_batch(entries)
    return cat


def _random_policy(P, rng, action):
    n_rules = int(rng.integers(1, 4))
    conds = rng.choice(len(CONDITIONS), size=n_rules, replace=False)
    return P.PolicyDefinition.from_config(
        name="p", action=action,
        scope=SCOPES[int(rng.integers(0, len(SCOPES)))],
        rules=[(f"r{i}", CONDITIONS[int(c)], {"tag": f"r{i}"})
               for i, c in enumerate(conds)],
        sort_by=["atime", "size", "mtime"][int(rng.integers(0, 3))],
        sort_desc=bool(rng.integers(0, 2)),
        n_threads=1, batch_size=64, mutates=False)


def _churn(P, rng, cat, n):
    """Randomly mutate/remove/insert entries; returns the touched fids."""
    touched = set()
    live = [int(f) for s in cat.shards for f in s.fids()]
    for fid in rng.choice(live, size=max(1, len(live) // 10), replace=False):
        fid = int(fid)
        kind = rng.random()
        if kind < 0.2:
            cat.remove(fid)
        elif kind < 0.6:
            cat.update_fields(fid, size=int(rng.integers(0, 2 ** 15)) * 1024,
                              atime=NOW - float(rng.integers(0, 10_000)))
        else:
            cat.update_fields(fid, owner=f"user{int(rng.integers(0, 4))}",
                              hsm_state=P.HsmState(int(rng.integers(0, 5))))
        touched.add(fid)
    for _ in range(n // 20):
        fid = n + int(rng.integers(1, 10_000))
        cat.upsert(P.Entry(fid=fid, name=f"n{fid}", path=f"/p/new/n{fid}",
                           type=P.FsType.FILE,
                           size=int(rng.integers(0, 2 ** 15)) * 1024,
                           owner=f"user{int(rng.integers(0, 4))}",
                           atime=NOW - float(rng.integers(0, 10_000))))
        touched.add(fid)
    return sorted(touched)


def _run_path(P, cat, policy_factory, clock_t, **run_kw):
    rec = Recorder()
    eng = P.PolicyEngine(cat, clock=lambda: clock_t, **P.dev)
    eng.register(policy_factory(rec))
    r = eng.run("p", **run_kw)
    return r, rec.calls


def _paths_agree(P, seed, n=600, rounds=2):
    """Every path of one package actions the numpy path's sequence; the
    per-round (matched, succeeded, volume, fids) are returned for the
    cross-package comparison."""
    rng = np.random.default_rng(seed)
    cat = _random_catalog(P, rng, n)
    proto = _random_policy(P, np.random.default_rng(seed + 1), None)

    def factory(action):
        return dataclasses.replace(proto, action=action)

    clock = [NOW]
    inc_rec = Recorder()
    inc_eng = P.PolicyEngine(cat, clock=lambda: clock[0], **P.dev)
    inc_eng.register(factory(inc_rec))
    inc_eng.enable_incremental()
    inc_eng.run("p")              # cold full run primes the cache

    out = []
    for round_i in range(rounds):
        touched = _churn(P, rng, cat, n)
        inc_eng.mark_dirty(touched)
        clock[0] += float(rng.integers(0, 2_000))      # flips fire too
        t = clock[0]

        results = {}
        inc_rec.calls.clear()
        r = inc_eng.run("p", matching="incremental")
        results["incremental"] = (r.matched, r.succeeded, r.volume,
                                  list(inc_rec.calls))
        r, calls = _run_path(P, cat, factory, t, execution="scalar")
        results["scalar"] = (r.matched, r.succeeded, r.volume, calls)
        r, calls = _run_path(P, cat, factory, t, execution="batched",
                             evaluator="numpy")
        results["numpy"] = (r.matched, r.succeeded, r.volume, calls)
        r, calls = _run_path(P, cat, factory, t, execution="columnar",
                             evaluator="numpy")
        results["columnar"] = (r.matched, r.succeeded, r.volume, calls)
        r, calls = _run_path(P, cat, factory, t, execution="batched",
                             evaluator="policy_scan")
        assert r.evaluator == "policy_scan"
        results["policy_scan"] = (r.matched, r.succeeded, r.volume, calls)

        want = results["numpy"]
        for name, got in results.items():
            assert got == want, (
                f"{P.name} seed={seed} round={round_i} path={name} "
                f"diverged: {got[:3]} vs {want[:3]}; "
                f"sym_diff={set(got[3]) ^ set(want[3])}")

        batch_results = {}
        for execution in ("batched", "columnar"):
            rec = BatchRecorder()
            eng = P.PolicyEngine(cat, clock=lambda: t, **P.dev)
            eng.register(factory(rec))
            r = eng.run("p", execution=execution)
            batch_results[execution] = (r.matched, r.succeeded, r.volume,
                                        list(rec.calls))
        assert batch_results["batched"] == batch_results["columnar"], (
            f"{P.name} seed={seed} round={round_i} ColumnBatch path "
            "diverged")
        assert sorted(batch_results["columnar"][3]) == sorted(want[3])
        assert batch_results["columnar"][:3] == want[:3]
        out.append((want, batch_results["columnar"]))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_all_paths_action_identical_sets(seed):
    got = both(_paths_agree, seed)
    assert any(want[1] for want, _ in got)        # something was actioned


@pytest.mark.slow
@pytest.mark.parametrize("seed", [2, 3, 4])   # 3 of the reference's 10
def test_all_paths_action_identical_sets_deep(seed):
    both(_paths_agree, seed, n=1500, rounds=3)


def _matcher_inputs(P, seed, n):
    rng = np.random.default_rng(seed)
    cat = _random_catalog(P, rng, n)
    policy = _random_policy(P, np.random.default_rng(seed + 1), None)
    rule_exprs = [r.condition for r in policy.rules]
    full = P.policy.all_of([policy.scope, P.policy.any_of(rule_exprs)])
    return cat, [full] + rule_exprs


def _plain(match):
    """A ``match_programs`` result as lists, for ``==`` across packages."""
    masks, agg, rule = match
    return [m.tolist() for m in masks], agg, np.asarray(rule).tolist()


def _port_matchers(seed, n):
    """The port's matcher on the CPU, single launch and one launch a
    program, held to each other and to the numpy masks; returns the
    single-launch result as lists."""
    from repro_torch.kernels.policy_scan.ops import match_programs
    P = port()
    cat, exprs = _matcher_inputs(P, seed, n)
    arrays = cat.arrays()
    single = match_programs(arrays, exprs, cat.strings, NOW,
                            single_launch=True, device="cpu")
    per_rule = match_programs(arrays, exprs, cat.strings, NOW,
                              single_launch=False, device="cpu")
    assert _plain(single) == _plain(per_rule)      # attribution included
    np_masks = [e.mask(arrays, cat.strings, NOW) for e in exprs]
    for m_s, m_n in zip(single[0], np_masks):
        np.testing.assert_array_equal(m_s, m_n)
    stacked = np.stack(np_masks[1:])
    att = np.argmax(stacked, axis=0).astype(np.int32)
    att[~stacked.any(axis=0)] = -1
    np.testing.assert_array_equal(single[2], att)
    assert single[1]["count"] == int(np_masks[0].sum())
    return _plain(single)


def _ref_matchers(seed, n, use_kernel):
    from repro.kernels.policy_scan.ops import match_programs
    cat, exprs = _matcher_inputs(ref(), seed, n)
    out = [_plain(match_programs(cat.arrays(), exprs, cat.strings, NOW,
                                 use_kernel=use_kernel, single_launch=s))
           for s in (True, False)]
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_launch_matcher_agrees(seed):
    assert _port_matchers(seed, 400) == _ref_matchers(seed, 400, False)


# interpret mode compiles each program batch's shapes anew (~7 s a seed on
# one core), so this file runs 3 of the reference's 6 seeds (3-8) to stay
# well within a minute
INTERPRET_SEEDS = [3, 4, 5]


@pytest.mark.slow
@pytest.mark.parametrize("seed", INTERPRET_SEEDS)
def test_single_launch_matcher_agrees_kernel_interpret(seed):
    """The port's plain matcher against the reference's Pallas kernels
    (interpret mode off-TPU): the single-launch batch kernel and per-rule
    launches, bit for bit, sums included."""
    assert _port_matchers(seed, 700) == _ref_matchers(seed, 700, True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the policy_scan kernels run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", INTERPRET_SEEDS)
def test_single_launch_matcher_agrees_on_card(cuda_device, seed):
    """The same seeds through the hand-written ``policy_scan_batch``
    (single launch) and ``policy_scan`` (one launch a program) kernels:
    masks, attribution and counts equal to the plain version's, each
    kernel launched as the path says."""
    from repro_torch.kernels.policy_scan import kernel as tk
    from repro_torch.kernels.policy_scan.ops import match_programs
    P = port()
    cat, exprs = _matcher_inputs(P, seed, 700)
    arrays = cat.arrays()
    want = _plain(match_programs(arrays, exprs, cat.strings, NOW,
                                 single_launch=True, device="cpu"))
    for single, counter, launches in (
            (True, "policy_scan_batch_launches", 1),
            (False, "policy_scan_launches", len(exprs))):
        before = getattr(tk, counter)
        got = _plain(match_programs(arrays, exprs, cat.strings, NOW,
                                    single_launch=single,
                                    device=cuda_device))
        assert getattr(tk, counter) == before + launches
        assert got[0] == want[0] and got[2] == want[2]
        for key in ("count", "any_match", "rule_count", "size_profile"):
            assert got[1].get(key) == want[1].get(key), key
        for key in ("volume", "spc_used", "rule_volume", "rule_spc_used"):
            np.testing.assert_allclose(got[1].get(key, 0),
                                       want[1].get(key, 0), rtol=1e-5,
                                       atol=1)


def _budgeted(P):
    rng = np.random.default_rng(99)
    cat = _random_catalog(P, rng, 800)

    def factory(action):
        return P.PolicyDefinition.from_config(
            name="p", action=action, scope="type == file",
            rules=[("any", "size >= 0", {})], sort_by="atime",
            n_threads=1, batch_size=32, max_actions_per_run=111,
            mutates=False)

    results = {}
    for execution in ("scalar", "batched", "columnar"):
        r, calls = _run_path(P, cat, factory, NOW, execution=execution)
        results[execution] = (r.succeeded, calls)
    inc_rec = Recorder()
    eng = P.PolicyEngine(cat, clock=lambda: NOW, **P.dev)
    eng.register(factory(inc_rec))
    eng.enable_incremental()
    eng.run("p")
    inc_rec.calls.clear()
    eng.mark_dirty([1, 2, 3])
    r = eng.run("p", matching="incremental")
    results["incremental"] = (r.succeeded, list(inc_rec.calls))
    assert results["scalar"] == results["batched"] == results["columnar"] \
        == results["incremental"]
    return results["scalar"]


@pytest.mark.slow
def test_budgeted_runs_agree_across_paths():
    """Volume/count budgets: deterministic prefix on every path."""
    succeeded, calls = both(_budgeted)
    assert succeeded == len(calls) == 111
