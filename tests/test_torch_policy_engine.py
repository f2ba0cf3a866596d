"""The cases of ``tests/core/test_policy_engine.py`` that
``tests/test_torch_engine.py`` does not run, on the port and held against
``repro``.

Budgets (target volume, max actions, re-planning after failures, the
watermark trigger), the batch action interface, ``needs_entries``, the
batched shim, the scalar path, dry runs, attribution against the scalar
oracle, the empty catalog, evaluator downgrades and an unknown evaluator.
Each case runs on both packages from the same catalog (the port's engine
on ``device="cpu"``) and returns what it observed, actioned fids and
report fields, which must be equal. All sizes and times are f32-exact, so
the ``policy_scan`` paths agree bit for bit with numpy.
"""
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_pair import both, port

NOW = 1_000_000.0          # f32-exact; keeps kernel/numpy paths bit-for-bit


def _catalog(P, n=2000, n_shards=4):
    cat = P.Catalog(n_shards=n_shards)
    cat.upsert_batch([P.Entry(fid=i + 1, name=f"f{i}",
                              path=f"/p/d{i % 7}/f{i}", type=P.FsType.FILE,
                              size=(i % 50 + 1) * 1000,     # f32-exact sizes
                              blocks=(i % 50 + 1), owner=f"user{i % 5}",
                              atime=NOW - float(i + 1))     # unique LRU order
                      for i in range(n)])
    return cat


class Recorder:
    """Thread-safe action that records (fid, params) and can fail."""

    def __init__(self, fail_fids=()):
        self.lock = threading.Lock()
        self.calls = []
        self.fail_fids = set(fail_fids)

    def __call__(self, e, params):
        with self.lock:
            self.calls.append((e.fid, params.get("tag")))
        return e.fid not in self.fail_fids

    def acted(self):
        return sorted(self.calls)


def _engine(P, cat, action, rules=None, **kw):
    eng = P.PolicyEngine(cat, clock=lambda: NOW, **P.dev)
    eng.register(P.PolicyDefinition.from_config(
        name="p", action=action, scope="type == file",
        rules=rules if rules is not None else [("all", "true", {})], **kw))
    return eng


def _report(r):
    return (r.matched, r.succeeded, r.failed, r.volume, r.matched_volume,
            r.rounds, r.evaluator, r.fallback_reason, r.execution)


# -- evaluator backends --------------------------------------------------------

def _empty_catalog(P):
    cat = P.Catalog(n_shards=2)
    rec = Recorder()
    eng = _engine(P, cat, rec, rules=[("big", "size > 1k", {"tag": "big"})])
    out = []
    for ev in ("numpy", "policy_scan"):
        r = eng.run("p", evaluator=ev)
        assert (r.matched, r.succeeded, r.failed) == (0, 0, 0)
        out.append(_report(r))
    assert rec.calls == []
    return out


def test_policy_scan_evaluator_on_empty_catalog():
    """A zero-row catalog matches nothing on every backend (no crash)."""
    both(_empty_catalog)


def test_unknown_evaluator_rejected():
    P = port()
    eng = _engine(P, _catalog(P, 50), Recorder())
    with pytest.raises(P.PolicyError):
        eng.run("p", evaluator="mysql")


# -- vectorized rule attribution -----------------------------------------------

def _attribution(P):
    cat = _catalog(P, 500)
    rec = Recorder()
    rules = [("r0", "size > 40k and last_access > 100s", {"tag": "r0"}),
             ("r1", "owner == 'user2'", {"tag": "r1"}),
             ("r2", "size <= 40k", {"tag": "r2"})]
    eng = _engine(P, cat, rec, rules=rules)
    r = eng.run("p")
    pol = eng.policies["p"]
    by_fid = dict(rec.calls)
    for e in cat.entries():
        expected = eng._rule_params(pol, e, NOW)
        if expected:
            assert by_fid[e.fid] == expected["tag"]
        else:
            assert e.fid not in by_fid         # matched no rule -> no action
    return _report(r), rec.acted()


def test_attribution_agrees_with_scalar_oracle():
    both(_attribution)


# -- budget semantics ----------------------------------------------------------

def _expected_lru_prefix(cat, target_volume):
    """Oracle: minimal LRU-ordered prefix whose volume meets the target."""
    cols = cat.arrays()
    order = np.argsort(cols["atime"], kind="stable")
    fids = cols["fid"][order]
    csum = np.cumsum(cols["size"][order])
    k = min(int(np.searchsorted(csum, target_volume)) + 1, len(fids))
    return fids[:k].tolist(), int(csum[k - 1])


def _target_volume(P, n_threads):
    target = 137_000
    cat = _catalog(P)
    exp_fids, exp_volume = _expected_lru_prefix(cat, target)
    rec = Recorder()
    eng = _engine(P, cat, rec, n_threads=n_threads, batch_size=100)
    r = eng.run("p", target_volume=target)
    acted = [f for f, _ in rec.calls]
    assert sorted(acted) == sorted(exp_fids)
    assert r.succeeded == len(exp_fids)
    assert r.volume == exp_volume
    assert r.volume >= target                      # target reached...
    max_size = max(e.size for e in cat.entries())
    assert r.volume < target + max_size            # ...but never overshot
    assert r.rounds == 1
    return _report(r), sorted(acted)


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_target_volume_never_overshoots_and_is_deterministic(n_threads):
    both(_target_volume, n_threads)


def _max_actions(P, n_threads):
    cat = _catalog(P)
    rec = Recorder()
    eng = _engine(P, cat, rec, n_threads=n_threads, batch_size=32,
                  max_actions_per_run=77)
    r = eng.run("p")
    assert r.succeeded == 77
    # deterministic: the 77 oldest (LRU) entries, not whichever thread won
    exp = sorted(_expected_lru_prefix(cat, 10**18)[0][:77])
    assert sorted(f for f, _ in rec.calls) == exp
    return _report(r), exp


@pytest.mark.parametrize("n_threads", [1, 4])
def test_max_actions_is_exact_and_deterministic(n_threads):
    both(_max_actions, n_threads)


def _replanning(P):
    cat = _catalog(P)
    rec = Recorder(fail_fids={fid for fid in range(1, 2001) if fid % 2 == 0})
    eng = _engine(P, cat, rec, n_threads=2, batch_size=100)
    target = 100_000
    r = eng.run("p", target_volume=target)
    assert r.volume >= target                 # failed sizes don't count...
    assert r.failed > 0
    assert r.rounds > 1                       # ...so the engine re-planned
    attempted = [f for f, _ in rec.calls]
    assert len(attempted) == len(set(attempted))   # each entry tried once
    return _report(r), sorted(attempted)


def test_failures_trigger_replanning_rounds_until_target_met():
    both(_replanning)


def _watermark(P):
    cat = _catalog(P)
    freed = [0]
    lock = threading.Lock()
    acted = []

    def act(e, params):
        with lock:
            freed[0] += e.size
            acted.append(e.fid)
        return True

    capacity = 1_000_000
    used0 = 900_000
    eng = _engine(P, cat, act, n_threads=4, batch_size=64)
    eng.add_watermark_trigger("p", P.UsageWatermarkTrigger(
        usage_fn=lambda: [("ost0", used0 - freed[0], capacity)],
        high_pct=85.0, low_pct=60.0,
        restrict_fn=lambda key: P.parse_expr("true")))
    reports = eng.check_triggers()
    assert len(reports) == 1
    target = used0 - int(capacity * 0.60)
    assert reports[0].trigger == "watermark:ost0"
    assert reports[0].volume >= target
    max_size = max(e.size for e in cat.entries())
    assert reports[0].volume < target + max_size
    assert used0 - freed[0] <= capacity * 0.60 + max_size
    assert not eng.check_triggers()           # back under the high watermark
    return _report(reports[0]), reports[0].trigger, sorted(acted)


def test_watermark_trigger_budget_stop():
    both(_watermark)


# -- execution paths -----------------------------------------------------------

def _batch_interface(P):
    """Columnar default: action_batch consumes ColumnBatch, no Entries."""
    cat = _catalog(P)
    batch_sizes, scalar_calls, payload_types, acted = [], [], [], []
    lock = threading.Lock()

    def action(e, params):
        with lock:
            scalar_calls.append(e.fid)
        return True

    def action_batch(batch, params):
        with lock:
            batch_sizes.append(len(batch))
            payload_types.append(type(batch))
            acted.extend(batch.fids.tolist())
        return (batch.fids % 10 != 0).tolist()

    action.action_batch = action_batch
    eng = _engine(P, cat, action, n_threads=2, batch_size=128)
    r = eng.run("p")
    assert not scalar_calls                    # batch interface preferred
    assert all(t is P.ColumnBatch for t in payload_types)
    assert sum(batch_sizes) == r.matched
    assert max(batch_sizes) <= 128
    assert r.failed == sum(1 for e in cat.entries() if e.fid % 10 == 0)
    assert r.succeeded == r.matched - r.failed
    return _report(r), sorted(acted)


def test_batch_action_interface_used_and_equivalent():
    both(_batch_interface)


def _needs_entries(P):
    """A plugin declaring needs_entries gets List[Entry], even columnar."""
    cat = _catalog(P)
    payloads = []
    lock = threading.Lock()

    def action(e, params):
        return True

    def action_batch(entries, params):
        with lock:
            payloads.append(entries)
        return [e.fid % 10 != 0 for e in entries]

    action.action_batch = action_batch
    action.needs_entries = True
    eng = _engine(P, cat, action, n_threads=1, batch_size=128)
    r = eng.run("p", execution="columnar")
    assert payloads and all(isinstance(p, list) for p in payloads)
    assert all(isinstance(e, P.Entry) for p in payloads for e in p)
    assert r.failed == sum(1 for e in cat.entries() if e.fid % 10 == 0)
    return _report(r), [[e.fid for e in p] for p in payloads]


def test_needs_entries_declaration_materializes():
    both(_needs_entries)


def _shim(P):
    """Legacy batched mode feeds the same ColumnBatch-consuming plugin via
    the from_entries shim: identical outcomes, Entry cost paid."""
    results = {}
    for execution in ("columnar", "batched"):
        cat = _catalog(P, 800)
        acted = []
        lock = threading.Lock()

        def action(e, params):
            return True

        def action_batch(batch, params):
            with lock:
                acted.extend(batch.fids.tolist())
            return [True] * len(batch)

        action.action_batch = action_batch
        eng = _engine(P, cat, action, n_threads=1, batch_size=64)
        r = eng.run("p", execution=execution)
        assert r.execution == execution
        results[execution] = (r.matched, r.succeeded, r.volume, sorted(acted))
    assert results["columnar"] == results["batched"]
    return results["columnar"]


def test_batched_mode_shim_matches_columnar():
    both(_shim)


def _scalar_path(P):
    results = {}
    for execution in ("columnar", "batched", "scalar"):
        cat = _catalog(P, 800)
        rec = Recorder()
        eng = _engine(P, cat, rec, n_threads=1, batch_size=64)
        r = eng.run("p", execution=execution)
        results[execution] = (r.matched, r.succeeded, r.volume, rec.acted())
    assert results["batched"] == results["scalar"] == results["columnar"]
    return results["scalar"]


def test_scalar_execution_path_agrees_with_batched():
    both(_scalar_path)


def _dry_run(P):
    cat = _catalog(P)
    rec = Recorder()
    eng = _engine(P, cat, rec, dry_run=True)
    r = eng.run("p")
    assert rec.calls == []
    assert r.succeeded == r.matched == len(cat)
    assert r.volume == r.matched_volume == sum(e.size for e in cat.entries())
    return _report(r)


def test_dry_run_counts_without_calling_actions():
    both(_dry_run)


def _downgrades(P):
    cat = _catalog(P, 300)
    rec = Recorder()
    # numeric-only criteria: the kernel path runs, nothing to report
    eng = _engine(P, cat, rec, rules=[("big", "size > 30k", {})])
    r = eng.run("p", evaluator="policy_scan")
    assert r.evaluator == "policy_scan" and r.fallback_reason == ""
    # glob predicate: the PolicyError is on the report
    eng2 = _engine(P, cat, rec, rules=[("glob", "path == '/p/d1/*'", {})])
    r2 = eng2.run("p", evaluator="policy_scan")
    assert r2.evaluator == "numpy"
    assert "policy_scan->numpy" in r2.fallback_reason
    assert "glob" in r2.fallback_reason
    # mesh without a store downgrades through the whole chain
    r3 = eng2.run("p", evaluator="policy_scan_mesh")
    assert r3.evaluator == "numpy"
    assert "policy_scan_mesh->policy_scan" in r3.fallback_reason
    assert "no device store attached" in r3.fallback_reason
    # numpy asked for explicitly: no fallback to report
    r4 = eng.run("p", evaluator="numpy")
    assert r4.evaluator == "numpy" and r4.fallback_reason == ""
    return [_report(x) for x in (r, r2, r3, r4)], sorted(rec.calls)


def test_fallback_reason_records_evaluator_downgrades():
    """RunReport carries the evaluator actually used AND why a requested
    kernel/mesh backend degraded."""
    both(_downgrades)
