"""One policy run on both engines: the port on ``device="cpu"`` against the
JAX package with ``evaluator="policy_scan"``.

The same entries go into both catalogs (the port's through
``catalog_from_columns``); the same policy runs on both. Matched counts,
actioned fid sequences, ``RunReport.evaluator`` and ``fallback_reason``
must be equal, for plain and budgeted runs, for a glob rule that falls
back to numpy and for ``policy_scan_mesh`` with no store attached. All
values are f32-exact, so the kernel path agrees bit for bit with numpy.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Catalog as JCatalog, Entry as JEntry
from repro.core import FsType as JFsType, HsmState as JHsmState
from repro.core import PolicyDefinition as JPolicyDefinition
from repro.core import PolicyEngine as JPolicyEngine
from repro_torch.convert import catalog_from_columns
from repro_torch.core import PolicyDefinition, PolicyEngine, parse_expr

NOW = float(2 ** 20)          # f32-exact "now"

SCOPES = ["true", "type == file", "not type == dir"]
CONDITIONS = [
    "size > 16M", "size <= 4M", "size >= 1M and size < 64M",
    "owner == 'user1'", "not owner == 'user2'", "group == 'grp0'",
    "last_access > 1000s", "last_mod > 2000s", "hsm_state == archived",
    "pool == 'ssd'", "size > 8M or owner == 'user0'",
    "not (size <= 1M or last_access <= 500s)",
]


class Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.calls = []

        def action_batch(batch, params):
            with self.lock:
                self.calls.extend(batch.fids.tolist())
            return [True] * len(batch)

        self.action_batch = action_batch

    def __call__(self, e, params):
        with self.lock:
            self.calls.append(e.fid)
        return True


def _catalogs(seed, n=400):
    rng = np.random.default_rng(seed)
    ref = JCatalog(n_shards=4)
    ref.upsert_batch([JEntry(
        fid=i + 1, name=f"f{i + 1}", path=f"/p/d{i % 5}/f{i + 1}",
        type=JFsType.FILE if rng.random() < 0.9 else JFsType.DIR,
        size=int(rng.integers(0, 2 ** 15)) * 1024,
        blocks=int(rng.integers(0, 2 ** 10)),
        owner=f"user{int(rng.integers(0, 4))}",
        group=f"grp{int(rng.integers(0, 3))}",
        pool=["", "ssd", "hdd"][int(rng.integers(0, 3))],
        hsm_state=JHsmState(int(rng.integers(0, 5))),
        atime=NOW - float(rng.integers(0, 10_000)),
        mtime=NOW - float(rng.integers(0, 10_000))) for i in range(n)])
    strings = [ref.strings.lookup(c) for c in range(len(ref.strings))]
    return ref, catalog_from_columns(ref.arrays(), strings, n_shards=4)


def _run_both(ref_cat, port_cat, scope, rules, evaluator="policy_scan",
              run_kw=None, **policy_kw):
    out = []
    for eng, pd in ((JPolicyEngine(ref_cat, clock=lambda: NOW),
                     JPolicyDefinition),
                    (PolicyEngine(port_cat, clock=lambda: NOW,
                                  device="cpu"), PolicyDefinition)):
        rec = Recorder()
        eng.register(pd.from_config(name="p", action=rec, scope=scope,
                                    rules=rules, mutates=False,
                                    batch_size=64, **policy_kw))
        r = eng.run("p", evaluator=evaluator, **(run_kw or {}))
        out.append(((r.matched, r.succeeded, r.volume, r.matched_volume,
                     r.evaluator, r.fallback_reason), list(rec.calls)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_run_matches_jax(seed):
    ref, port = _catalogs(seed)
    rng = np.random.default_rng(seed + 1)
    conds = rng.choice(len(CONDITIONS), size=3, replace=False)
    rules = [(f"r{i}", CONDITIONS[int(c)], {"tag": f"r{i}"})
             for i, c in enumerate(conds)]
    scope = SCOPES[seed % len(SCOPES)]
    sort_by = ["atime", "size", "mtime"][seed % 3]
    (jrep, jcalls), (trep, tcalls) = _run_both(
        ref, port, scope, rules, sort_by=sort_by, sort_desc=bool(seed % 2))
    assert trep == jrep
    assert trep[4] == "policy_scan" and trep[5] == ""
    assert tcalls == jcalls and len(tcalls) == trep[1] > 0


@pytest.mark.parametrize("budget", [dict(max_actions_per_run=37),
                                    dict(run_kw=dict(target_volume=5 << 20))],
                         ids=["max_actions", "target_volume"])
def test_budgeted_runs_match_jax(budget):
    ref, port = _catalogs(7)
    rules = [("big", "size > 8M", {}), ("old", "last_access > 3000s", {})]
    (jrep, jcalls), (trep, tcalls) = _run_both(
        ref, port, "type == file", rules, sort_by="atime", **budget)
    assert trep == jrep and tcalls == jcalls
    assert 0 < trep[1] < trep[0]          # the budget cut the run short


def test_glob_rule_falls_back_to_numpy_like_jax():
    ref, port = _catalogs(3)
    rules = [("tars", "name == 'f1*'", {}), ("big", "size > 16M", {})]
    (jrep, jcalls), (trep, tcalls) = _run_both(ref, port, "type == file",
                                               rules)
    assert trep == jrep and tcalls == jcalls
    assert trep[4] == "numpy"
    assert trep[5].startswith("policy_scan->numpy: ")


def test_mesh_without_store_degrades_like_jax():
    ref, port = _catalogs(4)
    rules = [("big", "size > 16M", {})]
    (jrep, jcalls), (trep, tcalls) = _run_both(
        ref, port, "true", rules, evaluator="policy_scan_mesh")
    assert trep == jrep and tcalls == jcalls
    assert trep[4] == "policy_scan"
    assert trep[5].startswith("policy_scan_mesh->policy_scan: ")


@pytest.mark.parametrize("single_launch", [True, False])
def test_match_programs_and_scan_catalog_match_jax(single_launch):
    from repro.core.policy import parse_expr as jparse
    from repro.kernels.policy_scan import ops as jops
    from repro_torch.kernels.policy_scan import ops as tops
    ref, port = _catalogs(5)
    texts = ["type == file and (size > 8M or owner == 'user1')",
             "size > 8M", "owner == 'user1'"]
    want = jops.match_programs(ref.arrays(), [jparse(t) for t in texts],
                               ref.strings, NOW, single_launch=single_launch)
    got = tops.match_programs(port.arrays(), [parse_expr(t) for t in texts],
                              port.strings, NOW, single_launch=single_launch,
                              device="cpu")
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    fids_w, agg_w = jops.scan_catalog(ref, jparse(texts[0]), NOW,
                                      use_kernel=False)
    fids_g, agg_g = tops.scan_catalog(port, parse_expr(texts[0]), NOW,
                                      device="cpu")
    np.testing.assert_array_equal(fids_g, fids_w)
    assert agg_g == agg_w


def test_engine_spans_keep_kernel_names():
    _ref, port = _catalogs(6, n=50)
    eng = PolicyEngine(port, clock=lambda: NOW, device="cpu")
    eng.register(PolicyDefinition.from_config(
        name="p", action=Recorder(), scope="type == file",
        rules=[("big", "size > 1M", {})], mutates=False))
    r = eng.run("p", evaluator="policy_scan")
    names = []

    def walk(node):
        names.append(node["name"])
        for child in node.get("children", []):
            walk(child)

    walk(r.telemetry["spans"])
    for name in ("kernel.compile", "kernel.launch", "kernel.readback"):
        assert name in names
