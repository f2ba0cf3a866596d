"""The runtime plane on the port: checkpoints, fault tolerance and the data
pipeline, against the JAX package.

The cases of ``tests/runtime/test_checkpoint.py`` (6) and
``tests/runtime/test_fault.py`` (5) and
``tests/runtime/test_distribution.py::test_data_pipeline_determinism_and_resume``
run on ``repro_torch`` with torch tensors for the states. Then, across the
packages: a checkpoint of one nested-dict state (f32, bf16 and int32
leaves) written by either manager restores in the other bit for bit; the
same save sequence gives both managers equal retention reports, ``steps()``,
``steps(include_cold=True)`` and artifact-catalog usage (the manifests are
byte for byte the same size: the port writes ``jax``'s treedef string and
the clock is pinned). ``data/pipeline.py`` and ``runtime/fault.py`` are
copies that differ from the reference only in imports.
"""
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import (HeartbeatMonitor, RedundantShardRouter,
                                       SimulatedFailure, run_with_restarts)

ROOT = Path(__file__).resolve().parents[1]


def _state(step):
    return {"params": {"w": torch.full((4, 4), float(step)),
                       "b": torch.arange(3.0)},
            "step": torch.tensor(step, dtype=torch.int32)}


# -- tests/runtime/test_checkpoint.py on the port --------------------------------


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"), keep_last=5)
    cm.save(_state(1), 1)
    cm.save(_state(2), 2)
    restored, step = cm.restore(like=_state(0))
    assert step == 2
    assert float(restored["params"]["w"][0, 0]) == 2.0
    restored1, _ = cm.restore(like=_state(0), step=1)
    assert float(restored1["params"]["w"][0, 0]) == 1.0


def test_atomic_no_partial_checkpoints(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"))
    cm.save(_state(1), 1)
    # simulate a crash mid-write: stage dir left behind without manifest
    stale = str(tmp_path / "ck" / "ckpt_00000002.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "shard_00000.npy"), "wb") as f:
        f.write(b"garbage")
    assert cm.steps() == [1]               # partial write invisible
    restored, step = cm.restore(like=_state(0))
    assert step == 1


def test_retention_keep_archive_trash(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"), keep_last=2,
                           archive_every=4, trash_capacity=2)
    for s in range(1, 9):
        cm.save(_state(s), s)
    live = cm.steps()
    assert live[-2:] == [7, 8] and len(live) == 2
    cold = cm.steps(include_cold=True)
    assert 4 in cold and 8 in cold         # every-4th archived to cold tier
    # archived checkpoints restorable
    r, step = cm.restore(like=_state(0), step=4)
    assert float(r["params"]["w"][0, 0]) == 4.0


def test_undelete(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"), keep_last=1,
                           trash_capacity=5)
    for s in (1, 2, 3):
        cm.save(_state(s), s)
    assert cm.steps() == [3]
    assert cm.undelete(2)                  # bring step 2 back from trash
    assert 2 in cm.steps()
    r, _ = cm.restore(like=_state(0), step=2)
    assert float(r["params"]["w"][0, 0]) == 2.0


def test_artifact_catalog_tracks_shards(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"), keep_last=3)
    cm.save(_state(1), 1)
    usage = cm.store.usage()
    assert usage["count"] >= 3             # 2 shards + manifest
    # disaster recovery: rebuild the artifact catalog by rescanning
    cm.store.catalog = type(cm.store.catalog)(n_shards=2)
    from repro_torch.core.stats import StatsAggregator
    cm.store.stats = StatsAggregator(cm.store.catalog.strings)
    cm.store.catalog.add_delta_hook(cm.store.stats.on_delta)
    n = cm.store.rescan()
    assert n >= 3


def test_dtype_and_structure_checks(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"))
    state = {"params": {"w": torch.ones((2, 2), dtype=torch.bfloat16)}}
    cm.save(state, 1)
    restored, _ = cm.restore(like=state)
    assert restored["params"]["w"].dtype == torch.bfloat16
    with pytest.raises(AssertionError):
        cm.restore(like={"params": {"w": 1, "extra": 2}})


# -- tests/runtime/test_fault.py on the port --------------------------------------


def test_heartbeat_detects_dead_hosts(fake_clock):
    hb = HeartbeatMonitor(n_hosts=4, timeout=5.0, clock=fake_clock)
    assert hb.healthy()
    fake_clock.advance(3)
    for h in (0, 1, 2):
        hb.beat(h)
    fake_clock.advance(3)
    assert hb.dead_hosts() == [3]
    hb.revive(3)
    assert hb.healthy()
    hb.mark_dead(1)
    assert 1 in hb.dead_hosts()


def test_run_with_restarts_completes(tmp_path):
    """Inject failures at fixed steps; training must still finish exactly."""
    cm = CheckpointManager(str(tmp_path / "ck"), keep_last=3)
    failures = {7, 23}
    seen = []

    def init_state():
        return {"acc": torch.zeros(()), "hist": torch.zeros(40)}

    def step_fn(state, step):
        if step in failures:
            failures.discard(step)
            raise SimulatedFailure(host=step % 4, step=step)
        seen.append(step)
        hist = state["hist"].clone()
        hist[step] = 1.0
        return {"acc": state["acc"] + step, "hist": hist}

    final, restarts, replayed = run_with_restarts(
        train_steps=30, step_fn=step_fn, init_state=init_state, ckpt=cm,
        ckpt_interval=5)
    assert restarts == 2 and replayed > 0
    # the final accumulator must equal an exact, single-pass run
    assert float(final["acc"]) == sum(range(30))
    assert float(final["hist"].sum()) == 30


def test_restart_budget_enforced(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"))

    def step_fn(state, step):
        raise SimulatedFailure(host=0, step=step)

    with pytest.raises(RuntimeError, match="restart budget"):
        run_with_restarts(5, step_fn, lambda: {"x": np.zeros(1)}, cm,
                          max_restarts=2)


def test_redundant_shards_cover_failures():
    r = RedundantShardRouter(n_shards=16, n_hosts=8, replication=2)
    assert r.coverage_without([]) == 1.0
    assert r.coverage_without([3]) == 1.0          # any single host loss
    # replication=2 with adjacent assignment: losing 2 adjacent hosts
    # may drop shards; coverage reports it honestly
    cov = r.coverage_without([0, 1])
    assert 0.8 <= cov <= 1.0


def test_straggler_picks_fast_replica():
    r = RedundantShardRouter(n_shards=4, n_hosts=4, replication=2)
    latency = {0: 10.0, 1: 0.1, 2: 10.0, 3: 0.1}
    for s in range(4):
        picked = r.pick(s, lambda h: latency[h])
        assert latency[picked] <= min(latency[h] for h in r.hosts_for(s))


# -- tests/runtime/test_distribution.py's pipeline case on the port ---------------


def test_data_pipeline_determinism_and_resume():
    from repro_torch.data import DataPipeline
    p1 = DataPipeline(vocab=100, seq_len=16, global_batch=8, n_shards=2,
                      seed=7)
    batches = [p1.next_batch(shard=0) for _ in range(5)]
    snap = p1.checkpoint()
    after = [p1.next_batch(shard=0) for _ in range(3)]
    # resume elsewhere
    p2 = DataPipeline(vocab=100, seq_len=16, global_batch=8, n_shards=2,
                      seed=7)
    p2.restore(snap)
    replay = [p2.next_batch(shard=0) for _ in range(3)]
    for a, b in zip(after, replay):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # shards differ, steps differ
    assert not np.array_equal(batches[0]["tokens"], batches[1]["tokens"])
    assert not np.array_equal(p1.batch_for(0, 0)["tokens"],
                              p1.batch_for(0, 1)["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(batches[0]["labels"][:, :-1],
                                  batches[0]["tokens"][:, 1:])
    # and equal to the reference's batches
    from repro.data import DataPipeline as JaxPipeline
    ref = JaxPipeline(vocab=100, seq_len=16, global_batch=8, n_shards=2,
                      seed=7)
    for step in (0, 4, 9):
        for shard in (0, 1):
            want, got = ref.batch_for(step, shard), p1.batch_for(step, shard)
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


# -- across the packages ----------------------------------------------------------


def _nested(seed):
    """One nested-dict state: f32, bf16 and int32 leaves, a tuple and a
    list, as numpy arrays (bf16 as its uint16 bits)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    bf = rng.standard_normal((4, 6)).astype(np.float32)
    return {"params": {"w": w, "emb": bf, "lam": np.arange(3.0, dtype=np.float32)},
            "opt": {"m": (w * 0.5, np.zeros(2, np.float32)),
                    "count": np.array(7, np.int32)},
            "hist": [np.array([1, 2, 3], np.int32)],
            "step": np.array(seed, np.int32)}


def _as_jax(tree):
    import jax
    import jax.numpy as jnp
    out = jax.tree.map(jnp.asarray, tree)
    out["params"]["emb"] = out["params"]["emb"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(np.array(x))
    out = conv(tree)
    out["params"]["emb"] = out["params"]["emb"].to(torch.bfloat16)
    return out


def _leaves_torch(tree):
    from repro_torch.runtime.checkpoint import tree_flatten
    return tree_flatten(tree)[0]


def _bits(x) -> np.ndarray:
    """A leaf's bits as a numpy array (bf16 through an int16 view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    import jax
    from repro.runtime.checkpoint import CheckpointManager as JaxManager
    jax_state, torch_state = _as_jax(_nested(1)), _as_torch(_nested(1))
    like_j, like_t = _as_jax(_nested(2)), _as_torch(_nested(2))
    d = str(tmp_path / "ck")
    if writer == "repro":
        JaxManager(d).save(jax_state, 5)
        got, step = CheckpointManager(d).restore(like=like_t)
        leaves = _leaves_torch(got)
        want = jax.tree.leaves(jax_state)
    else:
        CheckpointManager(d).save(torch_state, 5)
        got, step = JaxManager(d).restore(like=like_j)
        leaves = jax.tree.leaves(got)
        want = _leaves_torch(torch_state)
    assert step == 5 and len(leaves) == len(want) == 8
    for g, w in zip(leaves, want):
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape
        np.testing.assert_array_equal(gb, wb)
    if writer == "repro":
        assert got["params"]["emb"].dtype == torch.bfloat16
        assert isinstance(got["opt"]["m"], tuple)
        assert isinstance(got["hist"], list)
    # both managers write the same manifest (treedef, dtypes, files)
    with open(os.path.join(d, "ckpt_00000005", "manifest.json")) as f:
        man = json.load(f)
    assert man["treedef"] == str(jax.tree.structure(jax_state))
    assert [x["dtype"] for x in man["leaves"]] == [
        str(np.asarray(x).dtype) for x in jax.tree.leaves(jax_state)]


def test_restore_puts_leaves_on_like_device_and_dtype(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"))
    cm.save(_as_torch(_nested(3)), 3)
    like = _as_torch(_nested(0))
    like["params"]["w"] = like["params"]["w"].to(torch.bfloat16)
    got, _ = cm.restore(like=like)
    assert got["params"]["w"].dtype == torch.bfloat16
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 3
    np_like = {"x": np.zeros(2, np.float64)}
    cm.save({"x": np.arange(2, dtype=np.float32)}, 4)
    got, _ = cm.restore(like=np_like, step=4)
    assert got["x"].dtype == torch.float64
    # a None sharding leaves the leaf as restored (a mesh's shardings:
    # test_restore_with_shardings_lays_the_state_out_on_a_mesh)
    again, _ = cm.restore(like=np_like, step=4, shardings={"x": None})
    assert torch.equal(again["x"], got["x"])


def test_same_saves_give_equal_retention_and_usage(tmp_path, monkeypatch):
    import time
    from repro.runtime.checkpoint import CheckpointManager as JaxManager
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    kw = dict(keep_last=2, archive_every=3, trash_capacity=2)
    jm = JaxManager(str(tmp_path / "j"), **kw)
    tm = CheckpointManager(str(tmp_path / "t"), **kw)
    for s in range(1, 10):
        js, ts = _as_jax(_nested(s)), _as_torch(_nested(s))
        jm.save(js, s)
        tm.save(ts, s)
        assert jm.apply_retention() == tm.apply_retention()
        assert jm.steps() == tm.steps()
        assert jm.steps(include_cold=True) == tm.steps(include_cold=True)
        assert jm.store.usage() == tm.store.usage()
    assert jm.undelete(7) == tm.undelete(7)
    assert jm.steps() == tm.steps() and jm.store.usage() == tm.store.usage()
    assert jm.store.rescan() == tm.store.rescan()
    assert jm.store.usage() == tm.store.usage()


def _without_imports(text: str) -> str:
    return re.sub(r"^(from|import) .*$", "", text, flags=re.MULTILINE)


@pytest.mark.parametrize("rel", ["data/__init__.py", "data/pipeline.py",
                                 "runtime/fault.py"])
def test_copies_differ_only_in_imports(rel):
    ref = (ROOT / "src" / "repro" / rel).read_text()
    port = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert _without_imports(port) == _without_imports(ref)


_RESTORE_ON_MESH = """
import json
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import state_shardings
from repro_torch.runtime.sharding import shard_view, tree_map
from repro_torch.train import init_train_state
cfg = get_config("gemma2_9b", smoke=True)
state = init_train_state(Model(cfg), AdamW(),
                         torch.Generator().manual_seed(5))
mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
sh = state_shardings(cfg, mesh, state)
restored, step = CheckpointManager(CK).restore(like=state, shardings=sh)
bad = []
def one(got, want, s):
    if not torch.equal(got.full_tensor(), want.detach()):
        bad.append("value")
    if not torch.equal(got.to_local(), shard_view(want.detach(), s.mesh,
                                                  s.placements)):
        bad.append("shard")
tree_map(one, restored, state, sh)
print(json.dumps({"step": step, "bad": bad, "sharded": sum(
    any(p.is_shard() for p in t.placements)
    for t in restored["opt"]["m"].values())}))
"""


def test_restore_with_shardings_lays_the_state_out_on_a_mesh(tmp_path):
    """A checkpoint written by one process (plain tensors) restores onto
    a 2x1 mesh of 2 gloo ranks through ``restore(shardings=)``: every leaf
    a ``DTensor`` whose whole tensor is the saved one and whose local
    shard is the one its placements give (ZeRO-1 moments sharded over
    data)."""
    import sys
    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.train import init_train_state
    from torch_dist import run_ranks
    state = init_train_state(Model(get_config("gemma2_9b", smoke=True)),
                             AdamW(), torch.Generator().manual_seed(5))
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(state, 3)
    outs = run_ranks(f"CK = {ck!r}\n" + _RESTORE_ON_MESH, 2, timeout=120)
    for out in outs:
        rec = json.loads(out)
        assert rec["step"] == 3 and rec["bad"] == [] and rec["sharded"] > 0
