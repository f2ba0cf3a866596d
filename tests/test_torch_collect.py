"""The collect plane on the port: scanner, changelog pipelines and HSM.

``repro_torch.fs`` and ``repro_torch.core.{scanner,pipeline,hsm,alerts,
plugins}`` are copies of the JAX package's modules with their imports
rewritten; ``test_copies_differ_only_in_imports`` holds them to that. The
cases of ``tests/core/test_scanner.py``, ``test_pipeline.py`` and
``test_hsm.py`` follow, on the port's modules (engines on the CPU), then
the paper's headline scenario of ``tests/test_system.py``
(``test_lustre_monitoring_end_to_end``) with ``jax`` and ``repro``
blocked, and the same scenario with a ``DeviceColumnStore`` attached: the
archive policy's matches through ``policy_scan_mesh`` equal the ``numpy``
evaluator's, and the archive pass and watermark purges run through the
store.
"""
import os
import random
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

try:                          # optional dependency: that one test skips
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = None

from repro_torch.core import (Catalog, ChangelogCounters, ChangelogStream,
                              EventPipeline, HsmCoordinator, HsmState,
                              PipelineConfig, PolicyEngine, Scanner,
                              multi_client_scan, prune_missing)
from repro_torch.fs import HsmBackend, LustreSim

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
COPIES = ["fs/__init__.py", "fs/base.py", "fs/posixfs.py", "fs/lustrefs.py",
          "fs/hsm_backend.py", "core/scanner.py", "core/pipeline.py",
          "core/hsm.py", "core/alerts.py", "core/plugins.py"]


@pytest.mark.parametrize("name", COPIES)
def test_copies_differ_only_in_imports(name):
    """Each copied module is the JAX package's with ``repro`` renamed to
    ``repro_torch`` (its imports are relative; two docstrings name the
    package) and nothing else."""
    ref = (SRC / "repro" / name).read_text()
    port = (SRC / "repro_torch" / name).read_text()
    assert port == re.sub(r"~repro\.", "~repro_torch.", ref)


# -- tests/core/test_scanner.py ----------------------------------------------

def build_tree(fs, seed: int, n_dirs: int, files_per_dir: int) -> int:
    rng = random.Random(seed)
    dirs = [fs.root_fid()]
    total = 1
    for i in range(n_dirs):
        parent = rng.choice(dirs)
        d = fs.mkdir(parent, f"d{i}")
        dirs.append(d)
        total += 1
        for j in range(rng.randint(0, files_per_dir)):
            f = fs.create(d, f"f{j}", owner=rng.choice(["a", "b"]))
            fs.write(f, rng.randint(0, 10000))
            total += 1
    return total


@pytest.mark.parametrize("threads", [1, 4])
def test_scan_finds_everything(threads):
    fs = LustreSim()
    total = build_tree(fs, seed=1, n_dirs=20, files_per_dir=5)
    cat = Catalog()
    st_ = Scanner(fs, cat, n_threads=threads).scan()
    assert len(cat) == total == fs.count()
    assert st_.errors == 0


def _scan_thread_count_invariant(seed, threads):
    """Property: scan result is independent of parallelism (Fig. 3)."""
    fs = LustreSim()
    build_tree(fs, seed=seed, n_dirs=10, files_per_dir=3)
    cat1 = Catalog()
    Scanner(fs, cat1, n_threads=1).scan()
    cat2 = Catalog()
    Scanner(fs, cat2, n_threads=threads).scan()
    fids1 = sorted(f for s in cat1.shards for f in s.fids())
    fids2 = sorted(f for s in cat2.shards for f in s.fids())
    assert fids1 == fids2


if given is not None:
    test_scan_thread_count_invariant = settings(
        max_examples=15, deadline=None)(given(
            seed=st.integers(0, 1000), threads=st.integers(1, 6))(
            _scan_thread_count_invariant))
else:
    def test_scan_thread_count_invariant():
        """Property: scan result is independent of parallelism (Fig. 3)."""
        pytest.skip("needs hypothesis")


def test_multi_client_scan_equivalent():
    fs = LustreSim()
    total = build_tree(fs, seed=7, n_dirs=30, files_per_dir=4)
    cat = Catalog()
    multi_client_scan(fs, cat, n_clients=3, threads_per_client=2)
    assert len(cat) == total


def test_prune_missing_after_deletes():
    fs = LustreSim()
    build_tree(fs, seed=3, n_dirs=5, files_per_dir=4)
    cat = Catalog()
    Scanner(fs, cat).scan()
    # delete some files behind the catalog's back
    victims = [e.fid for e in cat.entries() if e.type == 0][:3]
    for fid in victims:
        fs.unlink(fid)
    removed = prune_missing(fs, cat)
    assert removed == len(victims)
    assert len(cat) == fs.count()


# -- tests/core/test_pipeline.py --------------------------------------------

def _fs_with_files(n=30):
    fs = LustreSim(n_mdts=1)
    d = fs.mkdir(fs.root_fid(), "dir")
    fids = []
    for i in range(n):
        f = fs.create(d, f"f{i}", owner="u", uid="u")
        fs.write(f, 100 * (i + 1))
        fids.append(f)
    return fs, d, fids


def test_sync_pipeline_mirrors_fs():
    fs, d, fids = _fs_with_files()
    cat = Catalog()
    pipe = EventPipeline(fs, cat, fs.changelog.stream(0), PipelineConfig())
    n = pipe.process_once(100000)
    assert n > 0
    assert len(cat) == fs.count() - 1      # root not in changelog
    assert cat.get(fids[3]).size == 400
    # acks happened: nothing pending
    assert fs.changelog.stream(0).pending() == 0


def test_incremental_updates_no_rescan():
    fs, d, fids = _fs_with_files(10)
    cat = Catalog()
    pipe = EventPipeline(fs, cat, fs.changelog.stream(0), PipelineConfig())
    pipe.process_once(100000)
    fs.write(fids[0], 5000, uid="u")
    fs.unlink(fids[1])
    new = fs.create(d, "fresh", owner="u")
    fs.write(new, 7)
    pipe.process_once()
    assert cat.get(fids[0]).size == 100 + 5000
    assert cat.get(fids[1]) is None
    assert cat.get(new).size == 7


def test_async_dirty_tag_dedups():
    """Paper SIII-A2 future work: repeated changes fold into one refresh."""
    fs, d, fids = _fs_with_files(5)
    cat = Catalog()
    cfg = PipelineConfig(async_updates=True)
    pipe = EventPipeline(fs, cat, fs.changelog.stream(0), cfg)
    pipe.process_once(100000)
    for _ in range(20):                    # 20 writes to the same file
        fs.write(fids[2], 10, uid="u")
    n = pipe.process_once()
    assert n == 20
    assert pipe.dedup_hits >= 18           # tagged once, folded repeatedly
    assert cat.get(fids[2]).size == 300 + 200


def test_threaded_pipeline_drains():
    fs, d, fids = _fs_with_files(40)
    cat = Catalog()
    counters = ChangelogCounters()
    pipe = EventPipeline(fs, cat, fs.changelog.stream(0),
                         PipelineConfig(n_workers=3), counters)
    pipe.start()
    try:
        assert pipe.drain(timeout=20)
        for i in range(10):
            fs.write(fids[i], 1, uid="live")
        assert pipe.drain(timeout=20)
    finally:
        pipe.stop()
    assert cat.get(fids[0]).size == 101
    assert counters.snapshot()["per_user"]["live"]


def test_same_batch_create_unlink_never_materializes():
    """An UNLNK after a CREAT of the same fid in one batch folds to nothing:
    no error, no catalog entry, no dirty tag (sync and async modes)."""
    for async_updates in (False, True):
        fs = LustreSim(n_mdts=1)
        d = fs.mkdir(fs.root_fid(), "dir")
        keep = fs.create(d, "keep", owner="u")
        fs.write(keep, 50)
        ephemeral = fs.create(d, "tmp", owner="u")
        fs.write(ephemeral, 999)
        fs.unlink(ephemeral)               # same pending batch as its CREAT
        cat = Catalog()
        pipe = EventPipeline(fs, cat, fs.changelog.stream(0),
                             PipelineConfig(async_updates=async_updates,
                                            batch_size=1024))
        pipe.process_once(100000)
        assert cat.get(ephemeral) is None
        assert ephemeral not in pipe._dirty
        assert cat.get(keep).size == 50
        assert fs.changelog.stream(0).pending() == 0   # all acked cleanly


def test_delta_fanout_notifies_after_commit():
    fs, d, fids = _fs_with_files(8)
    cat = Catalog()
    pipe = EventPipeline(fs, cat, fs.changelog.stream(0), PipelineConfig())
    events = []
    pipe.add_delta_listener(
        lambda changed, removed: events.append((sorted(changed),
                                                sorted(removed))))
    pipe.process_once(100000)
    changed = sorted(f for ch, _ in events for f in ch)
    assert changed == sorted([d] + fids)
    events.clear()

    fs.write(fids[0], 7, uid="u")
    fs.write(fids[0], 7, uid="u")          # folded: one refresh per batch
    fs.unlink(fids[1])
    pipe.process_once(100000)
    changed = [f for ch, _ in events for f in ch]
    removed = [f for _, rm in events for f in rm]
    assert changed == [fids[0]] and removed == [fids[1]]


def test_delta_fanout_async_mode_notifies_refresh():
    fs, d, fids = _fs_with_files(5)
    cat = Catalog()
    pipe = EventPipeline(fs, cat, fs.changelog.stream(0),
                         PipelineConfig(async_updates=True))
    pipe.process_once(100000)
    events = []
    pipe.add_delta_listener(
        lambda changed, removed: events.append((list(changed),
                                                list(removed))))
    for _ in range(10):
        fs.write(fids[2], 10, uid="u")
    fs.unlink(fids[3])
    pipe.process_once(100000)
    changed = [f for ch, _ in events for f in ch]
    removed = [f for _, rm in events for f in rm]
    assert removed == [fids[3]]
    assert changed == [fids[2]]            # deduped to one refresh
    assert cat.get(fids[2]).size == 300 + 100


def test_scan_and_changelog_agree():
    """DB built by scan == DB built by changelog replay."""
    fs, d, fids = _fs_with_files(25)
    by_scan = Catalog()
    Scanner(fs, by_scan).scan()
    by_log = Catalog()
    EventPipeline(fs, by_log, fs.changelog.stream(0),
                  PipelineConfig()).process_once(100000)
    for fid in fids:
        a, b = by_scan.get(fid), by_log.get(fid)
        assert a.size == b.size and a.owner == b.owner and a.path == b.path


# -- columnar ingest plane ----------------------------------------------------

class _SlowStat:
    """fs proxy whose (batched) stat takes a while — long enough that a
    drain() racing an in-flight refresh would observe stale state."""

    def __init__(self, inner, delay):
        self._inner = inner
        self._delay = delay

    def stat_batch(self, fids):
        time.sleep(self._delay)
        return self._inner.stat_batch(fids)

    def stat(self, fid):
        time.sleep(self._delay)
        return self._inner.stat(fid)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_drain_waits_for_inflight_updater_refresh():
    """Regression: drain() returned True while an async updater held fids
    it had already popped from ``_dirty`` with the refresh still in
    flight — pending()==0 and an empty dirty set are not 'drained'."""
    fs, d, fids = _fs_with_files(5)
    cat = Catalog()
    pipe = EventPipeline(_SlowStat(fs, 0.25), cat, fs.changelog.stream(0),
                         PipelineConfig(async_updates=True, n_updaters=1))
    pipe.start()
    try:
        assert pipe.drain(timeout=30)
        size0 = cat.get(fids[0]).size
        fs.write(fids[0], 77, uid="u")
        # wait for the tag to be consumed AND popped by the updater: the
        # only remaining signal of unfinished work is the refresh itself
        deadline = time.time() + 10
        while (fs.changelog.stream(0).pending() or pipe._dirty) \
                and time.time() < deadline:
            time.sleep(0.005)
        assert pipe.drain(timeout=30)
        assert cat.get(fids[0]).size == size0 + 77, \
            "drain() returned before the in-flight refresh committed"
    finally:
        pipe.stop()


def test_drain_counts_inflight_worker_batches():
    """Same race on the oracle worker pool: a popped-but-uncommitted
    batch must keep drain() blocked (the batch queue is already empty)."""
    fs, d, fids = _fs_with_files(6)
    cat = Catalog()
    pipe = EventPipeline(_SlowStat(fs, 0.2), cat, fs.changelog.stream(0),
                         PipelineConfig(columnar=False, n_workers=2))
    pipe.start()
    try:
        assert pipe.drain(timeout=30)
        assert len(cat) == fs.count() - 1
    finally:
        pipe.stop()


def test_idle_pipeline_does_not_busy_wait():
    """Readers and updaters block on Conditions: an idle second must add
    zero wakeups and zero pipeline.apply spans to the histograms."""
    fs, d, fids = _fs_with_files(10)
    cat = Catalog()
    pipe = EventPipeline(fs, cat, fs.changelog.stream(0),
                         PipelineConfig(async_updates=True))
    pipe.start()
    try:
        assert pipe.drain(timeout=30)
        time.sleep(0.2)                      # settle any tail wakeup

        def snap():
            wake = sum(v for k, v in
                       cat.telemetry.counter_values().items()
                       if k.startswith("pipeline_wakeups"))
            spans = cat.telemetry.histogram(
                "span_seconds", span="pipeline.apply").count
            return wake, spans

        before = snap()
        time.sleep(0.6)
        assert snap() == before, \
            "idle pipeline threads iterated without work (busy-wait)"
        fs.write(fids[0], 9, uid="u")        # ...but wakeups still work
        assert pipe.drain(timeout=30)
        assert snap() > before
    finally:
        pipe.stop()
    assert cat.get(fids[0]).size == 109


def test_hub_sharded_readers_mirror_all_mdts():
    """One pipeline over a whole hub: per-MDT readers with independent
    acks, one shared catalog, all MDT streams drained."""
    fs = LustreSim(n_mdts=4)
    dirs = [fs.mkdir(fs.root_fid(), f"d{i}") for i in range(8)]
    fids = [fs.create(dirs[i % 8], f"f{i}", owner="u", uid="u")
            for i in range(60)]
    for f in fids:
        fs.write(f, 10, uid="u")
    cat = Catalog()
    pipe = EventPipeline(fs, cat, fs.changelog, PipelineConfig())
    pipe.start()
    try:
        assert pipe.drain(timeout=30)
        assert len(cat) == fs.count() - 1
        for mdt in range(4):
            assert fs.changelog.stream(mdt).pending() == 0
        fs.unlink(fids[0])
        fs.write(fids[1], 90, uid="u")
        assert pipe.drain(timeout=30)
        assert cat.get(fids[0]) is None
        assert cat.get(fids[1]).size == 100
    finally:
        pipe.stop()


def test_adaptive_quantum_grows_and_is_visible():
    """A pre-emitted burst on one MDT grows the reader's quantum toward
    max_batch; transitions land in the adaptation counters."""
    fs, d, fids = _fs_with_files(10)
    for _ in range(40):
        for f in fids:
            fs.write(f, 1, uid="u")
    cat = Catalog()
    pipe = EventPipeline(fs, cat, fs.changelog.stream(0),
                         PipelineConfig(batch_size=16, min_batch=16,
                                        max_batch=1024, lag_target=60.0))
    pipe.start()
    try:
        assert pipe.drain(timeout=30)
    finally:
        pipe.stop()
    vals = cat.telemetry.counter_values()
    grown = sum(v for k, v in vals.items()
                if k.startswith("pipeline_batch_adaptations")
                and 'direction="grow"' in k)
    assert grown >= 1
    assert pipe._quantum[0] > 16


def test_crash_resume_mid_columnar_batch(tmp_path):
    """Crash after commit but before ack: the restarted stream re-delivers
    the committed batch; replaying it lands on identical catalog state."""
    d = str(tmp_path)
    fs = LustreSim(n_mdts=1, changelog_dir=d)
    root_d = fs.mkdir(fs.root_fid(), "dir")
    fids = [fs.create(root_d, f"f{i}", owner="u", uid="u")
            for i in range(12)]
    for f in fids:
        fs.write(f, 100, uid="u")
    fs.unlink(fids[3])

    cat = Catalog()
    stream = fs.changelog.stream(0)
    pipe = EventPipeline(fs, cat, stream, PipelineConfig(batch_size=9))
    pipe._acks[0].complete_range = lambda lo, hi: None   # die before ack
    pipe.process_once(10 ** 6)
    n_committed = len(cat)
    assert n_committed > 0 and stream.pending() > 0      # mid-batch crash

    # restart: fresh stream over the same persist dir re-delivers all
    # unacked records; the same catalog replays them idempotently
    stream.close()
    s2 = ChangelogStream(mdt=0, persist_dir=d)
    pipe2 = EventPipeline(fs, cat, s2, PipelineConfig(batch_size=9))
    pipe2.process_once(10 ** 6)
    assert s2.pending() == 0

    # byte-identical to a ground-truth mirror of the fs
    oracle = Catalog()
    Scanner(fs, oracle).scan()
    for f in [root_d] + fids:
        a, b = cat.get(f), oracle.get(f)
        if b is None:
            assert a is None
        else:
            assert (a.size, a.owner, a.path, int(a.type)) == \
                (b.size, b.owner, b.path, int(b.type))


# -- tests/core/test_hsm.py -------------------------------------------------

def _setup(n_files=20, fsize=1000, ost_capacity=8000, n_osts=2,
           clock=None):
    kw = dict(clock=clock) if clock else {}
    fs = LustreSim(n_osts=n_osts, ost_capacity=ost_capacity,
                   hsm=HsmBackend(), **kw)
    d = fs.mkdir(fs.root_fid(), "data")
    fids = []
    for i in range(n_files):
        f = fs.create(d, f"f{i}", owner="u")
        fs.write(f, fsize)
        fids.append(f)
    cat = Catalog()
    Scanner(fs, cat).scan()
    eng = PolicyEngine(cat, clock=clock, device="cpu") if clock \
        else PolicyEngine(cat, device="cpu")
    return fs, d, fids, cat, eng


def test_archive_then_release_frees_ost_space(fake_clock):
    fs, d, fids, cat, eng = _setup(clock=fake_clock)
    coord = HsmCoordinator(fs, cat, eng, high_wm=50.0, low_wm=20.0)
    rep = coord.archive_pass()
    assert rep.succeeded == 20 and rep.failed == 0
    assert fs.hsm.count() == 20
    used_before = sum(o.used for o in fs.osts)
    fake_clock.advance(100)
    reports = coord.space_check()        # OSTs above 50% -> purge to 20%
    assert reports, "watermark should have fired"
    used_after = sum(o.used for o in fs.osts)
    assert used_after < used_before
    for o in fs.osts:
        assert o.usage_pct <= 50.0
    # released entries are stubs: size kept, blocks 0
    released = [f for f in fids
                if cat.get(f) and cat.get(f).hsm_state == HsmState.RELEASED]
    assert released
    e = cat.get(released[0])
    assert e.size == 1000 and e.blocks == 0


def test_read_restores_released_file(fake_clock):
    fs, d, fids, cat, eng = _setup(clock=fake_clock)
    coord = HsmCoordinator(fs, cat, eng)
    coord.archive_pass()
    fs.hsm_release(fids[0])
    assert fs.stat(fids[0]).hsm_state == HsmState.RELEASED
    size = fs.read(fids[0])              # transparent restore
    assert size == 1000
    assert fs.stat(fids[0]).hsm_state == HsmState.ARCHIVED
    assert fs.stat(fids[0]).blocks == 1000


def test_dirty_after_write_requires_rearchive(fake_clock):
    fs, d, fids, cat, eng = _setup(clock=fake_clock)
    coord = HsmCoordinator(fs, cat, eng)
    coord.archive_pass()
    fs.write(fids[1], 50)
    assert fs.stat(fids[1]).hsm_state == HsmState.DIRTY
    with pytest.raises(RuntimeError):
        fs.hsm_release(fids[1])          # cannot release a dirty file


def test_undelete(fake_clock):
    fs, d, fids, cat, eng = _setup(clock=fake_clock)
    coord = HsmCoordinator(fs, cat, eng)
    coord.archive_pass()
    victim = fids[2]
    fs.unlink(victim)
    assert fs.stat(victim) is None
    new_fid = coord.undelete(victim, d, "f2_restored")
    assert new_fid is not None
    assert fs.stat(new_fid).size == 1000


def test_disaster_recovery_rebuild(fake_clock):
    fs, d, fids, cat, eng = _setup(clock=fake_clock)
    # catalog lost: rebuild by scan
    cat2 = Catalog()
    eng2 = PolicyEngine(cat2, clock=fake_clock, device="cpu")
    coord = HsmCoordinator(fs, cat2, eng2)
    n = coord.rebuild_catalog()
    assert n == fs.count()
    assert len(cat2) == fs.count()


# -- tests/test_system.py: the headline scenario -----------------------------

_HEADLINE = r'''
import sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())


class Clock:
    def __init__(self):
        self.t = 1_000_000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


fake_clock = Clock()
'''


def headline(fake_clock, store_groups=0):
    """``tests/test_system.py``'s ``test_lustre_monitoring_end_to_end`` on
    the port: a filesystem under load, mirrored in soft real-time, policies
    keeping OSTs under watermark, O(1) reports. With ``store_groups`` a
    ``DeviceColumnStore`` of that many groups (on the CPU) is attached and
    both HSM policies run through ``policy_scan_mesh``; the archive
    policy's matched fids must equal the ``numpy`` evaluator's first.
    Returns the archive pass's RunReport."""
    from repro_torch.core import (Catalog, DeviceColumnStore, EventPipeline,
                                  HsmCoordinator, PipelineConfig,
                                  PolicyEngine, Reports, Scanner,
                                  StatsAggregator)
    from repro_torch.fs import HsmBackend, LustreSim

    fs = LustreSim(n_osts=4, ost_capacity=100_000, n_mdts=2,
                   hsm=HsmBackend(), clock=fake_clock)
    home = fs.mkdir(fs.root_fid(), "home")
    users = {u: fs.mkdir(home, u, owner=u) for u in ("ann", "bob")}

    cat = Catalog(n_shards=4)
    stats = StatsAggregator(cat.strings)
    cat.add_delta_hook(stats.on_delta)
    Scanner(fs, cat, n_threads=2).scan()
    pipes = [EventPipeline(fs, cat, fs.changelog.stream(m),
                           PipelineConfig()) for m in range(2)]
    eng = PolicyEngine(cat, clock=fake_clock, device="cpu")
    coord = HsmCoordinator(fs, cat, eng, archive_age="10s",
                           high_wm=60.0, low_wm=30.0)
    if store_groups:
        eng.attach_device_store(DeviceColumnStore(cat, groups=store_groups,
                                                  device="cpu"))
        for name in ("hsm_archive", "hsm_release"):
            eng.policies[name].evaluator = "policy_scan_mesh"

    # workload: users create files; DB follows via changelog only
    fids = []
    for i in range(40):
        u = "ann" if i % 2 else "bob"
        f = fs.create(users[u], f"f{i}", owner=u, uid=u, jobid=f"job{i%3}")
        fs.write(f, 8000, uid=u)
        fids.append(f)
    for p in pipes:
        p.process_once(10000)
    assert len(cat) == fs.count()

    rep = Reports(cat, stats)
    ann = [r for r in rep.report_user("ann") if r["type"] == "file"][0]
    assert ann["count"] == 20 and ann["volume"] == 160_000

    # archive then trigger watermark purges
    fake_clock.advance(60)
    if store_groups:
        policy = eng.policies["hsm_archive"]
        now = fake_clock()
        mesh = eng.device_store.match(eng._programs(policy, None), now,
                                      with_agg=False)
        mesh_fids = mesh.plan(policy.sort_by)[0]
        mask, _rule, cols, used, _why = eng._match(policy, None, now,
                                                   "numpy")
        assert used == "numpy"
        assert sorted(mesh_fids.tolist()) == sorted(
            cols["fid"][mask].tolist())
        assert len(mesh_fids) == 40
    archived = coord.archive_pass()
    purges = coord.space_check()
    assert purges
    for o in fs.osts:
        assert o.usage_pct <= 60.0
    for p in pipes:
        p.process_once(10000)   # HSM events flow back into the DB
    hsm_rep = stats.report_hsm()
    assert hsm_rep.get("released", {}).get("count", 0) > 0
    if store_groups:
        for r in [archived] + purges:
            assert r.evaluator == "policy_scan_mesh", r.fallback_reason
            assert r.fallback_reason == ""
    return archived


def test_lustre_monitoring_end_to_end_with_jax_and_repro_blocked():
    import inspect
    code = (_HEADLINE + inspect.getsource(headline)
            + "\nheadline(fake_clock)\nheadline(Clock(), store_groups=2)\n"
            + "loaded = sorted(m for m in sys.modules\n"
            + "                if m.split('.')[0] in ('jax', 'repro'))\n"
            + "assert not loaded, loaded\nprint('OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "OK"


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_lustre_monitoring_through_the_store(fake_clock, groups):
    rep = headline(fake_clock, store_groups=groups)
    assert rep.evaluator == "policy_scan_mesh" and rep.succeeded == 40
