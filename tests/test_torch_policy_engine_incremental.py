"""``tests/core/test_policy_engine_incremental.py`` on the port, held
against ``repro``.

The incremental match subsystem: dirty-fid sets fed by the changelog
pipeline or a stream subscription, cached match tables, age-flip
scheduling, full-scan fallbacks, and watermark triggers draining exactly
the dirty set. Each case that actions entries runs on both packages over
the same simulated Lustre (``LustreSim`` of each package, same seeds and
operations); the actioned fid sequences and the reports' modes, ``reval``
and totals must be equal. The cases that check only an invariant of the
engine (an explicit incremental run without state raises, a changed
definition resets, two engines keep their own cursors) run on the port.
"""
import threading

import pytest

pytest.importorskip("torch")

from torch_pair import both, port


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.calls = []

    def __call__(self, e, params):
        with self.lock:
            self.calls.append(e.fid)
        return True

    def take(self):
        out, self.calls = self.calls, []
        return out


RULES = [("big", "size > 10k", {"tag": "big"}),
         ("old", "last_access > 500s", {"tag": "old"})]


def _fs_world(P, clock, n=60):
    fs = P.LustreSim(n_mdts=1, clock=clock)
    d = fs.mkdir(fs.root_fid(), "dir")
    fids = []
    for i in range(n):
        f = fs.create(d, f"f{i}", owner=f"user{i % 3}")
        fs.write(f, 500 * (i + 1))
        fids.append(f)
        clock.advance(1.0)
    return fs, d, fids


def _engine(P, cat, clock, action, **kw):
    eng = P.PolicyEngine(cat, clock=clock, **P.dev)
    eng.register(P.PolicyDefinition.from_config(
        name="p", action=action, scope="type == file", rules=RULES,
        mutates=False, **kw))
    return eng


def _oracle_run(P, cat, clock):
    """Fresh engine, full scan — the reference actioned sequence."""
    rec = Recorder()
    r = _engine(P, cat, clock, rec).run("p", matching="full")
    return r, rec.calls


def _totals(r):
    return (r.mode, r.reval, r.matched, r.succeeded, r.volume)


def _piped(P, clock, n=60):
    """(fs, dir, fids, catalog, pipeline) with the pipeline drained."""
    fs, d, fids = _fs_world(P, clock, n)
    cat = P.Catalog()
    pipe = P.EventPipeline(fs, cat, fs.changelog.stream(0),
                           P.PipelineConfig())
    return fs, d, fids, cat, pipe


def _pipeline_churn(P):
    clock = Clock()
    fs, d, fids, cat, pipe = _piped(P, clock)
    rec = Recorder()
    eng = _engine(P, cat, clock, rec)
    eng.subscribe_pipeline(pipe)
    pipe.process_once(100000)

    r1 = eng.run("p")
    assert r1.mode == "full"            # first run: no cached state yet
    first = rec.take()

    # churn: grow one, make one hot, remove one, create one
    clock.advance(10)
    fs.write(fids[0], 100_000)
    fs.read(fids[30])
    fs.unlink(fids[40])
    nf = fs.create(d, "fresh", owner="user0")
    fs.write(nf, 90_000)
    pipe.process_once(100000)

    r2 = eng.run("p")
    assert r2.mode == "incremental"
    assert 0 < r2.reval <= 6            # only the churned entries
    r_full, oracle = _oracle_run(P, cat, clock)
    acted = rec.take()
    assert acted == oracle
    assert (r2.matched, r2.succeeded, r2.volume) == \
        (r_full.matched, r_full.succeeded, r_full.volume)
    return first, _totals(r2), acted


def test_incremental_equals_full_after_pipeline_churn():
    both(_pipeline_churn)


def _time_flip(P):
    clock = Clock()
    fs, d, fids, cat, pipe = _piped(P, clock)
    rec = Recorder()
    eng = _engine(P, cat, clock, rec)
    eng.subscribe_pipeline(pipe)
    pipe.process_once(100000)
    r1 = eng.run("p")
    rec.take()

    # no deltas at all — entries cross the last_access > 500s boundary
    clock.advance(480)                   # some (not all) files become old
    r2 = eng.run("p")
    assert r2.mode == "incremental"
    assert r2.matched > r1.matched       # time alone grew the match set
    _, oracle = _oracle_run(P, cat, clock)
    acted = rec.take()
    assert acted == oracle

    # a quiescent follow-up re-evaluates only newly-due rows
    r3 = eng.run("p")
    assert r3.mode == "incremental" and r3.reval <= 1
    clock.advance(0.5)                   # time moves: boundary entry spent
    eng.run("p")
    r4 = eng.run("p")
    assert r4.reval == 0
    return [_totals(r) for r in (r1, r2, r3, r4)], acted


def test_time_flip_matches_entries_with_zero_deltas():
    both(_time_flip)


def _touched_leaves(P):
    clock = Clock()
    fs, d, fids, cat, pipe = _piped(P, clock)
    rec = Recorder()
    eng = _engine(P, cat, clock, rec)
    eng.subscribe_pipeline(pipe)
    pipe.process_once(100000)
    clock.advance(2000)                  # everything is old now
    r1 = eng.run("p")
    rec.take()
    assert r1.matched == len(fids)

    # atime refreshed via setattr: no longer "old", too small for "big"
    fs.setattr(fids[5], atime=clock())
    pipe.process_once(100000)
    r2 = eng.run("p")
    assert r2.mode == "incremental"
    acted = rec.take()
    assert fids[5] not in acted          # left the cached match set
    _, oracle = _oracle_run(P, cat, clock)
    assert acted == oracle
    return _totals(r2), acted


def test_touched_entry_leaves_match_set():
    both(_touched_leaves)


def test_explicit_incremental_without_state_raises():
    P = port()
    cat = P.Catalog()
    cat.upsert(P.Entry(fid=1, type=P.FsType.FILE, size=50_000))
    eng = _engine(P, cat, Clock(), Recorder())
    with pytest.raises(P.PolicyError):
        eng.run("p", matching="incremental")
    # ... also right after invalidation
    eng.subscribe_pipeline(P.EventPipeline(None, cat, P.ChangelogStream()))
    eng.run("p")
    eng.run("p", matching="incremental")     # now fine
    eng.invalidate("p")
    with pytest.raises(P.PolicyError):
        eng.run("p", matching="incremental")


def test_register_resets_cached_state():
    P = port()
    cat = P.Catalog()
    cat.upsert(P.Entry(fid=1, type=P.FsType.FILE, size=50_000))
    eng = _engine(P, cat, Clock(), Recorder())
    eng.enable_incremental()
    eng.run("p")
    assert eng.run("p").mode == "incremental"
    eng.register(P.PolicyDefinition.from_config(
        name="p", action=Recorder(), scope="type == file",
        rules=[("any", "size > 0", {})], mutates=False))
    assert eng.run("p").mode == "full"       # definition changed: rebuilt


def test_age_equality_predicates_always_full_scan():
    P = port()
    clock = Clock()
    cat = P.Catalog()
    cat.upsert(P.Entry(fid=1, type=P.FsType.FILE, size=50_000,
                       atime=clock()))
    eng = P.PolicyEngine(cat, clock=clock, **P.dev)
    eng.register(P.PolicyDefinition.from_config(
        name="weird", action=Recorder(), scope="true",
        rules=[("exact", "last_access == 500s", {})], mutates=False))
    eng.enable_incremental()
    eng.run("weird")
    assert eng.run("weird").mode == "full"   # no well-defined flip instant
    with pytest.raises(P.PolicyError):
        eng.run("weird", matching="incremental")


def _glob(P):
    clock = Clock()
    fs, d, fids, cat, pipe = _piped(P, clock, n=30)
    rec = Recorder()
    eng = P.PolicyEngine(cat, clock=clock, **P.dev)
    eng.register(P.PolicyDefinition.from_config(
        name="glob", action=rec, scope="type == file",
        rules=[("logs", "path == '/dir/f1*'", {})], mutates=False))
    eng.subscribe_pipeline(pipe)
    pipe.process_once(100000)
    eng.run("glob")
    first = rec.take()
    assert first                              # f1, f10..f19
    nf = fs.create(d, "f1x", owner="u")
    fs.write(nf, 10)
    pipe.process_once(100000)
    r = eng.run("glob")
    assert r.mode == "incremental"
    acted = rec.take()
    assert acted == first + [nf]             # new path matched incrementally
    return _totals(r), acted


def test_incremental_handles_glob_predicates():
    both(_glob)


def _trails_commit(P):
    clock = Clock()
    fs, d, fids = _fs_world(P, clock, n=20)
    cat = P.Catalog()
    stream = fs.changelog.stream(0)
    pipe = P.EventPipeline(fs, cat, stream, P.PipelineConfig())
    rec = Recorder()
    eng = _engine(P, cat, clock, rec)
    eng.subscribe_stream(stream)
    pipe.process_once(100000)
    eng.run("p")
    rec.take()

    fs.write(fids[0], 100_000)
    # the pipeline has NOT processed the record yet: the engine must not
    # consume it (the catalog doesn't reflect it)
    r = eng.run("p")
    assert r.mode == "incremental" and r.reval == 0
    pipe.process_once(100000)                # now committed + acked
    r2 = eng.run("p")
    assert r2.mode == "incremental" and r2.reval == 1
    _, oracle = _oracle_run(P, cat, clock)
    acted = rec.take()
    assert (r2.matched, r2.succeeded) == (len(oracle), len(oracle))
    return _totals(r), _totals(r2), acted


def test_stream_subscription_trails_pipeline_commit_watermark():
    both(_trails_commit)


def _before_subscribe(P):
    """Records emitted but not yet committed when the engine subscribes
    still reach the dirty set once committed."""
    clock = Clock()
    fs, d, fids = _fs_world(P, clock, n=10)
    cat = P.Catalog()
    stream = fs.changelog.stream(0)
    pipe = P.EventPipeline(fs, cat, stream, P.PipelineConfig())
    pipe.process_once(100000)
    fs.write(fids[0], 100_000)             # emitted, NOT committed yet
    rec = Recorder()
    eng = _engine(P, cat, clock, rec)
    eng.subscribe_stream(stream)           # subscribes behind that record
    r1 = eng.run("p")                      # full run on the stale catalog
    assert r1.mode == "full"
    pipe.process_once(100000)              # commit happens after the scan
    r2 = eng.run("p")
    assert r2.mode == "incremental" and r2.reval >= 1
    acted = rec.take()
    _, oracle = _oracle_run(P, cat, clock)
    assert r2.matched == len(oracle)
    return _totals(r1), _totals(r2), acted


def test_stream_subscription_covers_records_emitted_before_subscribe():
    both(_before_subscribe)


def test_two_engines_on_one_stream_get_independent_cursors():
    P = port()
    clock = Clock()
    fs, d, fids = _fs_world(P, clock, n=10)
    cat = P.Catalog()
    stream = fs.changelog.stream(0)
    pipe = P.EventPipeline(fs, cat, stream, P.PipelineConfig())
    pipe.process_once(100000)
    engines = []
    for _ in range(2):
        eng = _engine(P, cat, clock, Recorder())
        eng.subscribe_stream(stream)
        eng.run("p")
        engines.append(eng)
    fs.write(fids[0], 100_000)
    pipe.process_once(100000)
    for eng in engines:                    # neither steals the delta
        r = eng.run("p")
        assert r.mode == "incremental" and r.reval == 1


def _large_dirty(P):
    clock = Clock()
    cat = P.Catalog()
    for i in range(100):
        cat.upsert(P.Entry(fid=i + 1, type=P.FsType.FILE, size=50_000))
    rec = Recorder()
    eng = _engine(P, cat, clock, rec)
    eng.enable_incremental()
    eng.run("p")
    eng.mark_dirty(range(1, 101))            # 100% churn: scan is cheaper
    r = eng.run("p")
    assert r.mode == "full"
    eng.mark_dirty([1, 2, 3])
    r2 = eng.run("p")
    assert r2.mode == "incremental"
    return _totals(r), _totals(r2), rec.take()


def test_auto_falls_back_to_full_on_large_dirty_set():
    both(_large_dirty)


def test_failed_rebuild_never_leaves_valid_empty_cache():
    """A raise during the full-scan rebuild (a bogus sort_by) must not
    mark the cache valid, or later auto runs would match nothing."""
    P = port()
    cat = P.Catalog()
    for i in range(30):
        cat.upsert(P.Entry(fid=i + 1, type=P.FsType.FILE, size=50_000))
    rec = Recorder()
    eng = P.PolicyEngine(cat, clock=Clock(), **P.dev)
    eng.register(P.PolicyDefinition.from_config(
        name="p", action=rec, scope="type == file",
        rules=[("any", "size > 0", {})], sort_by="bogus", mutates=False))
    eng.enable_incremental()
    with pytest.raises(KeyError):
        eng.run("p")
    with pytest.raises(KeyError):
        eng.run("p")                       # still full scan + raise: never
    with pytest.raises(P.PolicyError):     # a silent empty incremental run
        eng.run("p", matching="incremental")
    eng.register(P.PolicyDefinition.from_config(
        name="p", action=rec, scope="type == file",
        rules=[("any", "size > 0", {})], sort_by="atime", mutates=False))
    r = eng.run("p")                       # recovers with a full scan
    assert r.mode == "full" and r.matched == 30
    assert eng.run("p").mode == "incremental"


def _mutating(P):
    """purge-style plugin: removes entries from the catalog directly."""
    cat = P.Catalog()
    for i in range(40):
        cat.upsert(P.Entry(fid=i + 1, type=P.FsType.FILE,
                           size=20_000 if i % 2 else 100))
    eng = P.PolicyEngine(cat, clock=Clock(), **P.dev)
    purged = []

    def purge(e, params):
        cat.remove(e.fid)
        purged.append(e.fid)
        return True

    eng.register(P.PolicyDefinition.from_config(
        name="purge", action=purge, scope="type == file",
        rules=[("big", "size > 10k", {})]))     # mutates=True default
    eng.enable_incremental()
    r1 = eng.run("purge")
    assert r1.succeeded == 20 and len(cat) == 20
    # half the catalog is dirty, so auto would full-rescan; force the path
    r2 = eng.run("purge", matching="incremental")
    assert r2.matched == 0                   # cache dropped the purged fids
    assert r2.reval == 20                    # actioned fids re-observed
    return _totals(r1), _totals(r2), sorted(purged)


def test_mutating_action_reobserved_next_run():
    both(_mutating)


# -- watermark triggers over the incremental path ------------------------------

def _drain(P, n_threads):
    """A high->low watermark crossing drains exactly the dirty entries that
    still match, stops on the budget boundary, and actions an identical
    set regardless of thread count."""
    clock = Clock()
    cat = P.Catalog()
    for i in range(400):
        cat.upsert(P.Entry(fid=i + 1, type=P.FsType.FILE, size=1_000,
                           ost_idx=0, atime=clock() - (i + 1)))
    freed = [0]
    lock = threading.Lock()
    acted = []

    def act(e, params):
        with lock:
            freed[0] += e.size
            acted.append(e.fid)
        return True

    eng = P.PolicyEngine(cat, clock=clock, **P.dev)
    eng.register(P.PolicyDefinition.from_config(
        name="p", action=act, scope="type == file",
        rules=[("big", "size > 10k", {})],
        n_threads=n_threads, batch_size=16, mutates=False))
    capacity = 1_000_000
    used0 = 900_000
    eng.add_watermark_trigger("p", P.UsageWatermarkTrigger(
        usage_fn=lambda: [("ost0", used0 - freed[0], capacity)],
        high_pct=85.0, low_pct=60.0,
        restrict_fn=lambda key: P.parse_expr("ost_idx == 0")))
    eng.enable_incremental()
    r0 = eng.run("p")
    assert r0.matched == 0                    # nothing big yet; cache primed

    # dirty exactly 80 entries (20%, under the auto rescan threshold)
    dirty = list(range(1, 81))
    cat.update_fields_batch(dirty, size=20_000)
    eng.mark_dirty(dirty)

    reports = eng.check_triggers()
    assert len(reports) == 1
    r = reports[0]
    assert r.mode == "incremental"
    assert r.reval == len(dirty)              # drained exactly the dirty set
    target = used0 - int(capacity * 0.60)
    assert target <= r.volume < target + 20_000   # budget boundary
    # deterministic plan: LRU prefix of the dirty set, fid tie-break
    exp = sorted(dirty, key=lambda f: (clock.t - f, f))
    k = vol = 0
    while vol < target:
        vol += 20_000
        k += 1
    assert sorted(acted) == sorted(exp[:k])
    assert r.succeeded == k
    assert not eng.check_triggers()           # back under the high watermark
    return _totals(r), sorted(acted)


@pytest.mark.parametrize("n_threads", [1, 4, 8])
def test_watermark_drains_dirty_set_to_budget_deterministically(n_threads):
    both(_drain, n_threads)
