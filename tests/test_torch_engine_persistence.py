"""``tests/core/test_engine_persistence.py`` on the port, held against
``repro``.

An engine restart resumes incrementally: the match table, the age-flip
schedule and the undrained dirty fids are saved beside the catalog and
loaded by a fresh engine. Each case runs on both packages, each in a
directory of its own, from the same catalog; the reports of the resumed
runs and of the full-scan oracle must be equal, and the port's saved
state must hold the same arrays as the reference's.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_pair import both, port

NOW = 1_000_000.0


def _catalog(P, n=400, db_path=None):
    cat = P.Catalog(n_shards=2, db_path=db_path)
    cat.upsert_batch([
        P.Entry(fid=i + 1, name=f"f{i}", path=f"/p/f{i}", type=P.FsType.FILE,
                size=(i % 40 + 1) * 1000, blocks=i % 40 + 1,
                owner=f"user{i % 3}", atime=NOW - float(i + 1))
        for i in range(n)])
    return cat


def _engine(P, cat, clock, rules=None, name="p"):
    eng = P.PolicyEngine(cat, clock=clock, **P.dev)
    eng.register(P.PolicyDefinition.from_config(
        name=name, action=lambda e, p: True, scope="type == file",
        rules=rules or [("old", "last_access > 100s", {})],
        sort_by="atime", mutates=False))
    return eng


class _Clock:
    def __init__(self, t=NOW):
        self.t = t

    def __call__(self):
        return self.t


def _totals(r):
    return (r.mode, r.reval, r.matched, r.succeeded, r.volume)


def _saved(path):
    """The arrays of a saved state, as lists (keys sorted)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k].tolist() for k in sorted(z.files)}


def _roundtrip(P, tmp_path):
    path = str(tmp_path / f"{P.name}.npz")
    cat = _catalog(P)
    clock = _Clock()
    eng = _engine(P, cat, clock)
    eng.enable_incremental()
    assert eng.run("p").mode == "full"          # prime the cache
    assert eng.save_incremental(path) == path
    saved = _saved(path)

    # churn while the engine is "down"
    cat.update_fields(3, atime=NOW)             # young again -> unmatches
    cat.remove(7)
    cat.upsert(P.Entry(fid=9000, name="n", path="/p/n", type=P.FsType.FILE,
                       size=5000, atime=NOW - 900))

    eng2 = _engine(P, cat, clock)
    assert eng2.load_incremental(path) == ["p"]
    eng2.mark_dirty([3, 7, 9000])               # re-delivered deltas
    clock.t = NOW + 50
    r = eng2.run("p", matching="incremental")   # NO cold full scan
    assert r.mode == "incremental"
    assert r.reval < len(cat)

    r_full = _engine(P, cat, _Clock(NOW + 50)).run("p")
    assert r_full.mode == "full"
    assert (r.matched, r.succeeded, r.volume) == \
        (r_full.matched, r_full.succeeded, r_full.volume)
    return saved, _totals(r), _totals(r_full)


def test_save_load_roundtrip_resumes_incrementally(tmp_path):
    both(_roundtrip, tmp_path)


def _flip_schedule(P, tmp_path):
    """Age flips due after the restart still fire without any delta."""
    path = str(tmp_path / f"{P.name}.npz")
    cat = _catalog(P, 50)
    clock = _Clock()
    eng = _engine(P, cat, clock)
    eng.enable_incremental()
    r0 = eng.run("p")
    eng.save_incremental(path)

    eng2 = _engine(P, cat, clock)
    assert eng2.load_incremental(path) == ["p"]
    clock.t = NOW + 80                    # ages 21..50 cross the 100s line
    r = eng2.run("p", matching="incremental")
    assert r.mode == "incremental"
    r_full = _engine(P, cat, clock).run("p")
    assert r.matched == r_full.matched > r0.matched
    return _totals(r0), _totals(r), _totals(r_full)


def test_flip_schedule_survives_restart(tmp_path):
    both(_flip_schedule, tmp_path)


def test_changed_definition_is_not_resumed(tmp_path):
    P = port()
    path = str(tmp_path / "state.npz")
    cat = _catalog(P)
    eng = _engine(P, cat, _Clock())
    eng.enable_incremental()
    eng.run("p")
    eng.save_incremental(path)

    changed = _engine(P, cat, _Clock(),
                      rules=[("old", "last_access > 999s", {})])
    assert changed.load_incremental(path) == []     # signature mismatch
    assert changed.run("p").mode == "full"          # safe cold start


def test_unregistered_policy_and_missing_file(tmp_path):
    P = port()
    path = str(tmp_path / "state.npz")
    cat = _catalog(P, 50)
    eng = _engine(P, cat, _Clock())
    assert eng.load_incremental(path) == []         # missing file: no-op
    eng.enable_incremental()
    eng.run("p")
    eng.save_incremental(path)
    other = P.PolicyEngine(cat, clock=_Clock(), **P.dev)
    other.register(P.PolicyDefinition.from_config(
        name="q", action=lambda e, p: True, scope="true", mutates=False))
    assert other.load_incremental(path) == []       # "p" not registered


def _undrained(P, tmp_path):
    path = str(tmp_path / f"{P.name}.npz")
    cat = _catalog(P, 60)
    clock = _Clock()
    eng = _engine(P, cat, clock)
    eng.enable_incremental()
    eng.run("p")
    cat.update_fields(5, atime=NOW)
    eng.mark_dirty([5])                   # noted but never drained by a run
    eng.save_incremental(path)

    eng2 = _engine(P, cat, clock)
    eng2.load_incremental(path)
    r = eng2.run("p", matching="incremental")
    assert r.reval >= 1                   # fid 5 was re-evaluated
    r_full = _engine(P, cat, clock).run("p")
    assert r.matched == r_full.matched
    return _saved(path), _totals(r), _totals(r_full)


def test_undrained_dirty_fids_survive(tmp_path):
    both(_undrained, tmp_path)


def test_default_path_requires_db_or_explicit(tmp_path):
    P = port()
    cat = _catalog(P, 10)
    eng = _engine(P, cat, _Clock())
    eng.enable_incremental()
    eng.run("p")
    with pytest.raises(P.PolicyError):
        eng.save_incremental()            # no sqlite mirror, no path
    db = str(tmp_path / "cat.sqlite")
    cat2 = _catalog(P, 10, db_path=db)
    eng2 = _engine(P, cat2, _Clock())
    eng2.enable_incremental()
    eng2.run("p")
    out = eng2.save_incremental()
    assert out == db + ".incstate.npz" and os.path.exists(out)
