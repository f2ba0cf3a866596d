"""``tests/core/test_stats.py`` on the port, held against ``repro``.

The O(1) pre-aggregated stats (paper C6): per-user counters maintained
from catalog deltas equal a recomputation from scratch, the async mode
converges, size profiles and top users, the per-job changelog counters
and the directory-usage counters. Each case runs on both packages and
the reports must be equal. The random-operation case runs under
Hypothesis derandomized, with no example database, so every run draws
the same examples.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from torch_pair import both


def _rand_ops(seed, n):
    rng = np.random.default_rng(seed)
    ops = []
    live = set()
    for i in range(n):
        kind = rng.choice(["ins", "upd", "del"])
        if kind == "ins" or not live:
            fid = 1000 + i
            live.add(fid)
            ops.append(("ins", fid, int(rng.integers(0, 10000)),
                        ["a", "b", "c"][rng.integers(0, 3)]))
        elif kind == "upd":
            fid = int(rng.choice(sorted(live)))
            ops.append(("upd", fid, int(rng.integers(0, 10000)), None))
        else:
            fid = int(rng.choice(sorted(live)))
            live.discard(fid)
            ops.append(("del", fid, 0, None))
    return ops


def _incremental(P, seed, n):
    cat = P.Catalog(n_shards=2)
    stats = P.StatsAggregator(cat.strings)
    cat.add_delta_hook(stats.on_delta)
    for kind, fid, size, owner in _rand_ops(seed, n):
        if kind == "ins":
            cat.upsert(P.Entry(fid=fid, name=f"f{fid}", path=f"/f{fid}",
                               type=P.FsType.FILE, size=size, blocks=size,
                               owner=owner))
        elif kind == "upd":
            cat.update_fields(fid, size=size, blocks=size)
        else:
            cat.remove(fid)
    reports = []
    for owner in ("a", "b", "c"):         # ground truth: a full scan
        truth_n = truth_vol = 0
        for e in cat.entries():
            if e.owner == owner:
                truth_n += 1
                truth_vol += e.size
        rep = stats.report_user(owner)
        assert (sum(r["count"] for r in rep),
                sum(r["volume"] for r in rep)) == (truth_n, truth_vol)
        reports.append(rep)
    assert stats.total.count == len(cat)
    return reports, stats.total.count


@settings(max_examples=20, derandomize=True, database=None, deadline=None)
@given(seed=st.integers(0, 500), n=st.integers(1, 120))
def test_incremental_equals_recompute(seed, n):
    both(_incremental, seed, n)


def _async(P):
    cat = P.Catalog(n_shards=2)
    stats = P.StatsAggregator(cat.strings, async_mode=True)
    cat.add_delta_hook(stats.on_delta)
    for fid in range(1, 201):
        cat.upsert(P.Entry(fid=fid, name=f"f{fid}", path=f"/f{fid}",
                           type=P.FsType.FILE, size=10, blocks=10, owner="u"))
    stats.flush()
    rep = stats.report_user("u")
    assert rep[0]["count"] == 200 and rep[0]["volume"] == 2000
    stats.close()
    return rep


def test_async_mode_converges():
    both(_async)


def _profile(P):
    cat = P.Catalog()
    stats = P.StatsAggregator(cat.strings)
    cat.add_delta_hook(stats.on_delta)
    sizes = [0, 10, 100, 2048, 50 << 10, 2 << 20, 2 << 30]
    for i, s in enumerate(sizes):
        cat.upsert(P.Entry(fid=i + 1, name=f"f{i}", path=f"/f{i}",
                           type=P.FsType.FILE, size=s, blocks=s, owner="foo"))
    prof = stats.user_size_profile("foo")
    assert prof["0"] == 1 and prof["1~31"] == 1 and prof["32~1K"] == 1
    assert prof["1K~31K"] == 1 and prof["32K~1M"] == 1
    assert prof["1M~31M"] == 1 and prof["1G~31G"] == 1
    top = stats.top_users(by="volume", k=1)
    assert top[0]["user"] == "foo"
    return prof, top


def test_size_profile_and_top_users():
    both(_profile)


def _per_job(P):
    c = P.ChangelogCounters()
    for i in range(5):
        c.on_record(P.ChangelogRecord(seq=i, type=P.ChangelogType.CREAT,
                                      fid=i, uid="alice", jobid="job1"))
    c.on_record(P.ChangelogRecord(seq=9, type=P.ChangelogType.UNLNK, fid=1,
                                  uid="bob", jobid="job2"))
    snap = c.snapshot()
    assert snap["per_job"]["job1"][int(P.ChangelogType.CREAT)] == 5
    assert snap["per_user"]["bob"][int(P.ChangelogType.UNLNK)] == 1
    assert snap["total"] == 6
    return snap


def test_changelog_counters_per_job():
    both(_per_job)


def _dir_usage(P):
    du = P.DirUsage(max_depth=2)
    du.on_file(+1, "/a/b/c/f1", 100, 100)
    du.on_file(+1, "/a/b/f2", 50, 50)
    du.on_file(+1, "/a/f3", 25, 25)
    seen = [du.du("/a"), du.du("/a/b"), du.du("/")]
    assert seen[0]["volume"] == 175
    assert seen[1]["volume"] == 150
    assert seen[2]["count"] == 3
    du.on_file(-1, "/a/b/f2", 50, 50)
    seen.append(du.du("/a/b"))
    assert seen[3]["volume"] == 100
    return seen


def test_dir_usage_counters():
    both(_dir_usage)
