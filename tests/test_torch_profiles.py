"""ProfileCube, StatsAggregator and Reports: the port against the JAX package.

The cases of ``tests/core/test_profiles.py``, each run on both packages on
the same entries (the same seeded mutation sequence goes into a ``repro``
catalog and a ``repro_torch`` one, so string codes, shard routing and
group ids agree). Every port cube must hold its own scalar oracle and
return report dicts equal to ``repro``'s. The port's kernel rebuild runs on
``device="cpu"``, where the ``profile_cube`` op is its plain PyTorch
version; ``repro``'s runs its Pallas kernel in interpret mode. Sizes are
the reference's f32-exact ones, so the kernel rebuilds are exact too.
Saved cube state loads across the two packages both ways.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as J
import repro_torch.core as T

NOW = 1_700_000_000.0

SIZES = [0, 1, 31, 100, 2048, 50 << 10, 1 << 20, 1 << 25, 1 << 30,
         1 << 35, 1 << 41]
OWNERS = [f"u{i}" for i in range(6)]
GROUPS = [f"g{i}" for i in range(3)]
PKGS = (J, T)


class _Clock:
    def __init__(self, t=NOW):
        self.t = t

    def __call__(self):
        return self.t


def _cube(pkg, cat, clock, **kw):
    """ProfileCube of ``pkg``; the port's runs its op on the CPU."""
    if pkg is T:
        kw["device"] = "cpu"
    return pkg.ProfileCube(cat, clock=clock, **kw)


def _rand_entry(pkg, rng, fid):
    return pkg.Entry(
        fid=fid, name=f"f{fid}", path=f"/d{fid % 5}/f{fid}",
        type=pkg.FsType(int(rng.integers(0, 3))),
        size=int(rng.choice(SIZES)), blocks=int(rng.integers(0, 4096)),
        owner=str(rng.choice(OWNERS)), group=str(rng.choice(GROUPS)),
        hsm_state=pkg.HsmState(int(rng.integers(0, 5))),
        atime=NOW - float(rng.uniform(-10, 400 * 86400)))


def _build(pkg, seed, n=600, n_shards=3, churn=0.2):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    cat = pkg.Catalog(n_shards=n_shards)
    scalar = pkg.StatsAggregator(cat.strings)
    cat.add_delta_hook(scalar.on_delta)
    cube = _cube(pkg, cat, clock).attach()          # incremental from empty
    for i in range(n):
        cat.upsert(_rand_entry(pkg, rng, i + 1))
    for fid in (rng.choice(n, int(n * churn), replace=False) + 1).tolist():
        if fid % 3 == 0:
            cat.remove(fid)
        else:
            cat.update_fields(fid, size=int(rng.choice(SIZES)),
                              atime=NOW - float(rng.uniform(0, 100 * 86400)))
    return cat, scalar, cube, clock


def _both(seed, **kw):
    return [_build(pkg, seed, **kw) for pkg in PKGS]


def _reports(src):
    """Every rbh-report surface of a cube / aggregator as one dict."""
    out = {"types": src.report_types(), "hsm": src.report_hsm(),
           "top": sorted((d["user"], d["count"], d["volume"], d["spc_used"])
                         for d in src.top_users(k=100))}
    for u in OWNERS:
        out[f"user:{u}"] = src.report_user(u)
        out[f"size:{u}"] = src.user_size_profile(u)
    for g in GROUPS:
        out[f"group:{g}"] = src.report_group(g)
    return out


def _cube_reports(cube, now=None):
    out = _reports(cube)
    out["age"] = cube.age_profile(now=now)
    out["totals"] = cube.totals()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incremental_cube_matches_oracle_and_jax(seed):
    (_jc, jscalar, jcube, _), (_tc, tscalar, tcube, _) = _both(seed)
    assert _reports(tcube) == _reports(tscalar)
    assert tcube.totals()[0] == tscalar.total.count
    assert _cube_reports(tcube) == _cube_reports(jcube)
    assert _reports(tscalar) == _reports(jscalar)
    np.testing.assert_array_equal(tcube.cube(), jcube.cube())


@pytest.mark.parametrize("seed", [0, 3])
def test_host_and_kernel_rebuild_match_incremental_and_jax(seed):
    built = _both(seed)
    got = {}
    for pkg, (cat, scalar, cube, clock) in zip(PKGS, built):
        host = _cube(pkg, cat, clock)
        host.rebuild(use_kernel=False)
        kern = _cube(pkg, cat, clock)
        kern.rebuild(use_kernel=True)   # port: the plain version on the CPU
        assert _reports(host) == _reports(scalar)
        assert _reports(kern) == _reports(scalar)
        assert _cube_reports(kern) == _cube_reports(cube)
        got[pkg] = (host.cube(), kern.cube())
    for t, j in zip(got[T], got[J]):
        np.testing.assert_array_equal(t, j)


def test_age_rollover_matches_fresh_rebuild_and_jax():
    built = _both(4, n=300)
    profiles = {}
    for pkg, (cat, _scalar, cube, clock) in zip(PKGS, built):
        base = cube.age_profile(now=clock.t)
        seq = []
        for dt in (3600.0, 86400.0, 7 * 86400.0 + 1, 300 * 86400.0):
            at = NOW + dt
            fresh = _cube(pkg, cat, _Clock(at))
            fresh.rebuild(use_kernel=False)
            assert cube.age_profile(now=at) == fresh.age_profile(now=at)
            seq.append(cube.age_profile(now=at))
        assert cube.rollovers > 0
        end = cube.age_profile(now=NOW + 300 * 86400.0)
        assert sum(d["volume"] for d in end.values()) == \
            sum(d["volume"] for d in base.values())
        profiles[pkg] = (seq, cube.rollovers)
    assert profiles[T] == profiles[J]


def test_statsaggregator_rebuilt_on_cube_matches_jax():
    got = {}
    for pkg in PKGS:
        clock = _Clock()
        cat = pkg.Catalog(n_shards=2)
        oracle = pkg.StatsAggregator(cat.strings)
        cat.add_delta_hook(oracle.on_delta)
        cube = _cube(pkg, cat, clock)
        cube_stats = pkg.StatsAggregator(cat.strings, cube=cube)
        cat.add_delta_hook(cube_stats.on_delta)
        rng = np.random.default_rng(5)
        for i in range(200):
            cat.upsert(_rand_entry(pkg, rng, i + 1))
        cat.remove(7)
        assert _reports(cube_stats) == _reports(oracle)
        total = cube_stats.total
        assert (total.count, total.volume) == (oracle.total.count,
                                               oracle.total.volume)
        rep = pkg.Reports(cat, stats=None, profiles=cube, clock=clock)
        assert rep.report_user("u1") == oracle.report_user("u1")
        assert "u1" in rep.format_user_report("u1")
        assert sum(d["count"] for d in rep.age_profile().values()) == \
            oracle.total.count
        got[pkg] = (_reports(cube_stats), rep.format_user_report("u1"),
                    rep.age_profile(), (total.count, total.volume,
                                        total.spc_used))
    assert got[T] == got[J]


def test_persistence_and_trend_roundtrip_match_jax(tmp_path):
    got = {}
    for pkg, (cat, scalar, cube, clock) in zip(PKGS, _both(6, n=250)):
        d = tmp_path / pkg.__name__
        path = str(d / "cat.db.profiles.npz")
        cube.save(path)
        restored = _cube(pkg, cat, clock).attach(resume=True, path=path)
        assert _reports(restored) == _reports(scalar)
        cat.update_fields(11, size=1 << 20, atime=NOW)
        later = NOW + 40 * 86400.0
        fresh = _cube(pkg, cat, _Clock(later))
        fresh.rebuild(use_kernel=False)
        assert restored.age_profile(now=later) == fresh.age_profile(now=later)
        tpath = str(d / "trend.npz")
        cube.record_trend(tpath, now=NOW)
        cube.record_trend(tpath, now=NOW + 60.0)
        series = pkg.ProfileCube.load_trend(tpath)
        assert series["time"].shape == (2,)
        assert int(series["count"][0]) == cube.totals()[0]
        assert series["age_volume"].shape[1] == len(pkg.AGE_PROFILE_EDGES)
        assert not _cube(pkg, cat, clock).load(str(d / "no.npz"))
        assert not _cube(pkg, pkg.Catalog(n_shards=4), clock).load(path)
        got[pkg] = (restored.age_profile(now=later), series)
    assert got[T][0] == got[J][0]
    assert got[T][1].keys() == got[J][1].keys()
    for k in got[T][1]:
        np.testing.assert_array_equal(got[T][1][k], got[J][1][k])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_saved_cube_loads_across_packages(tmp_path, direction):
    """``ProfileCube.save`` of either package loads into the other's
    ``ProfileCube.load``: equal cubes, equal reports, and the restored cube
    keeps folding deltas like the saver's."""
    built = dict(zip(PKGS, _both(7, n=300)))
    src, dst = (J, T) if direction == "jax_to_port" else (T, J)
    cat_s, _sc, cube_s, clock = built[src]
    cat_d, scalar_d, _cd, _ = built[dst]
    path = str(tmp_path / "cube.profiles.npz")
    cube_s.save(path)
    restored = _cube(dst, cat_d, clock)
    assert restored.load(path)
    np.testing.assert_array_equal(restored.cube(), cube_s.cube())
    assert _cube_reports(restored) == _cube_reports(cube_s)
    assert _reports(restored) == _reports(scalar_d)
    cat_d.add_delta_hook(restored.on_delta, batch=restored.on_delta_batch)
    for cat in (cat_s, cat_d):
        cat.update_fields(12, size=1 << 30, atime=NOW - 10.0)
        cat.remove(13)
    np.testing.assert_array_equal(restored.cube(), cube_s.cube())


def test_kernel_rebuild_with_skewed_shard_groups_matches_jax():
    got = {}
    for pkg in PKGS:
        clock = _Clock()
        cat = pkg.Catalog(n_shards=2)
        oracle = pkg.StatsAggregator(cat.strings)
        cat.add_delta_hook(oracle.on_delta)
        for i in range(40):
            fid = 2 * i + 2
            cat.upsert(pkg.Entry(fid=fid, name=f"e{fid}", path=f"/e{fid}",
                                 type=pkg.FsType.FILE, size=1000, blocks=1,
                                 owner=f"u{i % 20}", atime=NOW - 50))
        cat.upsert(pkg.Entry(fid=1, name="o", path="/o", type=pkg.FsType.FILE,
                             size=2000, blocks=2, owner="u0", atime=NOW - 50))
        cube = _cube(pkg, cat, clock, use_kernel=True)
        cube.rebuild()
        assert cube.report_user("u0") == oracle.report_user("u0")
        assert cube.totals()[0] == oracle.total.count
        got[pkg] = cube.cube()
    np.testing.assert_array_equal(got[T], got[J])


def test_kernel_rebuild_exact_at_bucket_boundaries_matches_jax():
    boundary_sizes = [(1 << 30) - 1, (1 << 20) - 1, (32 << 20) - 1,
                      (1 << 40) - 1]
    year = 365 * 86400.0
    got = {}
    for pkg in PKGS:
        clock = _Clock()
        cat = pkg.Catalog(n_shards=2)
        oracle = pkg.StatsAggregator(cat.strings)
        cat.add_delta_hook(oracle.on_delta)
        for i, size in enumerate(boundary_sizes):
            cat.upsert(pkg.Entry(fid=i + 1, name=f"b{i}", path=f"/b{i}",
                                 type=pkg.FsType.FILE, size=size, blocks=1,
                                 owner=f"edge{i}", atime=NOW - (year - 1.0)))
        kern = _cube(pkg, cat, clock, use_kernel=True)
        kern.rebuild()
        for i in range(len(boundary_sizes)):
            u = f"edge{i}"
            assert kern.user_size_profile(u) == oracle.user_size_profile(u)
            ks = [(d["count"], d["spc_used"], d["type"])
                  for d in kern.report_user(u)]
            os_ = [(d["count"], d["spc_used"], d["type"])
                   for d in oracle.report_user(u)]
            assert ks == os_, u
        assert kern.age_profile()["+1y"]["count"] == 0
        before = _cube_reports(kern)
        cat.add_delta_hook(kern.on_delta)
        cat.remove(1)
        assert kern.report_user("edge0") == oracle.report_user("edge0") == []
        assert (kern.cube()[0] >= 0).all()
        got[pkg] = (before, _cube_reports(kern))
    assert got[T] == got[J]


def test_single_delta_feed_guard_like_jax():
    for pkg in PKGS:
        cat = pkg.Catalog(n_shards=2)
        cube = _cube(pkg, cat, _Clock()).attach()
        with pytest.raises(ValueError):
            pkg.StatsAggregator(cat.strings, cube=cube)
        with pytest.raises(ValueError):
            cube.attach()
        cube2 = _cube(pkg, cat, _Clock())
        pkg.StatsAggregator(cat.strings, cube=cube2)
        with pytest.raises(ValueError):
            cube2.attach()


def test_port_cube_defaults_to_the_card(monkeypatch):
    """``ProfileCube`` resolves its device at construction: the default is
    the CUDA card, and without one it raises instead of running the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = T.Catalog(n_shards=2)
    with pytest.raises(RuntimeError):
        T.ProfileCube(cat, use_kernel=True)
    with pytest.raises(RuntimeError):
        T.ProfileCube(cat)
    assert T.ProfileCube(cat, device="cpu").device == torch.device("cpu")


def test_mutation_sequence_with_exact_boundary_instants_matches_jax():
    ops = [("ins", 0, 5, 10.0), ("ins", 1, 8, 3600.0), ("edge", 0, 0, 0.0),
           ("tick", 0, 0, 86400.0), ("upd", 1, 3, 0.0), ("edge", 3, 0, 0.0),
           ("del", 0, 0, 0.0), ("ins", 2, 9, 40 * 86400.0),
           ("edge", 2, 0, 0.0), ("tick", 0, 0, 400 * 86400.0)]
    got = {}
    for pkg in PKGS:
        clock = _Clock()
        cat = pkg.Catalog(n_shards=2)
        scalar = pkg.StatsAggregator(cat.strings)
        cat.add_delta_hook(scalar.on_delta)
        cube = _cube(pkg, cat, clock).attach()
        live = set()
        for kind, fseed, sizei, dt in ops:
            fid = 100 + fseed
            if kind == "ins" or (kind in ("upd", "del") and not live):
                live.add(fid)
                cat.upsert(pkg.Entry(
                    fid=fid, name=f"f{fid}", path=f"/p/f{fid}",
                    type=pkg.FsType(fid % 3), size=SIZES[sizei],
                    blocks=SIZES[sizei], owner=OWNERS[fid % len(OWNERS)],
                    group=GROUPS[fid % len(GROUPS)], atime=clock.t - dt))
            elif kind == "upd":
                fid = sorted(live)[fseed % len(live)]
                cat.update_fields(fid, size=SIZES[sizei], atime=clock.t - dt)
            elif kind == "del":
                fid = sorted(live)[fseed % len(live)]
                live.discard(fid)
                cat.remove(fid)
            elif kind == "tick":
                clock.t += dt
            elif live:
                e = cat.get(sorted(live)[fseed % len(live)])
                if e is not None:
                    edge = pkg.AGE_PROFILE_EDGES[
                        fseed % len(pkg.AGE_PROFILE_EDGES)]
                    clock.t = max(clock.t, e.atime + edge)
        fresh = _cube(pkg, cat, clock)
        fresh.rebuild(use_kernel=False)
        assert _reports(cube) == _reports(scalar) == _reports(fresh)
        assert _cube_reports(cube) == _cube_reports(fresh)
        got[pkg] = _cube_reports(cube)
    assert got[T] == got[J]
