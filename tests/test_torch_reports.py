"""Reports host paths and ``subject=`` scoping: the port against the JAX
package.

The cases of ``tests/core/test_reports.py`` that run on the host (find,
du, du_many, the per-shard path index, DirUsage's deep queries, the O(1)
user report) and ``subject=`` scoping through the copied ``GrantTable``,
each on both packages. ``repro``'s catalog is filled by its ``Scanner``
over a ``LustreSim`` tree; the port's gets the same entries, in the same
order, through its own ``Entry`` and ``upsert`` (with the port's hooks
attached first), so both see the same deltas.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as J
import repro_torch.core as T
from repro.fs import LustreSim

NOW = 1_700_000_000.0


def _fs():
    fs = LustreSim(n_osts=4)
    fs.define_pool("ssd", (0, 1))
    fs.define_pool("hdd", (2, 3))
    proj = fs.mkdir(fs.root_fid(), "proj")
    logs = fs.mkdir(proj, "logs")
    for i in range(10):
        f = fs.create(proj, f"data{i}.tar", owner="foo", pool="ssd")
        fs.write(f, (i + 1) * 1000)
    for i in range(5):
        f = fs.create(logs, f"log{i}.txt", owner="bar", pool="hdd")
        fs.write(f, 10)
    return fs


def _port_entry(e):
    kw = {f.name: getattr(e, f.name) for f in dataclasses.fields(e)}
    kw["type"] = T.FsType(int(e.type))
    kw["hsm_state"] = T.HsmState(int(e.hsm_state))
    kw["xattrs"] = dict(e.xattrs)
    return T.Entry(**kw)


def _catalogs(n_shards=4, stats=False):
    """(pkg, catalog, stats or None) for both packages, same entries."""
    ref = J.Catalog(n_shards=n_shards)
    jstats = None
    if stats:
        jstats = J.StatsAggregator(ref.strings)
        ref.add_delta_hook(jstats.on_delta)
    J.Scanner(_fs(), ref).scan()
    port = T.Catalog(n_shards=n_shards)
    tstats = None
    if stats:
        tstats = T.StatsAggregator(port.strings)
        port.add_delta_hook(tstats.on_delta)
    for e in sorted(ref.entries(), key=lambda e: e.fid):
        port.upsert(_port_entry(e))
    return [(J, ref, jstats), (T, port, tstats)]


def _fid_of(cat, path):
    return [e for e in cat.entries() if e.path == path][0].fid


def test_find_and_du_match_jax():
    got = {}
    for pkg, cat, stats in _catalogs(stats=True):
        rep = pkg.Reports(cat, stats)
        tars = rep.find("path == '/proj/*.tar' and size > 5000")
        assert len(tars) == 5
        assert len(rep.find("owner == 'bar'")) == 5
        du = rep.du("/proj/logs")
        assert du["files"] == 5 and du["volume"] == 50
        assert rep.du("/proj")["files"] == 15
        top = rep.top_files(k=3)
        assert top[0]["size"] == 10000.0
        assert rep.top_dirs_by_count(1)[0]["children"] >= 10
        got[pkg] = (sorted(tars), sorted(rep.find("owner == 'bar'")), du,
                    rep.du("/proj"),
                    [(d["path"], d["size"]) for d in top],
                    [(d["path"], d["children"])
                     for d in rep.top_dirs_by_count(3)],
                    [(d["path"], d["atime"]) for d in rep.oldest_files(k=4)])
    assert got[T] == got[J]


def test_du_index_tracks_catalog_churn_like_jax():
    got = {}
    for pkg, cat, _ in _catalogs():
        rep = pkg.Reports(cat)
        before = rep.du("/proj/logs")
        assert before["files"] == 5 and before["volume"] == 50
        log0 = _fid_of(cat, "/proj/logs/log0.txt")
        cat.update_fields(log0, size=1000)
        assert rep.du("/proj/logs")["volume"] == 50 - 10 + 1000
        cat.remove(log0)
        after = rep.du("/proj/logs")
        assert after["files"] == 4 and after["volume"] == 40
        many = rep.du_many(["/proj", "/proj/logs", "/nope"])
        assert many[0] == rep.du("/proj")
        assert many[1] == after
        assert many[2] == {"count": 0, "files": 0, "volume": 0,
                           "spc_used": 0}
        assert rep.du("/proj/lo")["count"] == 0
        got[pkg] = (before, after, many)
    assert got[T] == got[J]


def test_path_index_rebuilds_only_churned_shards_like_jax():
    got = {}
    for pkg in (J, T):
        cat = pkg.Catalog(n_shards=4)
        for i in range(1, 41):
            cat.upsert(pkg.Entry(fid=i, name=f"f{i}", path=f"/a/f{i}",
                                 type=pkg.FsType.FILE, size=100, blocks=100))
        rep = pkg.Reports(cat)
        seen = [rep.du("/a")["files"], rep.index_rebuilds]
        rep.du("/a")
        seen.append(rep.index_rebuilds)
        cat.update_fields(8, size=999)
        seen += [rep.du("/a")["volume"], rep.index_rebuilds]
        cat.remove(9)
        out = rep.du_many(["/a", "/nope"])
        seen += [out, rep.index_rebuilds]
        assert seen[:3] == [40, 4, 4] and seen[3:5] == [39 * 100 + 999, 5]
        assert seen[6] == 6
        got[pkg] = seen
    assert got[T] == got[J]


def test_dir_usage_deep_queries_route_to_path_index_like_jax():
    paths = ["/a/b/c/d/f1", "/a/b/c/f2", "/a/f3"]
    got = {}
    for pkg in (J, T):
        cat = pkg.Catalog(n_shards=2)
        du = pkg.DirUsage(max_depth=2)
        for i, p in enumerate(paths):
            cat.upsert(pkg.Entry(fid=i + 1, name=p.rsplit("/", 1)[1], path=p,
                                 type=pkg.FsType.FILE, size=100, blocks=50))
            du.on_file(+1, p, 100, 50)
        rep = pkg.Reports(cat)
        rep.bind_dir_usage(du)
        assert du.du("/a")["count"] == 3
        deep = du.du("/a/b/c")
        assert deep["count"] == 2 and deep["volume"] == 200
        assert deep["volume"] == rep.du("/a/b/c")["volume"]
        assert du.du("/a/b/c/d")["count"] == 1
        with pytest.raises(ValueError):
            pkg.DirUsage(max_depth=2).du("/a/b/c")
        got[pkg] = (du.du("/a"), deep, du.du("/a/b/c/d"), du.du("/"))
    assert got[T] == got[J]


def test_report_user_o1_matches_scan_like_jax():
    got = {}
    for pkg, cat, stats in _catalogs(stats=True):
        rep = pkg.Reports(cat, stats)
        rows = rep.report_user("foo")
        files = [r for r in rows if r["type"] == "file"][0]
        assert files["count"] == 10
        assert files["volume"] == sum((i + 1) * 1000 for i in range(10))
        txt = rep.format_user_report("foo")
        assert "foo" in txt and "file" in txt
        got[pkg] = (rows, rep.report_user("bar"), rep.report_types(),
                    rep.report_hsm(), rep.top_users(k=5), txt)
    assert got[T] == got[J]


def _grants(pkg):
    g = pkg.GrantTable()
    g.add_subject("foo")                            # owns the tars
    g.add_subject("auditor", owners=(), subtrees=("/proj/logs",))
    g.add_subject("ops", owners=("bar",), groups=("root",))
    return g


@pytest.mark.parametrize("subject", ["foo", "auditor", "ops"])
def test_subject_scoping_through_grants_matches_jax(subject):
    """``subject=`` on the host folds and the profile cube's scoped fold:
    equal answers on both packages, and the scoped cube equal to the host
    groupby over the subject's visible rows."""
    got = {}
    for pkg, cat, _ in _catalogs():
        grants = _grants(pkg)
        kw = {"device": "cpu"} if pkg is T else {}
        cube = pkg.ProfileCube(cat, clock=lambda: NOW, **kw).attach()
        cube.attach_grants(grants)
        rep = pkg.Reports(cat, profiles=cube, clock=lambda: NOW)
        rep.attach_grants(grants)
        vis = grants.visible_mask(subject, cat.arrays(), cat.strings)
        found = rep.find("type == file", subject=subject)
        assert len(found) == int((vis & (cat.arrays()["type"] == 0)).sum())
        got[pkg] = (
            vis.sum(), sorted(found), rep.du("/proj", subject=subject),
            rep.du_many(["/proj/logs", "/"], subject=subject),
            [(d["path"], d["size"])
             for d in rep.top_files(k=4, subject=subject)],
            rep.report_user("foo", subject=subject),
            rep.report_types(subject=subject),
            rep.top_users(by="count", k=3, subject=subject),
            rep.age_profile(subject=subject),
            cube.cube(now=NOW, subject=subject).tolist())
    assert got[T] == got[J]
    with pytest.raises(KeyError):
        _grants(T).visible_mask("nobody", {"owner": np.zeros(1),
                                           "group": np.zeros(1)}, None)


# -- the plugin, alert and rmdir cases of tests/core/test_reports.py ----------
# Each runs on both packages over each package's own LustreSim (the
# plugins act on that file system) and returns what it observed.

def _sim(pkg):
    from repro_torch.fs import LustreSim as TLustreSim
    return LustreSim if pkg is J else TLustreSim


def _pkg_fs(pkg):
    """``_fs()``'s tree on ``pkg``'s own simulator: (fs, catalog) scanned."""
    fs = _sim(pkg)(n_osts=4)
    fs.define_pool("ssd", (0, 1))
    fs.define_pool("hdd", (2, 3))
    proj = fs.mkdir(fs.root_fid(), "proj")
    logs = fs.mkdir(proj, "logs")
    for i in range(10):
        f = fs.create(proj, f"data{i}.tar", owner="foo", pool="ssd")
        fs.write(f, (i + 1) * 1000)
    for i in range(5):
        f = fs.create(logs, f"log{i}.txt", owner="bar", pool="hdd")
        fs.write(f, 10)
    return fs


def _engine(pkg, cat):
    return pkg.PolicyEngine(cat, **({"device": "cpu"} if pkg is T else {}))


def test_rmdir_empty_batch_matches_scalar_like_jax():
    """The batched rmdir_empty derives emptiness from the parent_fid
    groupby column: identical outcomes to the per-entry readdir path,
    nested empty directories included, for both plan directions."""
    got = {}
    for pkg in (J, T):
        seen = []
        for sort_desc in (False, True):
            results = {}
            for execution in ("scalar", "columnar"):
                fs = _sim(pkg)(n_osts=2)
                proj = fs.mkdir(fs.root_fid(), "proj")
                keep = fs.mkdir(proj, "full")       # has a child file
                f = fs.create(keep, "data.bin", owner="foo")
                fs.write(f, 100)
                for i in range(6):
                    fs.mkdir(proj, f"empty{i}")     # removable
                nest = fs.mkdir(proj, "nest")       # nest -> inner
                fs.mkdir(nest, "inner")
                cat = pkg.Catalog()
                pkg.Scanner(fs, cat).scan()
                eng = _engine(pkg, cat)
                eng.register(pkg.PolicyDefinition.from_config(
                    name="rmdir",
                    action=pkg.PLUGIN_REGISTRY["rmdir_empty"](fs, cat),
                    scope="type == dir and (name == 'empty*' or name == "
                          "'full' or name == 'nest' or name == 'inner')",
                    sort_by="fid", sort_desc=sort_desc))
                r = eng.run("rmdir", execution=execution)
                dirs = sorted(e.path for e in cat.entries()
                              if e.type == pkg.FsType.DIR)
                results[execution] = (r.succeeded, r.failed, dirs)
            assert results["scalar"] == results["columnar"], sort_desc
            succeeded, failed, dirs = results["columnar"]
            assert (succeeded, failed) == ((8, 1) if sort_desc else (7, 2))
            assert "/proj/full" in dirs             # never empty
            assert not any("empty" in d for d in dirs)
            assert ("/proj/nest" in dirs) == (not sort_desc)
            seen.append(results["columnar"])
        got[pkg] = seen
    assert got[T] == got[J]


def test_rmdir_empty_batch_on_parentless_catalog_like_jax():
    """A catalog where nothing records a parent treats every directory as
    empty, not crash on the empty groupby."""
    got = {}
    for pkg in (J, T):
        fs = _sim(pkg)(n_osts=2)
        d1 = fs.mkdir(fs.root_fid(), "d1")
        d2 = fs.mkdir(fs.root_fid(), "d2")
        cat = pkg.Catalog()
        for i, fid in enumerate((d1, d2)):
            cat.upsert(pkg.Entry(fid=fid, name=f"d{i+1}", path=f"/d{i+1}",
                                 type=pkg.FsType.DIR))  # parent_fid=-1
        action = pkg.PLUGIN_REGISTRY["rmdir_empty"](fs, cat)
        oks = action.action_batch(cat.column_batch([d1, d2]), {})
        assert oks == [True, True]
        assert len(cat) == 0
        got[pkg] = (oks, fs.count())
    assert got[T] == got[J]


def test_checksum_plugin_batch_matches_scalar_like_jax():
    got = {}
    for pkg in (J, T):
        results = {}
        for execution in ("scalar", "columnar"):
            fs = _pkg_fs(pkg)
            cat = pkg.Catalog()
            pkg.Scanner(fs, cat).scan()
            # desync one file so a corrupt verdict exists
            tar0 = _fid_of(cat, "/proj/data0.tar")
            cat.update_fields(tar0, size=cat.get(tar0).size + 1)
            eng = _engine(pkg, cat)
            eng.register(pkg.PolicyDefinition.from_config(
                name="fsck", action=pkg.PLUGIN_REGISTRY["checksum"](fs, cat),
                scope="type == file"))
            r = eng.run("fsck", execution=execution)
            statuses = sorted((e.path, e.status) for e in cat.entries()
                              if e.type == 0)
            results[execution] = (r.succeeded, r.failed, statuses)
        assert results["scalar"] == results["columnar"]
        assert results["columnar"][1] == 1      # the desynced file failed
        assert ("/proj/data0.tar", "corrupt") in results["columnar"][2]
        got[pkg] = results["columnar"]
    assert got[T] == got[J]


def test_alerts_fire_on_ingest_like_jax():
    got = {}
    for pkg in (J, T):
        cat = pkg.Catalog()
        am = pkg.AlertManager()
        am.add_rule(pkg.AlertRule("big_tar",
                                  "size > 8000 and name == '*.tar'"))
        cat.add_entry_hook(am.on_entry)
        pkg.Scanner(_pkg_fs(pkg), cat).scan()
        paths = sorted(a["path"] for a in am.fired)
        assert paths == ["/proj/data8.tar", "/proj/data9.tar"]
        got[pkg] = sorted((a["alert"], a["fid"], a["path"], a["owner"],
                           a["size"]) for a in am.fired)
    assert got[T] == got[J]


def test_generic_policy_plugins_like_jax():
    got = {}
    for pkg in (J, T):
        fs = _pkg_fs(pkg)
        cat = pkg.Catalog()
        pkg.Scanner(fs, cat).scan()
        eng = _engine(pkg, cat)
        # generic policy from the plugin registry: tag then purge logs
        eng.register(pkg.PolicyDefinition.from_config(
            name="tag_logs", action=pkg.PLUGIN_REGISTRY["tag_status"](fs, cat),
            scope="type == file",
            rules=[("logs", "path == '/proj/logs/*'",
                    {"status": "expired"})]))
        r = eng.run("tag_logs")
        assert r.succeeded == 5
        eng.register(pkg.PolicyDefinition.from_config(
            name="purge_expired", action=pkg.PLUGIN_REGISTRY["purge"](fs, cat),
            scope="status == 'expired'"))
        r2 = eng.run("purge_expired")
        assert r2.succeeded == 5
        assert fs.count() == 3 + 10   # root, proj, logs + tars
        got[pkg] = (r.succeeded, r2.succeeded, r2.volume,
                    sorted(e.path for e in cat.entries()))
    assert got[T] == got[J]


def test_pool_migration_plugin_like_jax():
    got = {}
    for pkg in (J, T):
        fs = _pkg_fs(pkg)
        cat = pkg.Catalog()
        pkg.Scanner(fs, cat).scan()
        eng = _engine(pkg, cat)
        eng.register(pkg.PolicyDefinition.from_config(
            name="ssd_to_hdd",
            action=pkg.PLUGIN_REGISTRY["migrate_pool"](fs, cat),
            scope="pool == 'ssd' and size > 7000",
            rules=[("all", "true", {"pool": "hdd"})]))
        r = eng.run("ssd_to_hdd")
        assert r.succeeded == 3       # files of 8000, 9000, 10000 bytes
        moved = [e for e in cat.entries() if e.pool == "hdd" and e.size > 7000]
        assert len(moved) == 3
        for e in moved:
            assert all(o in (2, 3) for o in e.stripe_osts)
        got[pkg] = sorted((e.path, e.pool, tuple(e.stripe_osts))
                          for e in moved)
    assert got[T] == got[J]
