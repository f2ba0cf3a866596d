"""``tests/core/test_catalog.py`` on the port, held against ``repro``.

The sharded columnar catalog: upserts, field updates, removes, batched
gathers, the sqlite mirror, delta hooks, the Entry-free ``ColumnBatch``
view and the per-version ``arrays()`` cache. The port's
``core/catalog.py`` is the reference's but for one docstring line
(``tests/test_torch_copies.py``). Cases that yield entries, columns or
fid sets run on both packages and must return the same values; the
cache-identity and version cases run on the port.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_pair import both, port


def _entry(P, fid, **kw):
    defaults = dict(parent_fid=1, name=f"f{fid}", path=f"/a/f{fid}",
                    type=P.FsType.FILE, size=fid * 100, blocks=fid * 100,
                    owner="foo", atime=1.0, mtime=1.0, ctime=1.0)
    defaults.update(kw)
    return P.Entry(fid=fid, **defaults)


def _fields(e):
    """An Entry as plain values (enums by value), for ``==`` across
    packages."""
    if e is None:
        return None
    out = dataclasses.asdict(e)
    out["type"], out["hsm_state"] = int(e.type), int(e.hsm_state)
    return out


def _roundtrip(P):
    cat = P.Catalog(n_shards=3)
    cat.upsert(_entry(P, 42, owner="bar", pool="ssd",
                      hsm_state=P.HsmState.ARCHIVED, xattrs={"k": "v"},
                      stripe_osts=(1, 2)))
    out = cat.get(42)
    assert out.owner == "bar" and out.pool == "ssd"
    assert out.hsm_state == P.HsmState.ARCHIVED
    assert out.xattrs == {"k": "v"} and out.stripe_osts == (1, 2)
    assert len(cat) == 1
    return _fields(out)


def test_upsert_get_roundtrip():
    both(_roundtrip)


def _update_remove(P):
    cat = P.Catalog(n_shards=2)
    cat.upsert(_entry(P, 7))
    assert cat.update_fields(7, size=999, owner="baz")
    got = _fields(cat.get(7))
    assert got["size"] == 999 and got["owner"] == "baz"
    assert cat.remove(7)
    assert cat.get(7) is None
    assert not cat.remove(7)
    return got


def test_update_fields_and_remove():
    both(_update_remove)


def _vector_query(P):
    cat = P.Catalog(n_shards=4)
    for i in range(1, 101):
        cat.upsert(_entry(P, i, owner="foo" if i % 2 else "bar"))
    fids = cat.query_fids(lambda c: c["size"] > 5000)
    assert sorted(fids.tolist()) == list(range(51, 101))
    cols = cat.arrays()
    assert len(cols["_paths"]) == 100
    return {k: np.asarray(v).tolist() for k, v in cols.items()}


def test_vector_query():
    both(_vector_query)


def _sqlite(P, tmp_path):
    db = str(tmp_path / f"{P.name}.db")
    cat = P.Catalog(n_shards=2, db_path=db)
    for i in range(1, 21):
        cat.upsert(_entry(P, i))
    cat.remove(5)
    # crash: new catalog from same file
    cat2 = P.Catalog(n_shards=2, db_path=db)
    n = cat2.load_from_db()
    assert n == 19
    assert cat2.get(5) is None and cat2.get(6).size == 600
    return sorted((e.fid, e.size, e.path) for e in cat2.entries())


def test_sqlite_persistence_roundtrip(tmp_path):
    both(_sqlite, tmp_path)


def test_delta_hooks_fire():
    P = port()
    cat = P.Catalog(n_shards=1)
    deltas = []
    cat.add_delta_hook(lambda old, new: deltas.append((old, new)))
    cat.upsert(_entry(P, 1))
    cat.update_fields(1, size=5)
    cat.remove(1)
    assert len(deltas) == 3
    assert deltas[0][0] is None and deltas[2][1] is None


def _get_batch(P):
    cat = P.Catalog(n_shards=3)
    for i in range(1, 41):
        cat.upsert(_entry(P, i, owner=f"u{i % 4}"))
    fids = [5, 999, 17, 2, 1000, 40]
    got = cat.get_batch(fids)
    assert got[1] is None and got[4] is None
    for fid, e in zip(fids, got):
        if e is not None:
            assert e.fid == fid
            assert e == cat.get(fid)     # batch-built == scalar-built
    return [_fields(e) for e in got]


def test_get_batch_roundtrip_and_missing():
    both(_get_batch)


def _get_batch_fields(P):
    cat = P.Catalog(n_shards=2)
    cat.upsert(_entry(P, 9, owner="bar", pool="ssd",
                      hsm_state=P.HsmState.RELEASED, xattrs={"k": "v"},
                      stripe_osts=(3, 1), dirty=True))
    (batch,) = cat.get_batch([9])
    assert batch == cat.get(9)
    assert batch.hsm_state is P.HsmState.RELEASED
    assert batch.type is P.FsType.FILE
    return _fields(batch)


def test_get_batch_matches_get_for_all_fields():
    both(_get_batch_fields)


def _update_batch(P):
    cat = P.Catalog(n_shards=4)
    fired = []
    cat.add_delta_hook(lambda old, new: fired.append((old, new)))
    for i in range(1, 11):
        cat.upsert(_entry(P, i))
    fired.clear()
    updated = cat.update_fields_batch([3, 7, 999, 4], status="expired")
    assert sorted(updated) == [3, 4, 7]
    assert len(fired) == 3                       # one delta per updated entry
    for fid in (3, 4, 7):
        assert cat.get(fid).status == "expired"
    return sorted(updated), len(fired)


def test_update_fields_batch_fires_hooks_and_returns_updated():
    both(_update_batch)


def test_remove_batch():
    P = port()
    cat = P.Catalog(n_shards=2)
    for i in range(1, 11):
        cat.upsert(_entry(P, i))
    assert cat.remove_batch([2, 4, 999, 6]) == 3
    assert len(cat) == 7
    assert cat.get(4) is None


def _column_slice(P):
    cat = P.Catalog(n_shards=4)
    for i in range(1, 21):
        cat.upsert(_entry(P, i))
    cols, present = cat.column_slice([7, 300, 14, 1], ["size", "blocks"])
    assert present.tolist() == [True, False, True, True]
    assert cols["size"].tolist() == [700, 0, 1400, 100]
    assert cols["size"].dtype == np.int64
    return present.tolist(), {k: v.tolist() for k, v in cols.items()}


def test_column_slice_alignment():
    both(_column_slice)


def _column_batch(P):
    cat = P.Catalog(n_shards=3)
    for i in range(1, 21):
        cat.upsert(_entry(P, i, owner=f"u{i % 3}",
                          pool="ssd" if i % 2 else ""))
    fids = [7, 300, 14, 1, 2]
    batch = cat.column_batch(fids)
    assert isinstance(batch, P.ColumnBatch) and len(batch) == 5
    assert batch.present.tolist() == [True, False, True, True, True]
    assert batch.fids.tolist() == [7, 0, 14, 1, 2]
    assert batch.size.tolist() == [700, 0, 1400, 100, 200]
    # lazy string decode through the interned codes
    assert batch.decode("owner") == ["u1", "", "u2", "u1", "u2"]
    assert batch.decode("pool") == ["ssd", "", "", "ssd", ""]
    # sub-batch slicing keeps alignment; bool masks select, not index
    sub = batch.take([0, 2])
    assert sub.fids.tolist() == [7, 14] and sub.present.all()
    assert sub.decode("owner") == ["u1", "u2"]
    masked = batch.take(batch.present)
    assert masked.fids.tolist() == [7, 14, 1, 2]
    # the materializing escape hatch equals get_batch
    assert batch.entries() == cat.get_batch(fids)
    return {k: v.tolist() for k, v in batch.cols.items()}


def test_column_batch_entry_free_view():
    both(_column_batch)


def _from_entries(P):
    cat = P.Catalog(n_shards=2)
    for i in range(1, 11):
        cat.upsert(_entry(P, i, owner=f"u{i % 2}"))
    fids = [3, 99, 8]
    direct = cat.column_batch(fids)
    shim = P.ColumnBatch.from_entries(cat.get_batch(fids), cat.strings, cat)
    assert (shim.present == direct.present).all()
    for name in direct.cols:
        assert (shim.cols[name] == direct.cols[name]).all(), name
    return {k: v.tolist() for k, v in shim.cols.items()}


def test_column_batch_from_entries_matches_gather():
    both(_from_entries)


def test_catalog_version_bumps_on_every_mutation():
    P = port()
    cat = P.Catalog(n_shards=2)
    v = cat.version
    cat.upsert(_entry(P, 1))
    assert cat.version > v
    v = cat.version
    cat.upsert_batch([_entry(P, 2), _entry(P, 3)])
    assert cat.version > v
    v = cat.version
    cat.update_fields(1, size=5)
    assert cat.version > v
    v = cat.version
    cat.update_fields_batch([2, 3], status="x")
    assert cat.version > v
    v = cat.version
    cat.remove(1)
    assert cat.version > v
    v = cat.version
    cat.remove_batch([2])
    assert cat.version > v


def test_arrays_lazy_paths_still_correct():
    P = port()
    cat = P.Catalog(n_shards=3)
    for i in range(1, 16):
        cat.upsert(_entry(P, i))
    cols = cat.arrays()
    # _paths/_names materialize lazily but align with the numeric columns
    assert "_paths" in cols
    paths = cols["_paths"]
    assert len(paths) == len(cols["fid"])
    for fid, p in zip(cols["fid"].tolist(), paths):
        assert p == f"/a/f{fid}"


def test_arrays_cached_per_version():
    """Two arrays() calls at the same catalog version return the SAME
    cached object; any mutation invalidates."""
    P = port()
    cat = P.Catalog(n_shards=3)
    for i in range(1, 21):
        cat.upsert(_entry(P, i))
    a = cat.arrays()
    assert cat.arrays() is a
    _ = a["_paths"]                 # lazy strings do not invalidate the cache
    assert cat.arrays() is a
    cat.update_fields(3, size=123)
    c = cat.arrays()
    assert c is not a
    assert c["size"][np.nonzero(c["fid"] == 3)[0][0]] == 123
    assert cat.arrays() is c
    cat.remove(5)
    assert cat.arrays() is not c
