"""catalog_from_columns: the reference catalog's state, carried over.

The port catalog built from the reference ``Catalog.arrays()`` columns and
the reference string table must return the same ``arrays()``: every
column equal in value and dtype, the same row order, the same string codes.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import Catalog as JCatalog, Entry as JEntry
from repro.core import FsType as JFsType, HsmState as JHsmState
from repro_torch.convert import catalog_from_columns


def _reference_catalog(seed, n=300, n_shards=4):
    rng = np.random.default_rng(seed)
    cat = JCatalog(n_shards=n_shards)
    cat.upsert_batch([JEntry(
        fid=i + 1, parent_fid=int(rng.integers(0, 50)), name=f"f{i}",
        path=f"/p/d{i % 7}/f{i}",
        type=JFsType(int(rng.integers(0, 3))),
        size=int(rng.integers(0, 1 << 40)), blocks=int(rng.integers(0, 1 << 30)),
        owner=f"user{int(rng.integers(0, 5))}",
        group=f"grp{int(rng.integers(0, 3))}",
        mode=int(rng.integers(0, 0o777)), nlink=int(rng.integers(1, 4)),
        atime=float(rng.random() * 1e9), mtime=float(rng.random() * 1e9),
        ctime=float(rng.random() * 1e9), ost_idx=int(rng.integers(-1, 8)),
        pool=["", "ssd", "hdd"][int(rng.integers(0, 3))],
        hsm_state=JHsmState(int(rng.integers(0, 7))),
        archive_id=int(rng.integers(0, 3)),
        status=["", "new", "done"][int(rng.integers(0, 3))],
        dirty=bool(rng.integers(0, 2))) for i in range(n)])
    # holes and updates: removed rows are reused out of order
    for fid in rng.choice(np.arange(1, n + 1), n // 10, replace=False):
        cat.remove(int(fid))
    for fid in range(n + 1, n + 1 + n // 20):
        cat.upsert(JEntry(fid=fid, name=f"n{fid}", path=f"/new/n{fid}",
                          owner="late-owner", size=fid))
    cat.update_fields(2 if cat.get(2) else 3, owner="renamed")
    return cat


def _strings(cat):
    return [cat.strings.lookup(i) for i in range(len(cat.strings))]


@pytest.mark.parametrize("seed,n_shards", [(0, 4), (1, 1), (2, 8)])
def test_catalog_from_columns_round_trips(seed, n_shards):
    ref = _reference_catalog(seed, n_shards=n_shards)
    want = ref.arrays()
    port = catalog_from_columns(want, _strings(ref), n_shards=n_shards)
    got = port.arrays()
    assert len(port) == len(ref)
    numeric = [k for k in want.keys() if not k.startswith("_")]
    assert sorted(got.keys()) == sorted(numeric)
    for k in numeric:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert list(got["_names"]) == list(want["_names"])
    assert list(got["_paths"]) == list(want["_paths"])
    assert _strings(port) == _strings(ref)


def test_catalog_from_columns_rejects_bad_string_tables():
    ref = _reference_catalog(3, n=20)
    with pytest.raises(ValueError):
        catalog_from_columns(ref.arrays(), ["x"] + _strings(ref)[1:])
    with pytest.raises(ValueError):
        catalog_from_columns(ref.arrays(), _strings(ref) + ["user0"])
