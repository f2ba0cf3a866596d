"""The port's PackedSegment: ``tests/core/test_segments.py`` against
``repro_torch.core.segments``.

The module is a byte copy of ``repro.core.segments`` (its imports are
relative), pinned below. The warm tier only works if decode is *exact* —
the streamed window and the promoted mirrors must be byte-identical to
what a resident group would hold — so the round-trip here is asserted
with ``np.array_equal`` + dtype equality, never ``allclose``.
"""
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.segments import (PackedSegment, _min_uint, _unzigzag,
                                       _zigzag)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_segments_is_a_byte_copy_of_the_reference():
    ref = (SRC / "repro" / "core" / "segments.py").read_bytes()
    port = (SRC / "repro_torch" / "core" / "segments.py").read_bytes()
    assert port == ref

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False
needs_hypothesis = pytest.mark.skipif(
    not HAVE_HYPOTHESIS, reason="hypothesis not installed")


# -- codec primitives ---------------------------------------------------------

def test_zigzag_roundtrip_fixed():
    a = np.asarray([0, 1, -1, 2 ** 62, -2 ** 62, 63, -64], np.int64)
    assert np.array_equal(_unzigzag(_zigzag(a)), a)


if HAVE_HYPOTHESIS:
    @needs_hypothesis
    @given(st.lists(st.integers(-2 ** 62, 2 ** 62), max_size=50))
    def test_zigzag_roundtrip(vals):
        a = np.asarray(vals, np.int64)
        assert np.array_equal(_unzigzag(_zigzag(a)), a)


def test_min_uint_widths():
    assert _min_uint(0) == np.uint8
    assert _min_uint(255) == np.uint8
    assert _min_uint(256) == np.uint16
    assert _min_uint(2 ** 16) == np.uint32
    assert _min_uint(2 ** 32) == np.uint64


# -- pack/decode round-trip ---------------------------------------------------

_INT_DTYPES = [np.int8, np.int16, np.int32, np.int64,
               np.uint8, np.uint16, np.uint32]
_FLOAT_DTYPES = [np.float32, np.float64]


def _random_column(rng, n, kind, variant):
    if kind == "int":
        dt = _INT_DTYPES[variant % len(_INT_DTYPES)]
        info = np.iinfo(dt)
        # mix of low-cardinality (dict path) and spread (delta path)
        if variant % 2:
            vals = rng.integers(0, min(5, info.max), size=n)
        else:
            vals = rng.integers(info.min, info.max, size=n, endpoint=True)
        return vals.astype(dt)
    if kind == "float":
        dt = _FLOAT_DTYPES[variant % len(_FLOAT_DTYPES)]
        return (rng.standard_normal(n) * 1e6).astype(dt)
    if kind == "str":
        return np.asarray([f"/p/d{int(v)}/f{i}" for i, v in
                           enumerate(rng.integers(0, 7, size=n))])
    return rng.random(n) < 0.5


def _roundtrip(cols):
    seg = PackedSegment.pack(cols, meta={"tag": 1})
    assert seg.n_rows == len(next(iter(cols.values())))
    for name, arr in cols.items():
        dec = seg.decode(name)
        assert dec.dtype == arr.dtype, name
        assert np.array_equal(dec, arr), name
    assert seg.meta == {"tag": 1}


@pytest.mark.parametrize("seed", range(8))
def test_pack_roundtrip_random_columns_fixed(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 200))
    kinds = ["int", "float", "str", "bool"]
    _roundtrip({f"c{i}": _random_column(rng, n, kinds[i % 4],
                                        int(rng.integers(0, 8)))
                for i in range(int(rng.integers(1, 6)))})


if HAVE_HYPOTHESIS:
    @needs_hypothesis
    @settings(max_examples=60, deadline=None)
    @given(st.integers(0, 200), st.integers(1, 5),
           st.lists(st.tuples(st.sampled_from(["int", "float", "str",
                                               "bool"]),
                              st.integers(0, 7)),
                    min_size=5, max_size=5),
           st.integers(0, 2 ** 31))
    def test_pack_roundtrip_random_columns(n, n_cols, specs, seed):
        rng = np.random.default_rng(seed)
        _roundtrip({f"c{i}": _random_column(rng, n, specs[i][0],
                                            specs[i][1])
                    for i in range(n_cols)})


@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_single_row(n):
    cols = {
        "fid": np.arange(n, dtype=np.int64) + 7,
        "size": np.full(n, 3.5, np.float32),
        "owner": np.zeros(n, np.int32),
        "path": np.asarray(["/p/x"] * n),
        "flag": np.ones(n, bool),
    }
    seg = PackedSegment.pack(cols)
    assert seg.n_rows == n
    for name, arr in cols.items():
        dec = seg.decode(name)
        assert dec.dtype == arr.dtype and np.array_equal(dec, arr)


def test_near_sequential_ints_delta_compress():
    fids = np.arange(1, 100_001, dtype=np.int64) * 3
    seg = PackedSegment.pack({"fid": fids})
    assert np.array_equal(seg.decode("fid"), fids)
    # deltas are constant (=3): one byte per row, 8x under raw int64
    assert seg.nbytes < fids.nbytes / 4


def test_low_cardinality_ints_dict_compress():
    owners = np.random.default_rng(0).integers(0, 4, size=50_000)
    seg = PackedSegment.pack({"owner": owners})
    assert np.array_equal(seg.decode("owner"), owners)
    assert seg.decode("owner").dtype == owners.dtype
    assert seg.nbytes < owners.nbytes / 4
    assert seg.decoded_nbytes == owners.nbytes


def test_negative_and_extreme_deltas():
    a = np.asarray([2 ** 62, -2 ** 62, 0, 1, -1, 2 ** 40], np.int64)
    # force the delta path (unique count above the dict threshold needs
    # n//4 < uniq, so small arrays always dict-encode; check both)
    seg = PackedSegment.pack({"a": a})
    assert np.array_equal(seg.decode("a"), a)


def test_unsupported_dtype_and_ragged_rows_raise():
    with pytest.raises(TypeError):
        PackedSegment.pack({"c": np.zeros(3, np.complex64)})
    with pytest.raises(ValueError):
        PackedSegment.pack({"a": np.zeros(3), "b": np.zeros(4)})


def test_columns_cache_and_release():
    seg = PackedSegment.pack({"fid": np.arange(10, dtype=np.int64)})
    first = seg.decode("fid")
    assert seg.decode("fid") is first           # cached
    seg.release()
    assert seg.decode("fid") is not first       # re-decoded
    assert set(seg.columns()) == {"fid"}


# -- persistence --------------------------------------------------------------

@pytest.mark.parametrize("mmap", [False, True])
def test_save_load_roundtrip(tmp_path, mmap):
    rng = np.random.default_rng(3)
    cols = {
        "fid": np.cumsum(rng.integers(1, 9, size=1000)).astype(np.int64),
        "size": (rng.integers(0, 2 ** 12, size=1000) * 1024
                 ).astype(np.float32),
        "atime": rng.random(1000).astype(np.float64) * 1e6,
        "owner": rng.integers(0, 4, size=1000).astype(np.int32),
        "path": np.asarray([f"/p/d{i % 5}/f{i}" for i in range(1000)]),
        "valid": rng.random(1000) < 0.9,
    }
    seg = PackedSegment.pack(cols, meta={"gid": 2, "rows": 1000})
    p = str(tmp_path / "seg.npz")
    seg.save(p)
    back = PackedSegment.load(p, mmap=mmap)
    assert back.n_rows == 1000 and back.meta == {"gid": 2, "rows": 1000}
    assert set(back.names) == set(cols)
    for name, arr in cols.items():
        dec = back.decode(name)
        assert dec.dtype == arr.dtype, name
        assert np.array_equal(dec, arr), name


def test_mmap_load_uses_memmap(tmp_path):
    seg = PackedSegment.pack({"fid": np.arange(5000, dtype=np.int64),
                              "sz": np.ones(5000, np.float32)})
    p = str(tmp_path / "seg.npz")
    seg.save(p)
    back = PackedSegment.load(p, mmap=True)
    assert any(isinstance(a, np.memmap) for a in back._arrays.values())
    assert np.array_equal(back.decode("fid"), np.arange(5000))


def test_load_rejects_foreign_file(tmp_path):
    p = str(tmp_path / "other.npz")
    np.savez(p, __header=np.asarray('{"format": "something-else"}'),
             a=np.zeros(3))
    with pytest.raises(ValueError, match="repro-segment-v1"):
        PackedSegment.load(p)


# -- demote -> promote byte-identity on every plane ---------------------------

def test_demote_promote_mirror_byte_identity():
    """Pack a group-shaped column stack (kernel + reports + cube plane
    mirrors), decode it back, and require byte-identity on every plane —
    the exact contract ``DeviceColumnStore._promote`` relies on."""
    from repro_torch.core.device_store import PLAN_COLUMNS
    rng = np.random.default_rng(11)
    n = 2000
    cols = {name: (rng.integers(0, 2 ** 12, size=n) * 1024
                   ).astype(np.float32) for name in PLAN_COLUMNS}
    cols["fid"] = np.cumsum(rng.integers(1, 5, size=n)).astype(np.int64)
    paths = np.asarray(sorted(f"/p/d{i % 17}/f{i:06d}" for i in range(n)))
    order = rng.permutation(n)
    cols["path"] = paths[order]          # row-aligned paths
    cols["ord"] = order.astype(np.int64)  # row -> sorted-path rank
    cols["cgid"] = rng.integers(0, 40, size=n).astype(np.int64)
    cols["csb"] = rng.integers(0, 10, size=n).astype(np.int64)
    seg = PackedSegment.pack(cols)
    dec = seg.columns()
    for name, arr in cols.items():
        assert dec[name].dtype == arr.dtype, name
        assert np.array_equal(dec[name], arr), name
    # sorted-path reconstruction (what _promote rebuilds spaths from)
    sp = np.empty(n, dtype=dec["path"].dtype)
    sp[dec["ord"]] = dec["path"]
    assert np.array_equal(sp, paths)
