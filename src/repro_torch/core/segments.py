"""Compact packed host segments — the warm tier of the catalog.

A :class:`PackedSegment` holds one demoted shard group's column stack in
host memory (or mmap-backed on disk) at a fraction of the resident
footprint, with **exact** round-trip decode:

- integer columns are dict-encoded (sorted unique values + minimal-width
  codes) when the value set is small — owner/group/type/hsm codes
  compress to one byte per row — otherwise delta+zigzag encoded at the
  minimal byte width (fids and ranks are near-sequential, so deltas are
  tiny);
- float columns (atime/mtime/size as staged) are stored raw in their
  native dtype — bit-exact, no quantization;
- unicode columns (path mirrors) are stored raw fixed-width: 4 B/char is
  not the tightest packing, but the array memory-maps straight off disk
  and binary-searches (``np.searchsorted``) without a decode pass, which
  is what the du/subtree rank-range queries need;
- bool columns are stored as raw uint8.

``save(path)`` persists the encoded arrays as an **uncompressed** ``.npz``
beside the sqlite mirror; ``load(path, mmap=True)`` maps them back in so
a demoted segment costs no RSS until it is streamed. ``decode(name)``
returns the exact original array (values *and* dtype); ``columns()``
caches decoded arrays until ``release()``.
"""
from __future__ import annotations

import json
import struct
import threading
import zipfile
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .telemetry import ambient_counter, span as _tspan

_FORMAT = "repro-segment-v1"

# dict-encode when the unique count is small enough that codes+values
# beat delta encoding; 2**16-1 keeps codes at most uint16
_DICT_MAX_UNIQUE = (1 << 16) - 1


def _min_uint(max_value: int) -> np.dtype:
    """Smallest unsigned dtype that holds ``max_value``."""
    for dt in (np.uint8, np.uint16, np.uint32):
        if max_value <= np.iinfo(dt).max:
            return np.dtype(dt)
    return np.dtype(np.uint64)


def _zigzag(a: np.ndarray) -> np.ndarray:
    """int64 -> uint64 zigzag (small negatives stay small)."""
    a = a.astype(np.int64, copy=False)
    return ((a << 1) ^ (a >> 63)).view(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64, copy=False)
    return ((z >> np.uint64(1)).view(np.int64)
            ^ -(z & np.uint64(1)).view(np.int64))


class PackedSegment:
    """Encoded column stack for one demoted shard group.

    Build with :meth:`pack`; read back with :meth:`decode` /
    :meth:`columns`. Instances are immutable after ``pack`` apart from
    the decode cache; ``meta`` carries caller bookkeeping (catalog
    versions, row count) through save/load untouched.
    """

    def __init__(self) -> None:
        self._enc: Dict[str, Dict[str, object]] = {}   # name -> scheme
        self._arrays: Dict[str, np.ndarray] = {}       # storage arrays
        self._cache: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self.n_rows: int = 0
        self.meta: Dict[str, object] = {}

    # -- encode ----------------------------------------------------------

    @classmethod
    def pack(cls, columns: Mapping[str, np.ndarray],
             meta: Optional[Mapping[str, object]] = None) -> "PackedSegment":
        with _tspan("segment.pack", columns=len(columns)) as _sp:
            seg = cls._pack(columns, meta)
            _sp.annotate(rows=seg.n_rows, encoded_bytes=seg.nbytes)
            return seg

    @classmethod
    def _pack(cls, columns: Mapping[str, np.ndarray],
              meta: Optional[Mapping[str, object]] = None
              ) -> "PackedSegment":
        seg = cls()
        seg.meta = dict(meta or {})
        n_rows = None
        for name, arr in columns.items():
            arr = np.ascontiguousarray(arr)
            if arr.ndim != 1:
                raise ValueError(f"column {name!r} must be 1-D")
            if n_rows is None:
                n_rows = arr.shape[0]
            elif arr.shape[0] != n_rows:
                raise ValueError(
                    f"column {name!r} has {arr.shape[0]} rows, "
                    f"expected {n_rows}")
            kind = arr.dtype.kind
            if kind in "iu":
                seg._pack_int(name, arr)
            elif kind == "f":
                seg._store(name, "raw", arr.dtype, arr)
            elif kind in "US":
                seg._store(name, "raw", arr.dtype, arr)
            elif kind == "b":
                seg._store(name, "bool", arr.dtype, arr.view(np.uint8))
            else:
                raise TypeError(
                    f"column {name!r}: unsupported dtype {arr.dtype}")
        seg.n_rows = int(n_rows or 0)
        return seg

    def _store(self, name: str, enc: str, dtype: np.dtype,
               *arrays: np.ndarray) -> None:
        self._enc[name] = {"enc": enc, "dtype": np.dtype(dtype).str}
        for i, a in enumerate(arrays):
            self._arrays[f"{name}.{i}"] = a

    def _pack_int(self, name: str, arr: np.ndarray) -> None:
        a = arr.astype(np.int64, copy=False)
        uniq = np.unique(a)
        # dict-encode when codes+values beat the delta stream; always for
        # tiny value sets (owner/group/type/hsm), never past uint16 codes
        if uniq.size <= min(_DICT_MAX_UNIQUE, max(16, a.size // 4)):
            codes = np.searchsorted(uniq, a).astype(
                _min_uint(max(int(uniq.size) - 1, 0)))
            self._store(name, "dict", arr.dtype, codes, uniq)
        else:
            delta = np.diff(a, prepend=np.int64(0))
            z = _zigzag(delta)
            width = _min_uint(int(z.max()) if z.size else 0)
            self._store(name, "delta", arr.dtype, z.astype(width))

    # -- decode ----------------------------------------------------------

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._enc)

    def decode(self, name: str) -> np.ndarray:
        """Exact original array for ``name`` (values and dtype)."""
        with self._lock:
            out = self._cache.get(name)
            if out is None:
                with _tspan("segment.decode", column=name):
                    out = self._decode(name)
                ambient_counter("segment_bytes_decoded", out.nbytes)
                self._cache[name] = out
            return out

    def _decode(self, name: str) -> np.ndarray:
        scheme = self._enc[name]
        enc, dtype = scheme["enc"], np.dtype(scheme["dtype"])  # type: ignore
        if enc == "raw":
            return np.asarray(self._arrays[f"{name}.0"])
        if enc == "bool":
            return np.asarray(self._arrays[f"{name}.0"]).view(np.bool_)
        if enc == "dict":
            codes = np.asarray(self._arrays[f"{name}.0"])
            values = np.asarray(self._arrays[f"{name}.1"])
            return values[codes].astype(dtype, copy=False)
        if enc == "delta":
            z = np.asarray(self._arrays[f"{name}.0"])
            return np.cumsum(_unzigzag(z)).astype(dtype, copy=False)
        raise ValueError(f"unknown encoding {enc!r} for column {name!r}")

    def columns(self) -> Dict[str, np.ndarray]:
        """Decode every column (cached until :meth:`release`)."""
        return {name: self.decode(name) for name in self._enc}

    def release(self) -> None:
        """Drop the decode cache (the encoded arrays stay)."""
        with self._lock:
            self._cache.clear()

    @property
    def nbytes(self) -> int:
        """Encoded size — what the warm tier actually holds."""
        return int(sum(a.nbytes for a in self._arrays.values()))

    @property
    def decoded_nbytes(self) -> int:
        """Size of the fully decoded stack (the demote savings baseline)."""
        total = 0
        for name in self._enc:
            scheme = self._enc[name]
            if scheme["enc"] in ("raw", "bool"):
                total += int(np.asarray(self._arrays[f"{name}.0"]).nbytes)
            else:
                total += self.n_rows * np.dtype(scheme["dtype"]).itemsize
        return total

    # -- persistence -----------------------------------------------------

    def save(self, path: str) -> None:
        """Write an uncompressed ``.npz`` (arrays mmap back in)."""
        header = json.dumps({
            "format": _FORMAT, "n_rows": self.n_rows,
            "meta": self.meta, "enc": self._enc,
        })
        arrays = {k.replace(".", "__"): v for k, v in self._arrays.items()}
        np.savez(path, __header=np.asarray(header), **arrays)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "PackedSegment":
        """Read a segment back; with ``mmap`` the storage arrays are
        memory-mapped straight out of the (stored-uncompressed) zip
        members, so loading costs no RSS until a column is streamed.
        ``np.load`` reads npz members through zipfile streams even with
        ``mmap_mode`` set, hence the explicit offset mapping here."""
        arrays = (_mmap_npz(path) if mmap
                  else dict(np.load(path, allow_pickle=False)))
        header = json.loads(str(np.asarray(arrays.pop("__header"))[()]))
        if header.get("format") != _FORMAT:
            raise ValueError(f"{path}: not a {_FORMAT} file")
        seg = cls()
        seg.n_rows = int(header["n_rows"])
        seg.meta = dict(header["meta"])
        seg._enc = {k: dict(v) for k, v in header["enc"].items()}
        for name in seg._enc:
            i = 0
            while f"{name}__{i}" in arrays:
                seg._arrays[f"{name}.{i}"] = arrays[f"{name}__{i}"]
                i += 1
        return seg


def _mmap_npz(path: str) -> Dict[str, np.ndarray]:
    """Memory-map every member of an uncompressed ``.npz``.

    ``np.savez`` stores members with ``ZIP_STORED``, so each ``.npy``
    payload sits contiguous in the file: seek past the member's local
    header, parse the npy header for dtype/shape, and ``np.memmap`` the
    data span read-only. Falls back to a regular read for any member
    that is compressed or non-contiguous (fortran order)."""
    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                out[name] = np.load(zf.open(info.filename))  # pragma: no cover
                continue
            with open(path, "rb") as f:
                f.seek(info.header_offset)
                lh = f.read(30)                    # local file header
                n_name, n_extra = struct.unpack("<HH", lh[26:30])
                data_off = info.header_offset + 30 + n_name + n_extra
                f.seek(data_off)
                version = np.lib.format.read_magic(f)
                shape, fortran, dtype = \
                    np.lib.format._read_array_header(f, version)
                if fortran:                        # pragma: no cover
                    out[name] = np.load(zf.open(info.filename))
                    continue
                out[name] = np.memmap(path, mode="r", dtype=dtype,
                                      shape=shape, offset=f.tell())
    return out
