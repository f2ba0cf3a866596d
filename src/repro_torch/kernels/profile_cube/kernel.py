"""Build, bind and launch the hand-written ``profile_cube`` CUDA kernel.

The source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :mod:`repro_torch.kernels._build`).

:func:`profile_cube_cuda` replaces ``profile_cube_pallas``: it bucketizes
size and age (or takes precomputed bucket rows) and sums the valid-weighted
count, size and blocks of every row into its ``[gid, sb, ab]`` cell, as u64
integers (f64 for a row that is not integer), rounding each cell to f32
once. It counts its calls in a plain integer, takes CUDA tensors only and
raises on anything else: there is no fallback here. The plain version
lives in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .ref import A_BUCKETS, N_MEASURES, S_BUCKETS

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("profile_cube.cu",)

# The group axis the cube takes on the card: at 4096 groups the global
# design's u64 and f64 side cubes (2 x 9.2 MB, 32 B cells) still sit in the
# H100's 50 MB L2; catalogs with more distinct (owner, group, type, hsm)
# combinations take the host groupby path (see core.profiles).
MAX_GROUPS = 4096

# op-call counter: +1 per profile_cube_cuda call whose launches were all
# accepted (each call launches a memset, the cube kernel and the cast),
# nowhere else
profile_cube_launches = 0

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def reset_counters() -> None:
    global profile_cube_launches
    profile_cube_launches = 0


def library_path() -> Path:
    return _build.library_path("profile_cube", CSRC, SOURCES)


def build() -> Path:
    """Compile ``csrc/`` into the shared library unless it already exists.
    Returns its path."""
    return _build.build("profile_cube", CSRC, SOURCES)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.profile_cube_launch.argtypes = [
                p, ll, i, i, i, i, i, i, i, i, p, p, i, p]
            lib.profile_cube_launch.restype = i
            lib.profile_cube_design.argtypes = [i]
            lib.profile_cube_design.restype = i
            lib.profile_cube_band_groups.argtypes = []
            lib.profile_cube_band_groups.restype = i
            lib.profile_cube_work_bytes.argtypes = [ll, i]
            lib.profile_cube_work_bytes.restype = ll
            lib.profile_cube_error_string.argtypes = [i]
            lib.profile_cube_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _error(lib: ctypes.CDLL, code: int) -> str:
    return lib.profile_cube_error_string(code).decode()


DESIGNS = ("global", "shared")


def band_groups() -> int:
    """The most groups one block's private cube in shared memory holds
    (the shared design's limit): the kernel's compile-time constant, read
    from the library."""
    return _lib().profile_cube_band_groups()


def design(n_groups: int, device=None) -> str:
    """The kernel's design for ``n_groups`` on ``device`` (the current CUDA
    device by default): ``"shared"`` when each block keeps a private cube
    in shared memory (up to :func:`band_groups`), ``"global"`` when every
    row adds into the global cube."""
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.profile_cube_design(int(n_groups))
    if code < 0:
        raise RuntimeError(f"profile_cube design query failed: "
                           f"{_error(lib, -code)}")
    return DESIGNS[code]


def profile_cube_cuda(cols: torch.Tensor, *, n_groups: int, gid_col: int,
                      size_col: int, blocks_col: int, age_col: int,
                      valid_col: int, sb_col: int, ab_col: int
                      ) -> torch.Tensor:
    """cols: (n_cols, N) f32 contiguous CUDA, N > 0. Returns the
    (N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS) f32 cube. ``valid_col``,
    ``sb_col`` and ``ab_col`` may be -1 (all rows valid; bucketize size /
    age from the raw rows); ``age_col`` is not read when ``ab_col`` >= 0."""
    global profile_cube_launches
    if not isinstance(cols, torch.Tensor):
        raise TypeError("cols must be a tensor")
    if cols.device.type != "cuda":
        raise ValueError(f"cols is on {cols.device}: the profile_cube "
                         "kernel takes CUDA tensors only")
    if cols.dtype != torch.float32:
        raise TypeError(f"cols must be torch.float32, got {cols.dtype}")
    if cols.dim() != 2:
        raise ValueError(f"cols must be (n_cols, N), got {tuple(cols.shape)}")
    if not cols.is_contiguous():
        raise ValueError("cols must be contiguous")
    n_cols, n = cols.shape
    if n == 0:
        raise ValueError("the profile_cube kernel needs N > 0 rows")
    if not 1 <= n_groups <= MAX_GROUPS:
        raise ValueError(f"n_groups={n_groups} outside [1, {MAX_GROUPS}]: "
                         "use the host groupby path")
    for name, c in (("gid_col", gid_col), ("size_col", size_col),
                    ("blocks_col", blocks_col)):
        if not 0 <= c < n_cols:
            raise ValueError(f"{name}={c} outside [0, {n_cols})")
    for name, c in (("valid_col", valid_col), ("sb_col", sb_col),
                    ("ab_col", ab_col)):
        if not -1 <= c < n_cols:
            raise ValueError(f"{name}={c} outside [-1, {n_cols})")
    if ab_col < 0 and not 0 <= age_col < n_cols:
        raise ValueError(f"age_col={age_col} outside [0, {n_cols})")
    dev = cols.device
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        work = torch.empty((lib.profile_cube_work_bytes(n, n_groups),),
                           dtype=torch.uint8, device=dev)
        out = torch.empty((N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS),
                          dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.profile_cube_launch(
            cols.data_ptr(), n, n_groups, gid_col, size_col, blocks_col,
            age_col if ab_col < 0 else -1, valid_col, sb_col, ab_col,
            work.data_ptr(), out.data_ptr(), sms, stream)
    if err != 0:
        raise RuntimeError(f"profile_cube launch failed: {_error(lib, err)}")
    profile_cube_launches += 1
    return out
