"""Build, bind and launch the hand-written ``profile_cube`` CUDA kernel.

The source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :class:`repro_torch.kernels._build.Library`).

:func:`profile_cube_cuda` replaces ``profile_cube_pallas``: it bucketizes
size and age (or takes precomputed bucket rows) and sums the valid-weighted
count, size and blocks of every row into its ``[gid, sb, ab]`` cell, as u64
integers (f64 for a row that is not integer), rounding each cell to f32
once (or writing it as f64, for the column store's cube plane). Given a
permissions plane and a subject it bins only the rows that subject may see
(the store's scoped cube). It counts its calls in a plain integer, takes
CUDA tensors only and raises on anything else: there is no fallback here.
The plain version lives in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import _build, _launches
from .ref import A_BUCKETS, N_MEASURES, S_BUCKETS

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("profile_cube.cu",)

# The most groups one launch takes: csrc's MAX_GROUPS (group ids ride in
# an f32 row, exact below 2^24; the kernel's int cell indices hold there).
# The store's cube plane reaches past the op's cap (``ops.MAX_GROUPS``,
# 4096). The global design's u64 cube takes 2,240 B a group (9.2 MB at
# 4096, 16.8 MB at 7504; the f64 side cube is touched only by rows that
# are not integer): past about 22,000 groups it outgrows the H100's 50 MB
# L2, and a launch stays exact and gets slower.
KERNEL_MAX_GROUPS = 1 << 24

# op-call counters: +1 per profile_cube_cuda call whose launches were all
# accepted (each call launches a memset, the cube kernel and the cast),
# nowhere else; a scoped call counts in profile_cube_scoped_launches alone
profile_cube_launches = 0
profile_cube_scoped_launches = 0


def reset_counters() -> None:
    _launches.reset(__name__)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.profile_cube_launch, lib.profile_cube_launch_f64):
        fn.argtypes = [p, ll, i, i, i, i, i, i, i, i, p, p, i, p]
        fn.restype = i
    lib.profile_cube_launch_scoped.argtypes = [
        p, ll, i, i, i, i, i, i, i, i, p, ll, ll, ll, i, p, p, i, p]
    lib.profile_cube_launch_scoped.restype = i
    lib.profile_cube_design.argtypes = [i]
    lib.profile_cube_design.restype = i
    lib.profile_cube_band_groups.argtypes = []
    lib.profile_cube_band_groups.restype = i
    lib.profile_cube_max_groups.argtypes = []
    lib.profile_cube_max_groups.restype = i
    lib.profile_cube_work_bytes.argtypes = [ll, i]
    lib.profile_cube_work_bytes.restype = ll


LIBRARY = _build.Library("profile_cube", CSRC, SOURCES, _bind)
library_path, _lib = LIBRARY.path, LIBRARY.get


DESIGNS = ("global", "shared")


def band_groups() -> int:
    """The most groups one block's private cube in shared memory holds
    (the shared design's limit): the kernel's compile-time constant, read
    from the library."""
    return _lib().profile_cube_band_groups()


def max_groups() -> int:
    """The most groups one launch takes, read from the library (equal to
    :data:`KERNEL_MAX_GROUPS`)."""
    return _lib().profile_cube_max_groups()


def design(n_groups: int, device=None) -> str:
    """The kernel's design for ``n_groups`` on ``device`` (the current CUDA
    device by default): ``"shared"`` when each block keeps a private cube
    in shared memory (up to :func:`band_groups`), ``"global"`` when every
    row adds into the global cube."""
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.profile_cube_design(int(n_groups))
    if code < 0:
        LIBRARY.check(-code, "design query")
    return DESIGNS[code]


def profile_cube_cuda(cols: torch.Tensor, *, n_groups: int, gid_col: int,
                      size_col: int, blocks_col: int, age_col: int,
                      valid_col: int, sb_col: int, ab_col: int,
                      out_dtype: torch.dtype = torch.float32,
                      perm: Optional[torch.Tensor] = None,
                      sid: Optional[int] = None) -> torch.Tensor:
    """cols: (n_cols, N) f32 contiguous CUDA, N > 0. Returns the
    (N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS) cube, each cell its exact
    sum rounded once to ``out_dtype`` (f32, or f64 for the column store's
    partial cubes, which scatter-adds maintain). ``valid_col``, ``sb_col``
    and ``ab_col`` may be -1 (all rows valid; bucketize size / age from the
    raw rows); ``age_col`` is not read when ``ab_col`` >= 0. ``n_groups``
    may reach :data:`KERNEL_MAX_GROUPS`.

    ``perm`` ((Sp, ceil(N / 32)) i32 CUDA, one packed bitset a subject,
    bit b of word w covering row w * 32 + b: one group's slice of the
    column store's permissions plane) and ``sid`` (in ``[0, Sp)``) bin only
    the rows subject ``sid`` may see; a row whose bit is 0 weighs 0."""
    if not 1 <= n_groups <= KERNEL_MAX_GROUPS:
        raise ValueError(f"n_groups={n_groups} outside [1, "
                         f"{KERNEL_MAX_GROUPS}]: a group id past 2^24 is not "
                         "exact in the f32 gid row")
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
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"out_dtype must be torch.float32 or torch.float64, "
                        f"got {out_dtype}")
    scoped = perm is not None
    if scoped != (sid is not None):
        raise ValueError("perm and sid go together: both scope a launch")
    if scoped:
        if not isinstance(perm, torch.Tensor) or perm.device != cols.device:
            raise ValueError(f"perm must be a tensor on {cols.device}")
        if perm.dtype != torch.int32 or perm.dim() != 2 \
                or not perm.is_contiguous():
            raise ValueError("perm must be a contiguous (Sp, W) int32 "
                             "tensor")
        if perm.shape[1] != -(-n // 32):
            raise ValueError(f"perm {tuple(perm.shape)} does not cover {n} "
                             f"rows: (Sp, {-(-n // 32)}) expected")
        if not 0 <= int(sid) < perm.shape[0]:
            raise ValueError(f"sid={int(sid)} outside [0, {perm.shape[0]})")
    dev = cols.device
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        work = torch.empty((lib.profile_cube_work_bytes(n, n_groups),),
                           dtype=torch.uint8, device=dev)
        out = torch.empty((N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS),
                          dtype=out_dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (cols.data_ptr(), n, n_groups, gid_col, size_col, blocks_col,
                age_col if ab_col < 0 else -1, valid_col, sb_col, ab_col)
        if scoped:
            err = lib.profile_cube_launch_scoped(
                *args, perm.data_ptr(), perm.shape[0], int(sid),
                perm.shape[1], int(out_dtype == torch.float64),
                work.data_ptr(), out.data_ptr(), sms, stream)
        else:
            launch = lib.profile_cube_launch \
                if out_dtype == torch.float32 else lib.profile_cube_launch_f64
            err = launch(*args, work.data_ptr(), out.data_ptr(), sms, stream)
    LIBRARY.check(err, "launch")
    _launches.count(__name__, "profile_cube_scoped_launches" if scoped
                    else "profile_cube_launches")
    return out
