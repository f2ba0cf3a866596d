"""Build, bind and launch the hand-written ``policy_scan`` CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :mod:`repro_torch.kernels._build`).

Two wrappers, each counting its launches in a plain integer:

* :func:`policy_scan_batch_cuda` — R programs, masks + rule index + (R, 14)
  aggregates (replaces ``policy_scan_batch_pallas``);
* :func:`policy_scan_cuda` — one program, mask + (14,) aggregates
  (replaces ``policy_scan_pallas``).

Both take CUDA tensors only and raise on anything else: there is no
fallback here. The plain version lives in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build, _launches
from .._build import build_dir  # noqa: F401  (re-exported)
from .ref import N_AGG

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("policy_scan.cu",)
HEADERS = ("policy_scan.cuh",)

# launch counters: +1 per kernel launch, nowhere else
policy_scan_launches = 0
policy_scan_batch_launches = 0

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def reset_counters() -> None:
    global policy_scan_launches, policy_scan_batch_launches
    policy_scan_launches = 0
    policy_scan_batch_launches = 0


def library_path() -> Path:
    return _build.library_path("policy_scan", CSRC, SOURCES + HEADERS)


def build() -> Path:
    """Compile ``csrc/`` into the shared library unless it already exists.
    Returns its path."""
    return _build.build("policy_scan", CSRC, SOURCES, HEADERS)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.policy_scan_launch.argtypes = [
                p, ll, i, p, p, p, i, i, i, i, i, p, p, p, p, i, p]
            lib.policy_scan_launch.restype = i
            lib.policy_scan_grid.argtypes = [ll, i]
            lib.policy_scan_grid.restype = i
            lib.policy_scan_plan.argtypes = [p, p, i, i, i, i, i, p, p, p]
            lib.policy_scan_plan.restype = i
            lib.policy_scan_occupancy.argtypes = [i, i]
            lib.policy_scan_occupancy.restype = i
            for name in ("policy_scan_tile_rows", "policy_scan_max_cols"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            lib.policy_scan_error_string.argtypes = [i]
            lib.policy_scan_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the policy_scan kernels "
                         "take CUDA tensors only")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, cols on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _grid(lib, cols: torch.Tensor) -> int:
    n_cols, n = cols.shape
    if n_cols > lib.policy_scan_max_cols():
        raise ValueError(f"{n_cols} columns: the kernel takes at most "
                         f"{lib.policy_scan_max_cols()}")
    sms = torch.cuda.get_device_properties(cols.device).multi_processor_count
    grid = lib.policy_scan_grid(n, sms)
    if grid <= 0:
        raise RuntimeError("policy_scan: the occupancy query failed")
    return grid


def launch_shape(cols: torch.Tensor, ops: torch.Tensor,
                 colidx: torch.Tensor, *, size_col: int = 0,
                 blocks_col: int = 1, valid_col: int = -1) -> dict:
    """How a launch over ``cols`` with (R, P) programs runs: its grid, and
    per pass of at most 8 programs the columns its blocks stage, the rows a
    stage holds (a tile of 1024, or a half or a quarter of one for wide
    column sets) and the ring's stages; and the resident blocks an SM of
    its widest pass. It reads the programs on the host (the launch itself
    does not). Launches nothing."""
    lib = _lib()
    grid = _grid(lib, cols)
    n_cols = cols.shape[0]
    n_progs, n_instr = ops.shape
    ops_h = np.ascontiguousarray(ops.cpu().numpy(), np.int32)
    col_h = np.ascontiguousarray(colidx.cpu().numpy(), np.int32)
    passes = []
    for p0 in range(0, n_progs, 8):
        r = min(8, n_progs - p0)
        stage = (ctypes.c_int * lib.policy_scan_max_cols())()
        rows, stages = ctypes.c_int(), ctypes.c_int()
        n_stage = lib.policy_scan_plan(
            ops_h[p0:].ctypes.data, col_h[p0:].ctypes.data, r * n_instr,
            n_cols, size_col, blocks_col, valid_col, stage,
            ctypes.byref(rows), ctypes.byref(stages))
        passes.append(dict(staged_cols=list(stage[:n_stage]),
                           stage_rows=rows.value,
                           stages=stages.value))
    return dict(grid=grid, passes=passes,
                blocks_per_sm=lib.policy_scan_occupancy(n_progs, n_instr),
                tile_rows=lib.policy_scan_tile_rows())


def _launch(cols: torch.Tensor, ops: torch.Tensor, colidx: torch.Tensor,
            operands: torch.Tensor, size_col: int, blocks_col: int,
            valid_col: int, with_rule: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    dev = cols.device
    _check(cols, "cols", torch.float32, 2, dev)
    _check(ops, "ops", torch.int32, 2, dev)
    _check(colidx, "colidx", torch.int32, 2, dev)
    _check(operands, "operands", torch.float32, 2, dev)
    n_cols, n = cols.shape
    n_progs, n_instr = ops.shape
    if colidx.shape != ops.shape or operands.shape != ops.shape:
        raise ValueError("ops, colidx and operands must share one (R, P) shape")
    if n == 0 or n_progs == 0:
        raise ValueError("policy_scan kernels need N > 0 rows and R > 0 "
                         "programs")
    for name, c in (("size_col", size_col), ("blocks_col", blocks_col)):
        if not 0 <= c < n_cols:
            raise ValueError(f"{name}={c} outside [0, {n_cols})")
    if not -1 <= valid_col < n_cols:
        raise ValueError(f"valid_col={valid_col} outside [-1, {n_cols})")
    lib = _lib()
    grid = _grid(lib, cols)
    masks = torch.empty((n_progs, n), dtype=torch.float32, device=dev)
    rule = torch.empty((n,), dtype=torch.int32, device=dev) if with_rule \
        else None
    partials = torch.empty((grid, n_progs, N_AGG), dtype=torch.float32,
                           device=dev)
    agg = torch.empty((n_progs, N_AGG), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.policy_scan_launch(
        cols.data_ptr(), n, n_cols, ops.data_ptr(), colidx.data_ptr(),
        operands.data_ptr(), n_progs, n_instr, size_col, blocks_col,
        valid_col, masks.data_ptr(),
        rule.data_ptr() if rule is not None else None, partials.data_ptr(),
        agg.data_ptr(), grid, stream)
    if err != 0:
        raise RuntimeError("policy_scan launch failed: "
                           f"{lib.policy_scan_error_string(err).decode()}")
    return masks, rule, agg


def policy_scan_batch_cuda(cols: torch.Tensor, ops: torch.Tensor,
                           colidx: torch.Tensor, operands: torch.Tensor, *,
                           size_col: int = 0, blocks_col: int = 1,
                           valid_col: int = -1
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """cols: (n_cols, N) f32 CUDA; ops/colidx (R, P) i32, operands (R, P)
    f32. Returns (masks (R, N) f32, rule_idx (N,) i32, agg (R, 14) f32)."""
    masks, rule, agg = _launch(cols, ops, colidx, operands, size_col,
                               blocks_col, valid_col, with_rule=True)
    _launches.count(__name__, "policy_scan_batch_launches")
    return masks, rule, agg


def policy_scan_cuda(cols: torch.Tensor, ops: torch.Tensor,
                     colidx: torch.Tensor, operands: torch.Tensor, *,
                     size_col: int = 0, blocks_col: int = 1,
                     valid_col: int = -1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cols: (n_cols, N) f32 CUDA; ops/colidx (P,) i32, operands (P,) f32.
    Returns (mask (N,) f32, agg (14,) f32)."""
    if ops.dim() != 1:
        raise ValueError(f"ops must be (P,), got {tuple(ops.shape)}")
    masks, _rule, agg = _launch(cols, ops[None], colidx[None],
                                operands[None], size_col, blocks_col,
                                valid_col, with_rule=False)
    _launches.count(__name__, "policy_scan_launches")
    return masks[0], agg[0]
