"""Build, bind and launch the hand-written ``policy_scan`` CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (seconds to build; nothing here includes PyTorch's headers).
The library lands in ``build/repro_torch/`` at the repository root (or in
``$REPRO_TORCH_BUILD_DIR``), named by a hash of the sources and flags, so a
changed source is rebuilt and never confused with an old build.

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
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from .ref import N_AGG

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("policy_scan.cu",)
HEADERS = ("policy_scan.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# resident blocks per SM for the grid-stride scan (256 threads each)
BLOCKS_PER_SM = 8

# launch counters: +1 per kernel launch, nowhere else
policy_scan_launches = 0
policy_scan_batch_launches = 0

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def reset_counters() -> None:
    global policy_scan_launches, policy_scan_batch_launches
    policy_scan_launches = 0
    policy_scan_batch_launches = 0


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``; else ``build/repro_torch/`` of the
    checkout this file lies in; else, for an installed package, a cache
    under ``$HOME``."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/policy_scan/kernel.py -> repository root
    root = Path(__file__).resolve().parents[4]
    if (root / "pyproject.toml").is_file() and (root / "src").is_dir():
        return root / "build" / "repro_torch"
    return Path.home() / ".cache" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = Path(cuda_home) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the policy_scan kernels are built "
                       "from csrc/ with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"libpolicy_scan_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` into the shared library unless it already exists.
    Returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)             # atomic: concurrent builds race safely
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.policy_scan_launch.argtypes = [
                p, ll, i, p, p, p, i, i, i, i, i, p, p, p, p, i, p]
            lib.policy_scan_launch.restype = i
            lib.policy_scan_tile_rows.argtypes = []
            lib.policy_scan_tile_rows.restype = i
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
    tile = lib.policy_scan_tile_rows()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-n // tile), sms * BLOCKS_PER_SM))
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
    global policy_scan_batch_launches
    masks, rule, agg = _launch(cols, ops, colidx, operands, size_col,
                               blocks_col, valid_col, with_rule=True)
    policy_scan_batch_launches += 1
    return masks, rule, agg


def policy_scan_cuda(cols: torch.Tensor, ops: torch.Tensor,
                     colidx: torch.Tensor, operands: torch.Tensor, *,
                     size_col: int = 0, blocks_col: int = 1,
                     valid_col: int = -1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cols: (n_cols, N) f32 CUDA; ops/colidx (P,) i32, operands (P,) f32.
    Returns (mask (N,) f32, agg (14,) f32)."""
    global policy_scan_launches
    if ops.dim() != 1:
        raise ValueError(f"ops must be (P,), got {tuple(ops.shape)}")
    masks, _rule, agg = _launch(cols, ops[None], colidx[None],
                                operands[None], size_col, blocks_col,
                                valid_col, with_rule=False)
    policy_scan_launches += 1
    return masks[0], agg[0]
