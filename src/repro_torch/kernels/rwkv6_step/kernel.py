"""Build, bind and launch the hand-written ``rwkv6_step`` CUDA kernel.

The source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :class:`repro_torch.kernels._build.Library`).

:func:`rwkv6_step_cuda` replaces the Pallas ``rwkv6_step_pallas``: one
RWKV6 decode token, ``y = r (S + u k v^T)`` and ``S' = diag(w) S + k v^T``
per (batch, head), one block a head and one thread a value column. It
counts its launches in a plain integer (a launch captured into a CUDA graph
counts on each replay, see :mod:`repro_torch.kernels._launches`), takes
CUDA tensors only and raises on anything else: there is no fallback here.
It returns a new state and never writes the one it reads (the kernel's
``state`` and ``state_out`` are ``__restrict__``). The plain version lives
in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from .. import _build, _launches

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rwkv6_step.cu",)
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launch counter: +1 per kernel launch, nowhere else
rwkv6_step_launches = 0


def reset_counters() -> None:
    _launches.reset(__name__)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_step_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.rwkv6_step_launch.restype = i


LIBRARY = _build.Library("rwkv6_step", CSRC, SOURCES, _bind)
_lib = LIBRARY.get


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
           ) -> Tuple[int, int, int]:
    """Raises unless the arguments are what the kernel takes; returns
    (B, H, hd)."""
    named = (("r", r, 3), ("k", k, 3), ("v", v, 3), ("w", w, 3),
             ("u", u, 2), ("state", state, 4))
    for name, t, dim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the rwkv6_step "
                             "kernel takes CUDA tensors only")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dimensions, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dtype not in DTYPES:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r {r.dtype}: the vectors "
                            "must share a dtype")
    if state.dtype != torch.float32:
        raise TypeError(f"state must be torch.float32, got {state.dtype}")
    B, H, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from r "
                             f"{tuple(r.shape)}")
    if u.shape != (H, hd) or state.shape != (B, H, hd, hd):
        raise ValueError(f"u must be ({H}, {hd}) and state ({B}, {H}, {hd}, "
                         f"{hd}); got {tuple(u.shape)}, {tuple(state.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} outside [1, {MAX_HEAD_DIM}]")
    if B * H >= 1 << 31:
        raise ValueError(f"B * H = {B * H} blocks exceed the grid")
    return B, H, hd


def rwkv6_step_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, H, hd) and u: (H, hd), one dtype (f32 or bf16);
    state: (B, H, hd, hd) f32; all contiguous on one CUDA device, hd at
    most 256. Returns (y (B, H, hd) in r's dtype, new state f32)."""
    B, H, hd = _check(r, k, v, w, u, state)
    y = torch.empty_like(r)
    new_state = torch.empty_like(state)
    if B == 0 or H == 0:
        return y, new_state
    lib = _lib()
    err = _launches.launch(
        lib.rwkv6_step_launch, r.device.index, r.data_ptr(), k.data_ptr(),
        v.data_ptr(), w.data_ptr(), u.data_ptr(), state.data_ptr(),
        y.data_ptr(), new_state.data_ptr(), DTYPES[r.dtype], B, H, hd)
    LIBRARY.check(err, "launch")
    _launches.count(__name__, "rwkv6_step_launches")
    return y, new_state
