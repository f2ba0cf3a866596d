"""Build, bind and launch the hand-written ``wkv_chunked`` CUDA kernel.

The source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :class:`repro_torch.kernels._build.Library`).

:func:`wkv_chunked_cuda` replaces no TPU kernel (the reference's sequence
form is plain JAX): RWKV6's chunked recurrence of a whole prompt, ``y`` and
the final state from r, k, v, the log-decay lw, the bonus u and a start
state, in one launch. A block walks one (batch, head)'s chunks of 64
tokens in order with its state in shared memory, the intra-chunk scores
never leaving the SM. It counts its launches in a plain integer, takes
CUDA tensors only and raises on anything else: there is no fallback here,
and no backward (``ops.WKVChunked`` differentiates the plain version). The
plain version lives in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import _build, _launches

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("wkv_chunked.cu",)
HEAD_DIMS = (16, 64)             # rwkv6's smoke and published head widths

# launch counter: +1 per kernel launch, nowhere else
wkv_chunked_launches = 0


def reset_counters() -> None:
    _launches.reset(__name__)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv_chunked_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.wkv_chunked_launch.restype = i
    lib.wkv_chunked_launch_shape.argtypes = [i, ctypes.POINTER(i)]
    lib.wkv_chunked_launch_shape.restype = i


LIBRARY = _build.Library("wkv_chunked", CSRC, SOURCES, _bind)
_lib = LIBRARY.get


SHAPE_FIELDS = ("threads", "chunk", "smem_bytes", "blocks_per_sm",
                "registers", "local_bytes")


def launch_shape(hd: int = 64) -> Dict[str, int]:
    """The hd instantiation on the current device: threads a
    block, tokens a chunk, dynamic shared bytes a block, resident blocks an
    SM, registers a thread and local (spilled) bytes a thread."""
    lib = _lib()
    out = (ctypes.c_int * len(SHAPE_FIELDS))()
    LIBRARY.check(lib.wkv_chunked_launch_shape(hd, out),
                  "launch_shape")
    return dict(zip(SHAPE_FIELDS, out))


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lw: torch.Tensor, u: torch.Tensor, state: Optional[torch.Tensor]
           ) -> Tuple[int, int, int, int]:
    """Raises unless the arguments are what the kernel takes (their kind,
    shapes and head width first, then gradients, then the device); returns
    (B, S, H, hd)."""
    named = [("r", r, 4), ("k", k, 4), ("v", v, 4), ("lw", lw, 4),
             ("u", u, 2)]
    if state is not None:
        named.append(("state", state, 4))
    for name, t, dim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dimensions, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, S, H, hd = r.shape
    for name, t in (("k", k), ("v", v), ("lw", lw)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from r "
                             f"{tuple(r.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel takes {HEAD_DIMS}")
    if u.shape != (H, hd):
        raise ValueError(f"u must be ({H}, {hd}), got {tuple(u.shape)}")
    if state is not None and state.shape != (B, H, hd, hd):
        raise ValueError(f"state must be ({B}, {H}, {hd}, {hd}), got "
                         f"{tuple(state.shape)}")
    if B * H >= 1 << 31 or S >= 1 << 31:
        raise ValueError(f"B * H = {B * H} or S = {S} exceeds the grid")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for _, t, _ in named):
        raise RuntimeError("wkv_chunked: an input requires a gradient, and "
                           "the CUDA kernel has no backward (call the op "
                           "ops.wkv_chunked, whose backward differentiates "
                           "the plain version)")
    for name, t, _ in named:
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the wkv_chunked "
                             "kernel takes CUDA tensors only")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes")
    return B, S, H, hd


def wkv_chunked_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lw: torch.Tensor, u: torch.Tensor,
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B, S, H, hd) f32; u: (H, hd) f32; state: (B, H, hd,
    hd) f32 or None (zeros); all contiguous on one CUDA device, hd 16 or
    64, any S. Returns (y (B, S, H, hd) f32, final state (B, H, hd, hd)
    f32), both new tensors."""
    B, S, H, hd = _check(r, k, v, lw, u, state)
    y = torch.empty_like(r)
    new_state = torch.empty((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    if B == 0 or H == 0:
        return y, new_state
    lib = _lib()
    err = _launches.launch(
        lib.wkv_chunked_launch, r.device.index, r.data_ptr(), k.data_ptr(),
        v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(),
        new_state.data_ptr(), B, S, H, hd)
    LIBRARY.check(err, "launch")
    _launches.count(__name__, "wkv_chunked_launches")
    return y, new_state
