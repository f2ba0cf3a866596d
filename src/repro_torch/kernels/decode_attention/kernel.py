"""Build, bind and launch the hand-written ``decode_attention`` CUDA
kernels.

The source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :mod:`repro_torch.kernels._build`).

:func:`decode_attention_cuda` replaces no TPU kernel (the reference's
attention is plain JAX): it is the decode step's attention of one query
position over a contiguous K/V cache, each staged K/V row serving every
query head of its KV head, with an online softmax in f32. A split kernel
covers a part of the positions a block and, when the shapes ask for more
than one split, a combine kernel merges the splits in order. It counts its
calls in ``decode_attention_launches`` (one a call) and its combine
launches in ``decode_attention_combine_launches`` (a launch captured into a
CUDA graph counts on each replay, see :mod:`repro_torch.kernels._launches`),
takes CUDA tensors only and raises on anything else: there is no fallback
here. The plain version lives in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build, _launches

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("decode_attention.cu",)
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16                     # bytes: the kernel's bulk copies of rows

# launch counters: +1 per op call (the split kernel, and the combine when
# the shapes ask for more than one split); +1 per combine launch
decode_attention_launches = 0
decode_attention_combine_launches = 0

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def reset_counters() -> None:
    global decode_attention_launches, decode_attention_combine_launches
    decode_attention_launches = 0
    decode_attention_combine_launches = 0


def build() -> Path:
    """Compile ``csrc/`` into the shared library unless it already exists.
    Returns its path."""
    return _build.build("decode_attention", CSRC, SOURCES)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            f = ctypes.c_float
            lib.decode_attention_launch.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                ll, ll, ll, ll, ll, ll, i, ll, f, f, p]
            lib.decode_attention_launch.restype = i
            lib.decode_attention_splits.argtypes = [i, i, i, i, i, i]
            lib.decode_attention_splits.restype = i
            lib.decode_attention_launch_shape.argtypes = [
                i, i, i, i, i, i, ctypes.POINTER(i)]
            lib.decode_attention_launch_shape.restype = i
            lib.decode_attention_error_string.argtypes = [i]
            lib.decode_attention_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> Optional[str]:
    """Why the kernel does not take these q, k, v, or None when it does
    (any device: the device is checked on its own). q: (B, 1, H, hd)
    contiguous, f32 or bf16; k, v: (B, L, K, hd) of one dtype, f32 or
    bf16, H a multiple of K, hd a multiple of 8 up to 256, the last dim
    contiguous and the data and other strides on 16 B."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            return f"{name} must be a tensor"
        if t.dim() != 4:
            return f"{name} must have 4 dimensions, got {tuple(t.shape)}"
        if t.dtype not in DTYPES:
            return f"{name} must be float32 or bfloat16, got {t.dtype}"
    if k.dtype != v.dtype:
        return f"k is {k.dtype}, v {v.dtype}"
    B, Sq, H, hd = q.shape
    if Sq != 1:
        return f"one query position a sequence, got {Sq}"
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        return (f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                f"(B={B}, L, K, hd={hd})")
    K = k.shape[2]
    if B == 0 or K == 0 or k.shape[1] == 0 or H % K != 0:
        return f"{H} query heads over {K} KV heads, {k.shape[1]} positions"
    if hd % 8 != 0 or not 8 <= hd <= MAX_HEAD_DIM:
        return f"head_dim {hd} is not a multiple of 8 in [8, {MAX_HEAD_DIM}]"
    if not q.is_contiguous():
        return "q must be contiguous"
    for name, t in (("k", k), ("v", v)):
        esize = t.element_size()
        if t.stride(3) != 1 or t.data_ptr() % _ALIGN != 0 or any(
                s * esize % _ALIGN for s in t.stride()[:3]):
            return (f"{name} must have a contiguous last dim and its data "
                    f"and strides on {_ALIGN} B, got strides {t.stride()}")
    return None


def _check(q, k, v, q_pos, kv_pos) -> None:
    why = refusal(q, k, v)
    if why is not None:
        raise ValueError(f"decode_attention: {why}")
    L = k.shape[1]
    for name, t, shape in (("q_pos", q_pos, (1,)), ("kv_pos", kv_pos, (L,))):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"int64 tensor of shape {shape}")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the decode_attention "
                             "kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def splits(B: int, K: int, G: int, L: int, hd: int,
           kv_dtype: torch.dtype) -> int:
    """The splits of the positions a call of these shapes makes (from the
    shapes alone): above 1, a combine kernel follows the split kernel."""
    return _lib().decode_attention_splits(DTYPES[kv_dtype], B, K, G, L, hd)


SHAPE_FIELDS = ("tile_rows", "stages", "splits", "blocks", "threads",
                "smem_bytes", "blocks_per_sm", "registers", "local_bytes")


def launch_shape(B: int, K: int, G: int, L: int, hd: int,
                 kv_dtype: torch.dtype) -> Dict[str, int]:
    """The split kernel's launch for these shapes on the current device:
    K/V rows a tile, ring stages, splits, blocks, threads a block, dynamic
    shared bytes a block, resident blocks an SM, registers a thread and
    local (spilled) bytes a thread."""
    lib = _lib()
    out = (ctypes.c_int * len(SHAPE_FIELDS))()
    err = lib.decode_attention_launch_shape(DTYPES[kv_dtype], B, K, G, L,
                                            hd, out)
    if err != 0:
        raise RuntimeError("decode_attention_launch_shape failed: "
                           f"{lib.decode_attention_error_string(err).decode()}")
    return dict(zip(SHAPE_FIELDS, out))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          logit_softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k, v: (B, L, K, hd) (the cache as it lies: any
    strides on 16 B with the last dim contiguous); q_pos (1,) and kv_pos
    (L,) integer positions, -1 an empty slot; all on one CUDA device
    (:func:`refusal` says what else). ``scale`` defaults to 1 / sqrt(hd); ``logit_softcap``
    None or above 0. Returns (B, 1, H, hd) in q's dtype. Reads nothing back
    to the host, so a CUDA graph can capture it."""
    if isinstance(q_pos, torch.Tensor) and isinstance(kv_pos, torch.Tensor):
        q_pos, kv_pos = (t.to(torch.int64).contiguous() for t in (q_pos,
                                                                  kv_pos))
    _check(q, k, v, q_pos, kv_pos)
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap {logit_softcap} must be above 0")
    B, _, H, hd = q.shape
    L, K = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    lib = _lib()
    n = lib.decode_attention_splits(DTYPES[k.dtype], B, K, H // K, L, hd)
    out = torch.empty_like(q)
    work = (torch.empty((B, H, n, hd + 2), dtype=torch.float32,
                        device=q.device) if n > 1 else None)
    err = _launches.launch(
        lib.decode_attention_launch, q.device.index, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        out.data_ptr(), work.data_ptr() if work is not None else None,
        DTYPES[q.dtype], DTYPES[k.dtype], B, H, K, L, hd, *k.stride()[:3],
        *v.stride()[:3], int(causal), int(window), scale,
        logit_softcap or 0.0)
    if err != 0:
        raise RuntimeError("decode_attention launch failed: "
                           f"{lib.decode_attention_error_string(err).decode()}")
    _launches.count(__name__, "decode_attention_launches")
    if n > 1:
        _launches.count(__name__, "decode_attention_combine_launches")
    return out
