"""Build, bind and launch the hand-written ``mla_decode`` CUDA kernels.

The source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :class:`repro_torch.kernels._build.Library`).

:func:`mla_decode_cuda` replaces no TPU kernel (the reference's latent
attention is plain JAX): it is the absorbed decode step's attention of one
query position over the latent cache, each 576-wide latent row read once
for all 64 query heads of a block, the products on the tensor cores and an
online softmax in f32. A split kernel covers a part of the positions a
block, a combine kernel merges the splits in order. It counts its calls in
``mla_decode_launches`` and its combine launches in
``mla_decode_combine_launches`` (one each a call; a launch captured into a
CUDA graph counts on each replay, see :mod:`repro_torch.kernels._launches`),
takes CUDA tensors only and raises on anything else: there is no fallback
here. The plain version lives in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build, _launches

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("mla_decode.cu",)
RANK = 512                      # the latent rank the kernel is built for
ROPE = 64                       # the rotary key's width beside it
HEADS_PER_BLOCK = 64            # query heads a block: the products' rows
MAX_BATCH = 65535               # the grid's third dimension
_ALIGN = 16                     # bytes: TMA's addresses and strides

# launch counters: +1 per op call (the split kernel); +1 per combine launch
mla_decode_launches = 0
mla_decode_combine_launches = 0


def reset_counters() -> None:
    _launches.reset(__name__)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mla_decode_launch.argtypes = [
        p, p, p, p, p, p, i, i, i, ll, ll, ctypes.c_float, p]
    lib.mla_decode_launch.restype = i
    lib.mla_decode_splits.argtypes = [i, i, i]
    lib.mla_decode_splits.restype = i
    lib.mla_decode_launch_shape.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.mla_decode_launch_shape.restype = i


LIBRARY = _build.Library("mla_decode", CSRC, SOURCES, _bind)
_lib = LIBRARY.get


def refusal(qf: torch.Tensor, latent: torch.Tensor, rank: int
            ) -> Optional[str]:
    """Why the kernel does not take this qf and cache, or None when it
    does (any device: the device is checked on its own). qf: (B, H, 576)
    bf16, contiguous, H a multiple of 64; latent: (B, L, 576) bf16, the
    last dim contiguous, its data and other strides on 16 B; rank 512."""
    for name, t in (("qf", qf), ("latent", latent)):
        if not isinstance(t, torch.Tensor):
            return f"{name} must be a tensor"
        if t.dim() != 3:
            return f"{name} must have 3 dimensions, got {tuple(t.shape)}"
        if t.dtype != torch.bfloat16:
            return f"{name} must be bfloat16, got {t.dtype}"
    if rank != RANK:
        return f"latent rank {rank}: the kernel is built for {RANK}"
    B, H, width = qf.shape
    if width != RANK + ROPE or tuple(latent.shape[::2]) != (B, width):
        return (f"qf {tuple(qf.shape)} and latent {tuple(latent.shape)} "
                f"must be (B, H, {RANK + ROPE}) and (B, L, {RANK + ROPE})")
    if not 1 <= B <= MAX_BATCH or latent.shape[1] == 0:
        return f"batch {B} (at most {MAX_BATCH}), {latent.shape[1]} positions"
    if H == 0 or H % HEADS_PER_BLOCK:
        return f"{H} query heads: a multiple of {HEADS_PER_BLOCK}"
    if not qf.is_contiguous() or qf.data_ptr() % _ALIGN:
        return "qf must be contiguous, its data on 16 B"
    sb, sl, sw = latent.stride()
    if sw != 1 or latent.data_ptr() % _ALIGN or any(
            s <= 0 or s * 2 % _ALIGN for s in (sb, sl)):
        return (f"latent must have a contiguous last dim and its data and "
                f"strides on {_ALIGN} B, got strides {latent.stride()}")
    return None


def _check(qf, latent, pos_t, rank) -> None:
    why = refusal(qf, latent, rank)
    if why is not None:
        raise ValueError(f"mla_decode: {why}")
    if not isinstance(pos_t, torch.Tensor) or pos_t.dtype != torch.int64 \
            or pos_t.numel() != 1:
        raise ValueError("mla_decode: pos_t must be an int64 tensor of one "
                         "element")
    for name, t in (("qf", qf), ("latent", latent), ("pos_t", pos_t)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the mla_decode "
                             "kernel takes CUDA tensors only")
        if t.device != qf.device:
            raise ValueError(f"{name} is on {t.device}, qf on {qf.device}")


def splits(B: int, H: int, L: int) -> int:
    """The splits of the positions a call of these shapes makes (from the
    shapes alone)."""
    return _lib().mla_decode_splits(B, H, L)


SHAPE_FIELDS = ("tile_rows", "stages", "splits", "blocks", "threads",
                "smem_bytes", "blocks_per_sm", "registers", "local_bytes")


def launch_shape(B: int, H: int, L: int) -> Dict[str, int]:
    """The split kernel's launch for these shapes on the current device:
    positions a tile, ring stages, splits, blocks, threads a block, dynamic
    shared bytes a block, resident blocks an SM, registers a thread and
    local (spilled) bytes a thread."""
    out = (ctypes.c_int * len(SHAPE_FIELDS))()
    LIBRARY.check(_lib().mla_decode_launch_shape(B, H, L, out),
                  "launch_shape")
    return dict(zip(SHAPE_FIELDS, out))


def mla_decode_cuda(qf: torch.Tensor, latent: torch.Tensor,
                    pos_t: torch.Tensor, scale: float, rank: int
                    ) -> torch.Tensor:
    """qf: (B, H, 576); latent: (B, L, 576), the cache as it lies (read in
    place with its strides); pos_t: the query's position, a device int64
    tensor of one element (positions 0..pos_t attended, all L past the
    end); all on one CUDA device (:func:`refusal` says what else). Returns
    (B, H, 512) bf16. Reads nothing back to the host, so a CUDA graph can
    capture it."""
    _check(qf, latent, pos_t, rank)
    B, H, _ = qf.shape
    L = latent.shape[1]
    lib = _lib()
    n = lib.mla_decode_splits(B, H, L)
    out = torch.empty((B, H, rank), dtype=torch.bfloat16, device=qf.device)
    part = torch.empty((B, H, n, rank), dtype=torch.float32,
                       device=qf.device)
    ml = torch.empty((B, H, n, 2), dtype=torch.float32, device=qf.device)
    err = _launches.launch(
        lib.mla_decode_launch, qf.device.index, qf.data_ptr(),
        latent.data_ptr(), pos_t.data_ptr(), part.data_ptr(), ml.data_ptr(),
        out.data_ptr(), B, H, L, latent.stride(0), latent.stride(1),
        float(scale))
    LIBRARY.check(err, "launch")
    _launches.count(__name__, "mla_decode_launches")
    _launches.count(__name__, "mla_decode_combine_launches")
    return out
