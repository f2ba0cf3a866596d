"""Build, bind and launch the hand-written ``rglru_scan`` CUDA kernels.

The source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :class:`repro_torch.kernels._build.Library`).

:func:`rglru_scan_cuda` replaces the Pallas ``rglru_pallas``: the RG-LRU
recurrence ``h_t = exp(log_a_t) h_{t-1} + b_t`` over (B, S, R) f32. The
library picks the kernel by shape inside one launch: a block of 32
channels fed by a ring of time tiles in shared memory (S of a tile or
more, R a multiple of 4, 16 B-aligned tensors), else one thread per
(batch, channel) loading straight from device memory (a decode step).
Either walks time in order, one thread a channel. It takes any B, S and
R, counts its launches in a plain integer (a launch captured into a CUDA
graph counts on each replay, see :mod:`repro_torch.kernels._launches`),
takes CUDA tensors only and raises on anything else: there is no
fallback here. :func:`rglru_scan_bwd_cuda` is its gradient, the same
kernels walking time backwards, counted in ``rglru_scan_bwd_launches``.
The plain versions live in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Set, Tuple

import torch

from .. import _build, _launches

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rglru_scan.cu",)
MAX_BATCH = 65535                   # the grid's y extent

# launch counters: +1 per kernel launch, nowhere else
rglru_scan_launches = 0
rglru_scan_bwd_launches = 0

_PREPARED: Set[int] = set()         # devices whose ring kernels are set up
_PREPARE_LOCK = threading.Lock()


def reset_counters() -> None:
    _launches.reset(__name__)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.rglru_scan_launch.restype = i
    lib.rglru_scan_bwd_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.rglru_scan_bwd_launch.restype = i
    lib.rglru_scan_prepare.argtypes = []
    lib.rglru_scan_prepare.restype = i
    lib.rglru_scan_uses_ring.argtypes = [i, i]
    lib.rglru_scan_uses_ring.restype = i
    lib.rglru_scan_ring_shape.argtypes = [i, ctypes.POINTER(i)]
    lib.rglru_scan_ring_shape.restype = i


LIBRARY = _build.Library("rglru_scan", CSRC, SOURCES, _bind)


def _lib(index: Optional[int] = None) -> ctypes.CDLL:
    """The library, with its ring kernels prepared (their dynamic shared
    memory allowed) on device ``index``, the current one by default: once
    a device, at its first use, so never while a graph is being captured
    (a capture follows an eager warm-up)."""
    lib = LIBRARY.get()
    if index is None:
        index = torch.cuda.current_device()
    if index not in _PREPARED:
        with _PREPARE_LOCK:
            if index not in _PREPARED:
                with torch.cuda.device(index):
                    LIBRARY.check(lib.rglru_scan_prepare(),
                                  "ring kernels' set-up")
                _PREPARED.add(index)
    return lib


def uses_ring(S: int, R: int) -> bool:
    """Whether a call of this S and R (on 16 B-aligned tensors) runs the
    ring kernels rather than the direct ones."""
    return bool(_lib().rglru_scan_uses_ring(S, R))


RING_FIELDS = ("threads", "group", "steps", "stages", "smem_bytes",
               "blocks_per_sm", "registers", "local_bytes")


def ring_shape(backward: bool = False) -> Dict[str, int]:
    """The forward's (or the gradient's) ring kernel on the current
    device: threads a block, channels a block, time steps a tile, stages,
    dynamic shared bytes a block, resident blocks an SM, registers a thread
    and local (spilled) bytes a thread."""
    lib = _lib()
    out = (ctypes.c_int * len(RING_FIELDS))()
    LIBRARY.check(lib.rglru_scan_ring_shape(int(backward), out),
                  "ring_shape")
    return dict(zip(RING_FIELDS, out))


def _check(log_a: torch.Tensor, b: torch.Tensor,
           h0: Optional[torch.Tensor], b_name: str = "b",
           more: Tuple[Tuple[str, torch.Tensor], ...] = ()
           ) -> Tuple[int, int, int]:
    """Raises unless the arguments are what the kernel takes; returns
    (B, S, R). ``b`` (named ``b_name``) and each tensor of ``more`` must
    have log_a's shape."""
    named = [("log_a", log_a, 3), (b_name, b, 3)]
    named += [(name, t, 3) for name, t in more]
    if h0 is not None:
        named.append(("h0", h0, 2))
    for name, t, dim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the rglru_scan "
                             "kernel takes CUDA tensors only")
        if t.device != log_a.device:
            raise ValueError(f"{name} is on {t.device}, log_a on "
                             f"{log_a.device}")
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dimensions, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, S, R = log_a.shape
    for name, t, dim in named[1:]:
        if dim == 3 and t.shape != log_a.shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from log_a "
                             f"{tuple(log_a.shape)}")
    if h0 is not None and h0.shape != (B, R):
        raise ValueError(f"h0 must be ({B}, {R}), got {tuple(h0.shape)}")
    if B > MAX_BATCH:
        raise ValueError(f"B={B} exceeds {MAX_BATCH}")
    return B, S, R


def rglru_scan_cuda(log_a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_a, b: (B, S, R) f32; h0: (B, R) f32 or None (zeros); all
    contiguous on one CUDA device. Returns h: (B, S, R) f32."""
    B, S, R = _check(log_a, b, h0)
    out = torch.empty_like(b)
    if B == 0 or S == 0 or R == 0:
        return out
    lib = _lib(log_a.device.index)
    err = _launches.launch(
        lib.rglru_scan_launch, log_a.device.index, log_a.data_ptr(),
        b.data_ptr(), None if h0 is None else h0.data_ptr(), out.data_ptr(),
        B, S, R)
    LIBRARY.check(err, "launch")
    _launches.count(__name__, "rglru_scan_launches")
    return out


def rglru_scan_bwd_cuda(log_a: torch.Tensor, h: torch.Tensor,
                        gh: torch.Tensor, h0: Optional[torch.Tensor] = None,
                        want_dh0: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """The gradient of :func:`rglru_scan_cuda`. log_a, h (its output) and
    gh (the gradient of h): (B, S, R) f32; h0: (B, R) f32 or None (zeros);
    all contiguous on one CUDA device. Returns (dlog_a, db, dh0), dh0
    (B, R) f32, or None when ``want_dh0`` is false."""
    B, S, R = _check(log_a, h, h0, "h", (("gh", gh),))
    dlog_a = torch.empty_like(log_a)
    db = torch.empty_like(gh)
    dh0 = torch.empty((B, R), dtype=torch.float32,
                      device=log_a.device) if want_dh0 else None
    if B == 0 or R == 0:
        return dlog_a, db, dh0
    if S == 0:
        if dh0 is not None:
            dh0.zero_()
        return dlog_a, db, dh0
    lib = _lib(log_a.device.index)
    err = _launches.launch(
        lib.rglru_scan_bwd_launch, log_a.device.index, log_a.data_ptr(),
        h.data_ptr(), gh.data_ptr(), None if h0 is None else h0.data_ptr(),
        dlog_a.data_ptr(), db.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), B, S, R)
    LIBRARY.check(err, "backward launch")
    _launches.count(__name__, "rglru_scan_bwd_launches")
    return dlog_a, db, dh0
