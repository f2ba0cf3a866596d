"""Build, bind and launch the hand-written ``paged_attention`` CUDA kernels.

The source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (see :class:`repro_torch.kernels._build.Library`).

:func:`paged_attention_cuda` replaces the Pallas ``paged_attention``: one
query token per sequence attends over its K/V pages through the page
table, with grouped query heads and an online softmax in f32. The page
axis is split over blocks (flash-decoding): a split kernel covers
:func:`pages_per_split` readable pages of a sequence a block and, when a
table has more than one split's width, a combine kernel merges the splits
in order. It counts its calls in ``paged_attention_launches`` (one a call,
whatever it launches) and its combine launches in
``paged_attention_combine_launches``, takes CUDA tensors only and raises
on anything else: there is no fallback here. The plain version lives in
``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build, _launches

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu",)
MAX_HEAD_DIM = 256
MAX_SPLITS = 4096               # the combine's weights in shared memory
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = {torch.float32: "split f32 CUDA cores",
           torch.bfloat16: "split bf16 mma"}

# launch counters: +1 per op call (split kernel, and the combine when the
# table is wider than one split); +1 per combine launch
paged_attention_launches = 0
paged_attention_combine_launches = 0


def reset_counters() -> None:
    _launches.reset(__name__)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_split_launch.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.paged_attention_split_launch.restype = i
    lib.paged_attention_combine_launch.argtypes = [p, p, i, i, i, i, i, p]
    lib.paged_attention_combine_launch.restype = i
    lib.paged_attention_pages_per_split.restype = i
    lib.paged_attention_blocks_per_sm.argtypes = [i, i, i, i, i]
    lib.paged_attention_blocks_per_sm.restype = i
    lib.paged_attention_threads.argtypes = [i, i, i]
    lib.paged_attention_threads.restype = i
    lib.paged_attention_shared_bytes.argtypes = [i, i, i, i, i]
    lib.paged_attention_shared_bytes.restype = ctypes.c_longlong


LIBRARY = _build.Library("paged_attention", CSRC, SOURCES, _bind)
_lib = LIBRARY.get


def pages_per_split() -> int:
    """Readable pages a block of the split kernel covers: the kernel's
    compile-time constant, read from the library."""
    return _lib().paged_attention_pages_per_split()


def n_splits(max_pages: int) -> int:
    """Splits of a table ``max_pages`` wide (at least 1): the split
    kernel's third grid axis, from the table's width alone."""
    return max(1, -(-max_pages // pages_per_split()))


def occupancy(dtype: torch.dtype, n_heads: int, n_kv: int, head_dim: int,
              page_size: int, device=None) -> dict:
    """The split kernel's launch shape for these widths on ``device`` (the
    current CUDA device by default): its design, threads a block, dynamic
    shared bytes a block and blocks an SM holds at once."""
    lib = _lib()
    code = DTYPES[dtype]
    with torch.cuda.device(device):
        per_sm = lib.paged_attention_blocks_per_sm(
            code, n_heads, n_kv, head_dim, page_size)
    if per_sm < 0:
        LIBRARY.check(-per_sm, "occupancy query")
    return {"design": DESIGNS[dtype],
            "threads": lib.paged_attention_threads(code, n_heads, n_kv),
            "shared_bytes": lib.paged_attention_shared_bytes(
                code, n_heads, n_kv, head_dim, page_size),
            "blocks_per_sm": per_sm}


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k_pages, v_pages: (n_pages, P, K, hd), all one dtype
    (f32 or bf16), contiguous, on one CUDA device; page_table: (B,
    max_pages) i32; lengths: (B,) i32. Returns (B, H, hd) in q's dtype.

    Page ids of -1 are masked; the kernel skips ids outside
    ``[0, n_pages)`` too, so it never reads out of bounds (the op raises on
    them before the launch)."""
    named = (("q", q, 3), ("k_pages", k_pages, 4), ("v_pages", v_pages, 4),
             ("page_table", page_table, 2), ("lengths", lengths, 1))
    for name, t, dim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: the paged_attention "
                             "kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dimensions, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q, k_pages and v_pages must share a dtype: "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    B, H, hd = q.shape
    n_pages, P, K, hd_kv = k_pages.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"v_pages {tuple(v_pages.shape)} differs from "
                         f"k_pages {tuple(k_pages.shape)}")
    if hd_kv != hd or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must agree (q {hd}, pages {hd_kv}) and "
                         f"lie in [1, {MAX_HEAD_DIM}]")
    if n_pages < 1 or P < 1 or K < 1 or H < 1 or H % K:
        raise ValueError(f"need n_pages, P, K >= 1 and H % K == 0 (H={H}, "
                         f"K={K}, n_pages={n_pages}, P={P})")
    if page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} and lengths "
                         f"{tuple(lengths.shape)} must have B={B} rows")
    splits = n_splits(page_table.shape[1])
    if splits > MAX_SPLITS:
        raise ValueError(f"page_table is {page_table.shape[1]} pages wide: "
                         f"at most {MAX_SPLITS * pages_per_split()}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    work = None
    if splits > 1:
        work = torch.empty((B, H, splits, hd + 2), dtype=torch.float32,
                           device=q.device)
    lib = _lib()
    code = DTYPES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LIBRARY.check(lib.paged_attention_split_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), code, B, H, K, hd, P,
            n_pages, page_table.shape[1], stream), "split launch")
        _launches.count(__name__, "paged_attention_launches")
        if work is not None:
            LIBRARY.check(lib.paged_attention_combine_launch(
                work.data_ptr(), out.data_ptr(), code, B, H, hd, splits,
                stream), "combine launch")
            _launches.count(__name__, "paged_attention_combine_launches")
    return out
