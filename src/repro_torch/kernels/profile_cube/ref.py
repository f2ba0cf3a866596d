"""Plain PyTorch version of the fused profile-cube build.

The *profile cube* is the paper's "synthetic understanding of file systems
contents" as one dense tensor: count / volume / spc_used histograms
bucketed by profile group (a dense code for one (owner, group, type,
hsm_state) combination) × size-profile bucket × age bucket. One columnar
pass bucketizes every row and segment-reduces the three measures.

This is the semantics authority the CUDA kernel is held to, on any device.
It computes in the dtype of the columns it is given: f32 columns sum in
f32 (``index_add_`` rounds at every add once a cell passes 2^24), f64
columns sum exactly for the integer values this path carries.
"""
from __future__ import annotations

import torch

N_MEASURES = 3       # count, volume (bytes), spc_used (allocated bytes)
S_BUCKETS = 10       # size-profile buckets (core.types.SIZE_PROFILE_EDGES)
A_BUCKETS = 7        # age-profile buckets (core.types.AGE_PROFILE_EDGES)

# bucket edges: mirrors of core.types.SIZE_PROFILE_EDGES /
# AGE_PROFILE_EDGES, all exact in f32
SIZE_EDGE_VALS = (0.0, 1.0, 32.0, float(1 << 10), float(32 << 10),
                  float(1 << 20), float(32 << 20), float(1 << 30),
                  float(32 << 30), float(1 << 40))
AGE_EDGE_VALS = (0.0, 3600.0, 86400.0, 7 * 86400.0, 30 * 86400.0,
                 90 * 86400.0, 365 * 86400.0)


def _buckets(x: torch.Tensor, edges, n: int) -> torch.Tensor:
    b = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for e in edges:
        b += (x >= e).to(torch.int32)
    return (b - 1).clamp_(0, n - 1)


def size_buckets(size: torch.Tensor) -> torch.Tensor:
    """(N,) sizes -> (N,) i32 size-profile bucket indices."""
    return _buckets(size, SIZE_EDGE_VALS, S_BUCKETS)


def age_buckets(age: torch.Tensor) -> torch.Tensor:
    """(N,) ages (seconds) -> (N,) i32 age-profile bucket indices."""
    return _buckets(age, AGE_EDGE_VALS, A_BUCKETS)


def profile_cube_ref(cols: torch.Tensor, n_groups: int, gid_col: int = 0,
                     size_col: int = 1, blocks_col: int = 2,
                     age_col: int = 3, valid_col: int = -1,
                     sb_col: int = -1, ab_col: int = -1) -> torch.Tensor:
    """(N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS) cube, dtype of ``cols``.

    cols: (n_cols, N) f32 or f64 with rows [gid, size, blocks, age(,
    valid)]. Invalid rows contribute nothing (their gid may be garbage:
    it is clipped into range and weighted by 0). ``sb_col``/``ab_col``
    point at precomputed bucket-index rows (exact host bucketization); -1
    bucketizes from the raw size/age rows.
    """
    gid = cols[gid_col].to(torch.int32)
    size = cols[size_col]
    blocks = cols[blocks_col]
    valid = cols[valid_col] if valid_col >= 0 else torch.ones_like(size)
    sb = cols[sb_col].to(torch.int32) if sb_col >= 0 \
        else size_buckets(size)
    sb = sb.clamp(0, S_BUCKETS - 1)
    ab = cols[ab_col].to(torch.int32) if ab_col >= 0 \
        else age_buckets(cols[age_col])
    ab = ab.clamp(0, A_BUCKETS - 1)
    flat = ((gid.clamp(0, n_groups - 1) * S_BUCKETS + sb) * A_BUCKETS
            + ab).to(torch.int64)
    k = n_groups * S_BUCKETS * A_BUCKETS
    out = torch.zeros((N_MEASURES, k), dtype=cols.dtype, device=cols.device)
    out[0].index_add_(0, flat, valid)
    out[1].index_add_(0, flat, valid * size)
    out[2].index_add_(0, flat, valid * blocks)
    return out.reshape(N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS)


def banded_cube_ref(cols: torch.Tensor, n_groups: int, gid_col: int = 0,
                    size_col: int = 1, blocks_col: int = 2,
                    age_col: int = 3, valid_col: int = -1,
                    sb_col: int = -1, ab_col: int = -1, *,
                    band: int) -> torch.Tensor:
    """The banded order of work on the CPU, for tests: rows with a non-zero
    weight are partitioned by the band of their clipped gid
    (``gid // band``), each band's rows are summed on their own into a cube
    ``band`` groups wide, and the bands are assembled, as the banded design
    of ``tools/profile_cube_designs.cu`` does on the card. Equal to
    :func:`profile_cube_ref` wherever its sums are exact."""
    w = cols[valid_col] if valid_col >= 0 else torch.ones_like(cols[0])
    gid = cols[gid_col].to(torch.int32).clamp(0, n_groups - 1)
    kw = dict(gid_col=gid_col, size_col=size_col, blocks_col=blocks_col,
              age_col=age_col, valid_col=valid_col, sb_col=sb_col,
              ab_col=ab_col)
    k = S_BUCKETS * A_BUCKETS
    out = torch.zeros((N_MEASURES, n_groups * k), dtype=cols.dtype,
                      device=cols.device)
    for lo in range(0, n_groups, band):
        width = min(band, n_groups - lo)
        rows = (w != 0) & (gid >= lo) & (gid < lo + width)
        if not bool(rows.any()):
            continue
        part = cols[:, rows].clone()
        part[gid_col] = (gid[rows] - lo).to(cols.dtype)
        out[:, lo * k:(lo + width) * k] = profile_cube_ref(
            part, width, **kw).reshape(N_MEASURES, -1)
    return out.reshape(N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS)
