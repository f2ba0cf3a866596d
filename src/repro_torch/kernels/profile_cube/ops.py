"""Public profile-cube op: packs columns and runs the CUDA kernel for a CUDA
device, the plain PyTorch version for the CPU, and nothing else.

``profile_cube`` turns four aligned columns (dense group id, size, blocks,
age-in-seconds) into the (3, B, S, A) count/volume/spc_used cube in one
launch. The kernel masks its own ragged edge, so neither rows nor groups
are padded.

``use_kernel=None`` picks by the device. ``use_kernel=True`` on the CPU
raises (there is no kernel to run there) and so does ``use_kernel=False``
on a CUDA device: the plain version serves the CPU only here (call
``ref.profile_cube_ref`` directly to run it on the card).

:func:`mesh_profile_cube` is the device column store's cube plane: one
partial cube a shard group from the store's resident ``(D, n_cols, Rp)``
tensor (the kernel on the card, one launch a group; the plain version on
the CPU), exact in f64, and their sum over the groups.
:func:`mesh_cube_combine` re-sums partials the store has kept up to date
by scatter-adds. :func:`mesh_scoped_cube` is one subject's cube from the
same tensor and the store's permissions plane, built per query.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .._launches import kernel_for
from ..policy_scan.ops import _check_plane
from ..policy_scan.ref import subject_bits
from .kernel import profile_cube_cuda
from .ref import A_BUCKETS, N_MEASURES, S_BUCKETS, profile_cube_ref

__all__ = ["MAX_GROUPS", "mesh_cube_combine", "mesh_profile_cube",
           "mesh_scoped_cube", "profile_cube"]

# The op's cap, as the reference's: catalogs with more distinct (owner,
# group, type, hsm) combinations take the host groupby path (see
# core.profiles). The kernel itself takes up to kernel.KERNEL_MAX_GROUPS,
# which the store's cube plane (mesh_profile_cube) reaches.
MAX_GROUPS = 4096


def profile_cube(gid, size, blocks, age, n_groups: int, valid=None,
                 sb=None, ab=None, use_kernel: Optional[bool] = None,
                 device=None) -> np.ndarray:
    """Fused bucketize + segment-reduce over aligned entry columns.

    Returns the (N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS) f32 numpy cube:
    measure 0 counts, 1 sums ``size``, 2 sums ``blocks``; rows land in
    ``[gid, size_profile_bucket(size), age_profile_bucket(age)]``.

    ``sb``/``ab`` (optional) are precomputed bucket-index columns: pass
    them when raw sizes/ages exceed the f32 integer range (~2**24), where
    the f32 cast could round a value across a bucket edge —
    ``core.profiles`` always does, so bucket assignment matches its int64
    tables exactly. The columns go to ``device`` (default the CUDA card;
    ``"cpu"`` runs the plain version). The kernel sums exactly (u64 for
    integer rows, f64 for the others) and rounds each cell to f32 once; the
    plain version sums in f32, exact for integer measures up to 2**24 per
    cell. The incremental host path in
    ``core.profiles`` keeps int64 precision end-to-end.
    """
    if n_groups > MAX_GROUPS:
        raise ValueError(f"n_groups={n_groups} exceeds the on-device cap "
                         f"{MAX_GROUPS}; use the host groupby path")
    dev = resolve_device(device)
    kernel = kernel_for(dev, use_kernel, "profile_cube",
                        "ref.profile_cube_ref")
    n = len(np.asarray(gid))
    if n_groups <= 0 or n == 0:
        return np.zeros((N_MEASURES, max(n_groups, 0), S_BUCKETS, A_BUCKETS),
                        np.float32)
    if valid is None:
        valid = np.ones(n, np.float32)
    prebucketed = sb is not None and ab is not None
    parts = (gid, size, blocks, age, sb, ab, valid) if prebucketed \
        else (gid, size, blocks, age, valid)
    cols = torch.from_numpy(np.stack([np.asarray(c, np.float32)
                                      for c in parts])).to(dev)
    kw = dict(n_groups=n_groups, gid_col=0, size_col=1, blocks_col=2,
              age_col=3, valid_col=6 if prebucketed else 4,
              sb_col=4 if prebucketed else -1,
              ab_col=5 if prebucketed else -1)
    cube = profile_cube_cuda(cols, **kw) if kernel \
        else profile_cube_ref(cols, **kw)
    return cube.cpu().numpy()


# -- the store's cube plane --------------------------------------------------

def mesh_profile_cube(global_cols: torch.Tensor, *, n_groups: int,
                      gid_col: int, size_col: int, blocks_col: int,
                      sb_col: int, ab_col: int, valid_col: int,
                      use_kernel: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group partial cubes and their sum over the groups.

    ``global_cols`` is the device store's ``(D, n_cols, Rp)`` f32 tensor:
    each group's gid / size-bucket / age-bucket rows (bucketized exactly on
    the host) beside its kernel columns and 0/1 validity row. Returns
    ``(partials, combined)``:

    * ``partials``: (D, N_MEASURES, n_groups * S * A) f64, one flat partial
      cube a group, which the store keeps on the device and maintains by
      signed scatter-adds;
    * ``combined``: (N_MEASURES, n_groups, S, A) f64, their sum.

    On a CUDA tensor the kernel runs once a group over ``global_cols[g]``
    (a contiguous ``(n_cols, Rp)`` slice; ``age_col`` is not read, the age
    bucket row is given) and writes its exact sums as f64: D launches, up
    to ``kernel.KERNEL_MAX_GROUPS`` groups. On a CPU tensor the plain
    version sums the group's columns cast to f64. Both are exact below
    2**53, so they equal the reference's f32 cubes wherever those are
    exact, and stay exact after a scatter-add shrinks a cell (an f32 cell
    keeps the rounding of its first size). ``use_kernel`` as
    :func:`profile_cube`.
    """
    kernel = kernel_for(global_cols.device, use_kernel, "profile_cube",
                        "ref.profile_cube_ref")
    kw = dict(n_groups=n_groups, gid_col=gid_col, size_col=size_col,
              blocks_col=blocks_col, age_col=size_col, valid_col=valid_col,
              sb_col=sb_col, ab_col=ab_col)
    if kernel:
        parts = [profile_cube_cuda(g, out_dtype=torch.float64, **kw)
                 for g in global_cols]
    else:
        parts = [profile_cube_ref(g.to(torch.float64), **kw)
                 for g in global_cols]
    partials = torch.stack([p.reshape(N_MEASURES, -1) for p in parts])
    return partials, mesh_cube_combine(partials).reshape(
        N_MEASURES, n_groups, S_BUCKETS, A_BUCKETS)


def mesh_scoped_cube(global_cols: torch.Tensor, perm: torch.Tensor,
                     subject, *, n_groups: int, gid_col: int, size_col: int,
                     blocks_col: int, sb_col: int, ab_col: int,
                     valid_col: int, use_kernel: Optional[bool] = None
                     ) -> torch.Tensor:
    """One subject's profile cube over the store's resident rows.

    ``perm`` is the store's (D, Sp, Rp / 32) int32 permissions plane (one
    packed bitset a group and subject, bit b of word w covering row
    w * 32 + b) and ``subject`` a subject id. Returns the (N_MEASURES,
    n_groups, S, A) f64 cube of the rows that subject may see, summed over
    the groups on the columns' device. There are no resident scoped
    partials: each query builds its cube.

    On a CUDA tensor the kernel runs once a group, scoped (the subject's
    bit ANDed into each row's validity weight, f64 cells); on a CPU tensor
    the plain version bins each group's columns cast to f64 with the
    validity row masked by the subject's bits, as the reference does. Both
    are exact below 2**53. ``use_kernel`` as :func:`profile_cube`.
    """
    kernel = kernel_for(global_cols.device, use_kernel, "profile_cube",
                        "ref.profile_cube_ref")
    _check_plane(global_cols, perm, subject)
    kw = dict(n_groups=n_groups, gid_col=gid_col, size_col=size_col,
              blocks_col=blocks_col, age_col=size_col, valid_col=valid_col,
              sb_col=sb_col, ab_col=ab_col)
    total = None
    for g, cols in enumerate(global_cols):
        if kernel:
            cube = profile_cube_cuda(cols, out_dtype=torch.float64,
                                     perm=perm[g], sid=int(subject), **kw)
        else:
            c = cols.to(torch.float64, copy=True)
            c[valid_col] = torch.where(subject_bits(perm[g], subject),
                                       c[valid_col], c.new_zeros(()))
            cube = profile_cube_ref(c, **kw)
        total = cube if total is None else total + cube
    return total


def mesh_cube_combine(partials: torch.Tensor) -> torch.Tensor:
    """Sum the (D, N_MEASURES, B*S*A) f64 partial cubes over the groups on
    their device: only the cube crosses to the host after."""
    return partials.sum(dim=0)
