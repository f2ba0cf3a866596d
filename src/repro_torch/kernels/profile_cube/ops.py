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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from .kernel import MAX_GROUPS, profile_cube_cuda
from .ref import A_BUCKETS, N_MEASURES, S_BUCKETS, profile_cube_ref

__all__ = ["MAX_GROUPS", "profile_cube"]


def _kernel_for(dev: torch.device, use_kernel: Optional[bool]) -> bool:
    on_card = dev.type == "cuda"
    if use_kernel is None:
        return on_card
    if use_kernel and not on_card:
        raise ValueError("use_kernel=True needs a CUDA device: the "
                         f"profile_cube kernel does not run on {dev}")
    if not use_kernel and on_card:
        raise ValueError("use_kernel=False on a CUDA device: the plain "
                         "version serves the CPU only (call "
                         "ref.profile_cube_ref directly to run it on the "
                         "card)")
    return bool(use_kernel)


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
    kernel = _kernel_for(dev, use_kernel)
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
