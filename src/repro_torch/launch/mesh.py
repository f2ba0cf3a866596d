"""Production meshes (the reference's ``launch/mesh.py``), as
``torch.distributed`` device meshes.

single-pod: (16, 16) = ("data", "model")     — 256 devices
multi-pod:  (2, 16, 16) = ("pod", "data", "model") — 512 devices

FUNCTIONS (not module constants), so importing touches no process group.
A mesh spans the ranks of the default process group, which the caller
initializes (``torch.distributed.init_process_group``: NCCL on the card,
gloo on the CPU, the ``"fake"`` backend for the dry run); ``device``
picks the mesh's device type, the card unless the caller asks for the
CPU.

Per-device constants for the roofline (``launch/roofline.py``), from
NVIDIA's H100 SXM5 data sheet (dense rates, no sparsity, at the 700 W
limit): bf16 989 TFLOP/s; HBM3 3.35 TB/s (the figure the kernels' bounds
in ``chip_smoke.py`` use); NVLink 4 900 GB/s per GPU, the sum of both
directions over its 18 links. The collective term divides a device's
wire bytes (what it sends, by the ring factors of the roofline) by
``NVLINK_BW`` = 450e9 B/s, one direction of that 900 GB/s: in a ring each
device sends and receives its wire bytes at once.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

# NVIDIA H100 SXM5 constants (per device) for the roofline analysis
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s each way (900 GB/s both ways, 18 links)


def _world(n: int, shape: Tuple[int, ...]) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, and no process group is "
            "initialized: call torch.distributed.init_process_group first "
            "(launch/dryrun.py starts the fake backend with 512 ranks)")
    return dist.get_world_size()


def _device_mesh(shape: Tuple[int, ...], axes: Sequence[str],
                 dev: torch.device) -> DeviceMesh:
    n = int(np.prod(shape))
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> DeviceMesh:
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = _world(n, shape)
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have}; run the dry run "
            "(launch/dryrun.py starts the fake backend with 512 ranks)")
    # more ranks than the mesh needs (e.g. 512 present, single-pod 256):
    # the first n
    return _device_mesh(shape, axes, dev)


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """Small helper for tests (arbitrary meshes over the first ranks)."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    have = _world(n, shape)
    if have < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {have}")
    return _device_mesh(shape, axes, dev)


def make_shards_mesh(n_devices: int = 0, device=None) -> DeviceMesh:
    """1-D ``("shards",)`` mesh for the sharded catalog data plane.

    ``n_devices=0`` takes every rank. (The port's column store keeps its
    shard groups in one tensor on one card, ``core/device_store.py``; this
    mesh is the reference's surface for callers that spread them.)
    """
    dev = resolve_device(device)
    have = _world(n_devices or 1, (n_devices,))
    n = n_devices or have
    if n > have:
        raise RuntimeError(
            f"need {n} ranks for a ({n},)-shards mesh, have {have}")
    return _device_mesh((n,), ("shards",), dev)
