"""Roofline terms for the dry run (the reference's ``launch/roofline.py``).

Three terms per (arch, shape, mesh), in seconds, per device, from NVIDIA
H100 SXM5 data-sheet constants (``launch/mesh.py``): estimates, not
measurements.

    compute    = FLOPs_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bandwidth
    collective = collective_wire_bytes_per_device / NVLink bandwidth

The reference reads its numbers from XLA's compiled, partitioned module:
``cost_analysis`` FLOPs and bytes, and the collectives of the optimized
HLO. PyTorch has neither, so the port counts what one rank runs in the
dry run's traced step (``launch/dryrun.py``):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions and attention; elementwise work is not counted, as in
  XLA's count it is small);
* bytes: :class:`BytesMode`, the bytes of every operation's tensor inputs
  and outputs (views excluded): an unfused count, where XLA counts a
  fusion's operands once;
* collectives: :class:`CollectiveCounter`, ``CommDebugMode``'s counts
  with each collective's operand bytes and group size. The ring-cost
  factor over the group size k is the reference's:

    all-reduce: 2 * (k-1)/k * bytes     all-gather: (k-1)/k * out_bytes
    reduce-scatter: (k-1)/k * in_bytes  all-to-all: (k-1)/k * bytes
    collective-permute: bytes
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

# torch collective (functional, in-place c10d) -> the reference's HLO name
_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group(args):
    """The collective's group: a ``ProcessGroup`` argument, or a group
    name (functional collectives); None for the default group."""
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a
        if isinstance(a, str) and a:
            try:
                return dist.distributed_c10d._resolve_process_group(a)
            except (KeyError, ValueError, RuntimeError):
                continue
    return None


def _group_size(args) -> int:
    group = _group(args)
    if group is not None:
        return group.size()
    return dist.get_world_size() if dist.is_initialized() else 1


def ring_wire_bytes(kind: str, nbytes: float, k: int) -> float:
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k * nbytes
    if kind == "collective-permute":
        return float(nbytes)
    return (k - 1) / k * nbytes


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode`` that also records each collective's operand bytes
    (the output for an all-gather, the input otherwise) and group size,
    in total (``sizes``) and by group name (``by_group``)."""

    def __init__(self) -> None:
        super().__init__()
        self.sizes: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
        self.by_group: Dict[str, Dict[str, Dict[str, float]]] = defaultdict(
            lambda: defaultdict(lambda: {"count": 0, "bytes": 0.0,
                                         "wire_bytes": 0.0}))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(
                func, torch._ops.HigherOrderOperator):
            return out
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is not None:
            given = list(args) + list((kwargs or {}).values())
            group = _group(given)
            k = _group_size(given)
            nbytes = _nbytes(out if kind == "all-gather" else args[0])
            name = group.group_name if group is not None else "default"
            for d in (self.sizes[kind], self.by_group[name][kind]):
                d["count"] += 1
                d["bytes"] += nbytes
                d["wire_bytes"] += ring_wire_bytes(kind, nbytes, k)
        return out


def parse_collectives(counter: CollectiveCounter
                      ) -> Dict[str, Dict[str, float]]:
    """Per-op-type totals: count, tensor bytes, estimated wire bytes (the
    reference's record, from the counter instead of HLO text)."""
    return {k: dict(v) for k, v in counter.sizes.items()}


def collectives_by_axis(counter: CollectiveCounter, mesh
                        ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """The counter's totals by the mesh axis whose group ran them (a
    DeviceMesh's dims by name; any other group, such as a ``DTensor``
    redistribution's over several dims, as "other")."""
    names = {mesh.get_group(i).group_name: n
             for i, n in enumerate(mesh.mesh_dim_names)}
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for group, kinds in counter.by_group.items():
        axis = out.setdefault(names.get(group, "other"), {})
        for kind, d in kinds.items():
            acc = axis.setdefault(kind, {"count": 0, "bytes": 0.0,
                                         "wire_bytes": 0.0})
            for key in acc:
                acc[key] += d[key]
    return out


class BytesMode(TorchDispatchMode):
    """Sums the bytes of each operation's tensor inputs and outputs (an
    output that is an input, as of an in-place operation, once; views and
    ``DTensor``-level calls, which come back as local operations, not)."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.OpOverload) and not func.is_view:
            ins = list(_tensors(list(args) + list((kwargs or {}).values())))
            seen = {id(t) for t in ins}
            self.bytes += _nbytes(ins) + sum(
                t.numel() * t.element_size() for t in _tensors(out)
                if id(t) not in seen)
        return out


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_wire_bytes: float) -> Dict[str, float]:
    """Per-device three-term roofline, in seconds."""
    compute = flops / PEAK_FLOPS_BF16
    memory = bytes_accessed / HBM_BW
    collective = collective_wire_bytes / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = max(bound, 1e-30)
    terms["bottleneck"] = dom.replace("_s", "")
    terms["roofline_fraction_compute"] = compute / total
    return terms


def model_flops(cfg, shape, mesh_devices: int) -> Dict[str, float]:
    """Analytic MODEL_FLOPS per device: 6*N_active*tokens (train),
    2*N_active*tokens (prefill/decode forward)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        total = 2.0 * n_active * tokens
    return {"model_flops_total": total,
            "model_flops_per_device": total / mesh_devices}
