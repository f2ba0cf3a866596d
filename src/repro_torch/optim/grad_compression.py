"""Gradient compression for the data-parallel reduce (the reference's
``optim/grad_compression.py``).

Error-feedback int8 quantization: each DP rank quantizes its local
gradient contribution to int8 with a per-tensor scale shared by the
ranks, all-reduces the int8 payload widened to int32 (the sum must not
overflow), dequantizes, and keeps the quantization residual locally to
add into the next step (error feedback preserves convergence;
Karimireddy et al. 2019).

The reference runs under ``shard_map`` with ``pmax`` and ``psum`` over the
dp axis; here the same two reductions are ``torch.distributed.all_reduce``
(``MAX`` of the scalar, ``SUM`` of the int32 payload) over the process
group of one axis of a ``DeviceMesh`` (gloo on the CPU, NCCL on the card).
The order of operations is the reference's, so the results are its bits:
the int32 sum is exact, and every f32 operation is the same one.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
import torch.distributed as dist

Grads = Dict[str, torch.Tensor]


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    gf = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_compressed_allreduce(mesh, axis: str = "data"):
    """Returns fn(grads_local, err_state) -> (grads_mean, new_err_state)
    over the ranks of ``mesh``'s ``axis``: dicts of tensors by name, this
    rank's gradients and residuals. Every rank of the axis calls it with
    the same names, in the same order."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def reduce_one(g: torch.Tensor, err: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        gf = g.to(torch.float32) + err
        # SHARED scale across ranks: int8 payloads quantized against
        # different scales cannot be summed; the max is a scalar collective
        amax = torch.max(torch.abs(gf))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new_err = gf - q.to(torch.float32) * scale
        # widen before the sum so int8 accumulation cannot overflow
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
        g_mean = q_sum.to(torch.float32) * scale / n
        return g_mean.to(g.dtype), new_err

    def reduce_tree(grads: Mapping[str, torch.Tensor],
                    err_state: Mapping[str, torch.Tensor]
                    ) -> Tuple[Grads, Grads]:
        out = {k: reduce_one(g, err_state[k]) for k, g in grads.items()}
        return ({k: o[0] for k, o in out.items()},
                {k: o[1] for k, o in out.items()})

    return reduce_tree


def init_error_state(params: Mapping[str, Any]) -> Grads:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
