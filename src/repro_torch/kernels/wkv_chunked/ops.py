"""Public op of RWKV6's chunked sequence form: the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors, and nothing else.

``use_kernel=None`` picks by the device of ``r``. ``use_kernel=True`` on a
CPU tensor raises (there is no kernel to run there) and so does
``use_kernel=False`` on a CUDA tensor: the plain version serves CPU tensors
only here (call ``ref.wkv_chunked_ref`` directly to run it on the card).
``chunk`` is the plain version's tiling, by default the largest divisor of
S up to 64; the kernel takes any S in chunks of its own.

The op is differentiable: on CUDA, when autograd records and an input
requires a gradient, it runs through :class:`WKVChunked`, whose forward is
the kernel and whose backward differentiates the plain version, recomputed
from the saved inputs. Otherwise (serving, under ``no_grad``) the kernel
is called directly. On the CPU the plain version records its own graph.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .._launches import kernel_for
from .kernel import wkv_chunked_cuda
from .ref import wkv_chunked_ref

__all__ = ["wkv_chunked", "WKVChunked"]


def plain_chunk(S: int) -> int:
    """The plain version's tiling for S tokens: 64 where it divides S, else
    the largest common divisor of S and 64 (S itself when S is 0)."""
    return 64 if S % 64 == 0 else (math.gcd(S, 64) or S)


class WKVChunked(torch.autograd.Function):
    """``(y, state) = wkv_chunked(r, k, v, lw, u, state)`` on CUDA tensors
    with its gradient: the kernel runs the forward; the backward recomputes
    ``ref.wkv_chunked_ref`` from the saved inputs and differentiates it."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state):
        ctx.save_for_backward(r, k, v, lw, u, state)
        return wkv_chunked_cuda(r, k, v, lw, u, state)

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        wanted = [t is not None and need
                  for t, need in zip(saved, ctx.needs_input_grad)]
        inputs = [None if t is None else t.detach().requires_grad_(w)
                  for t, w in zip(saved, wanted)]
        with torch.enable_grad():
            outs = wkv_chunked_ref(*inputs,
                                   chunk=plain_chunk(saved[0].shape[1]))
        pairs = [(o, g) for o, g in zip(outs, (gy, gstate))
                 if g is not None and o.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [t for t, w in zip(inputs, wanted) if w],
            [g for _, g in pairs], allow_unused=True)
        it = iter(grads)
        return tuple(next(it) if w else None for w in wanted)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lw: torch.Tensor, u: torch.Tensor,
                state: Optional[torch.Tensor] = None,
                chunk: Optional[int] = None,
                use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v: (B,S,H,hd) f32; lw: (B,S,H,hd) log-decay (<=0); u: (H,hd);
    state: (B,H,hd,hd) f32 or None (zeros). Returns (y (B,S,H,hd) f32,
    final state (B,H,hd,hd) f32)."""
    if not kernel_for(r.device, use_kernel, "wkv_chunked",
                      "ref.wkv_chunked_ref"):
        return wkv_chunked_ref(r, k, v, lw, u, state,
                               chunk or plain_chunk(r.shape[1]))
    args = (*(t.contiguous() for t in (r, k, v, lw, u)),
            None if state is None else state.contiguous())
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return WKVChunked.apply(*args)
    return wkv_chunked_cuda(*args)
