"""Public RG-LRU scan op: the CUDA kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors, and nothing else.

``use_kernel=None`` picks by the device of ``log_a``. ``use_kernel=True``
on a CPU tensor raises (there is no kernel to run there) and so does
``use_kernel=False`` on a CUDA tensor: the plain version serves CPU tensors
only here (call ``ref.rglru_ref`` directly to run it on the card).

The op is differentiable: when autograd records and an input requires a
gradient, it runs through :class:`RGLRUScan`, whose backward is the
gradient kernel (``kernel.rglru_scan_bwd_cuda``) on CUDA tensors and
``ref.rglru_bwd_ref`` on CPU tensors. Otherwise (serving, under
``no_grad``) the forward is called directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._launches import kernel_for
from .kernel import rglru_scan_bwd_cuda, rglru_scan_cuda
from .ref import rglru_bwd_ref, rglru_ref

__all__ = ["rglru_scan", "RGLRUScan"]


def _forward(log_a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor], kernel: bool) -> torch.Tensor:
    if kernel:
        return rglru_scan_cuda(log_a.contiguous(), b.contiguous(),
                               None if h0 is None else h0.contiguous())
    if h0 is None:
        h0 = torch.zeros((log_a.shape[0], log_a.shape[2]),
                         dtype=torch.float32, device=log_a.device)
    return rglru_ref(log_a, b, h0)


class RGLRUScan(torch.autograd.Function):
    """``h = rglru_scan(log_a, b, h0)`` with its gradient: saves log_a, h
    and h0; the backward returns (dlog_a, db, dh0)."""

    @staticmethod
    def forward(ctx, log_a, b, h0, kernel: bool):
        log_a = log_a.contiguous()
        h = _forward(log_a, b, h0, kernel)
        ctx.kernel = kernel
        ctx.save_for_backward(log_a, h,
                              None if h0 is None else h0.contiguous())
        return h

    @staticmethod
    def backward(ctx, gh):
        log_a, h, h0 = ctx.saved_tensors
        want_dh0 = h0 is not None and ctx.needs_input_grad[2]
        if ctx.kernel:
            dlog_a, db, dh0 = rglru_scan_bwd_cuda(
                log_a, h, gh.contiguous(), h0, want_dh0)
        else:
            dlog_a, db, dh0 = rglru_bwd_ref(
                log_a, h, gh, h0 if h0 is not None else torch.zeros(
                    (log_a.shape[0], log_a.shape[2]), dtype=torch.float32))
        return dlog_a, db, dh0 if want_dh0 else None, None


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t over (B, S, R) f32, from ``h0``
    (B, R), zeros when None. Returns h: (B, S, R) f32."""
    kernel = kernel_for(log_a.device, use_kernel, "rglru_scan",
                        "ref.rglru_ref")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (log_a, b, h0)):
        return RGLRUScan.apply(log_a, b, h0, kernel)
    return _forward(log_a, b, h0, kernel)
