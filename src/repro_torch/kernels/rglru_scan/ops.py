"""Public RG-LRU scan op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors, and nothing else.

``use_kernel=None`` picks by the device of ``log_a``. ``use_kernel=True``
on a CPU tensor raises (there is no kernel to run there) and so does
``use_kernel=False`` on a CUDA tensor: the plain version serves CPU tensors
only here (call ``ref.rglru_ref`` directly to run it on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import rglru_scan_cuda
from .ref import rglru_ref

__all__ = ["rglru_scan"]


def _kernel_for(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    on_card = x.device.type == "cuda"
    if use_kernel is None:
        return on_card
    if use_kernel and not on_card:
        raise ValueError("use_kernel=True needs CUDA tensors: the "
                         f"rglru_scan kernel does not run on {x.device}")
    if not use_kernel and on_card:
        raise ValueError("use_kernel=False on CUDA tensors: the plain "
                         "version serves CPU tensors only (call "
                         "ref.rglru_ref directly to run it on the card)")
    return bool(use_kernel)


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t over (B, S, R) f32, from ``h0``
    (B, R), zeros when None. Returns h: (B, S, R) f32."""
    if _kernel_for(log_a, use_kernel):
        return rglru_scan_cuda(log_a.contiguous(), b.contiguous(),
                               None if h0 is None else h0.contiguous())
    if h0 is None:
        h0 = torch.zeros((log_a.shape[0], log_a.shape[2]),
                         dtype=torch.float32, device=log_a.device)
    return rglru_ref(log_a, b, h0)
