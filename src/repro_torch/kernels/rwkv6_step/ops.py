"""Public RWKV6 decode-step op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors, and nothing else.

``use_kernel=None`` picks by the device of ``r``. ``use_kernel=True`` on a
CPU tensor raises (there is no kernel to run there) and so does
``use_kernel=False`` on a CUDA tensor: the plain version serves CPU tensors
only here (call ``ref.rwkv6_step_ref`` directly to run it on the card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import rwkv6_step_cuda
from .ref import rwkv6_step_ref

__all__ = ["rwkv6_step"]


def _kernel_for(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    on_card = x.device.type == "cuda"
    if use_kernel is None:
        return on_card
    if use_kernel and not on_card:
        raise ValueError("use_kernel=True needs CUDA tensors: the "
                         f"rwkv6_step kernel does not run on {x.device}")
    if not use_kernel and on_card:
        raise ValueError("use_kernel=False on CUDA tensors: the plain "
                         "version serves CPU tensors only (call "
                         "ref.rwkv6_step_ref directly to run it on the "
                         "card)")
    return bool(use_kernel)


def rwkv6_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
               use_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. r,k,v,w: (B,H,hd); u: (H,hd); state: (B,H,hd,hd) f32.
    Returns (y (B,H,hd) in r's dtype, new state (B,H,hd,hd) f32)."""
    if _kernel_for(r, use_kernel):
        return rwkv6_step_cuda(*(t.contiguous() for t in (r, k, v, w, u,
                                                          state)))
    return rwkv6_step_ref(r, k, v, w, u, state)
