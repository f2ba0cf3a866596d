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

from .._launches import kernel_for
from .kernel import rwkv6_step_cuda
from .ref import rwkv6_step_ref

__all__ = ["rwkv6_step"]


def rwkv6_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
               use_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. r,k,v,w: (B,H,hd); u: (H,hd); state: (B,H,hd,hd) f32.
    Returns (y (B,H,hd) in r's dtype, new state (B,H,hd,hd) f32)."""
    if kernel_for(r.device, use_kernel, "rwkv6_step", "ref.rwkv6_step_ref"):
        return rwkv6_step_cuda(*(t.contiguous() for t in (r, k, v, w, u,
                                                          state)))
    return rwkv6_step_ref(r, k, v, w, u, state)
