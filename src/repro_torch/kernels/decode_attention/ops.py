"""Public decode-attention op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors, and nothing else.

:func:`takes` is the condition ``models.components.attention`` hands a
decode call over on: CUDA tensors the kernel takes (``kernel.refusal``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import decode_attention_cuda, refusal
from .ref import decode_attention_ref

__all__ = ["decode_attention", "takes"]


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel runs this attention: CUDA tensors of one query
    position with shapes, dtypes and strides it takes."""
    return q.is_cuda and refusal(q, k, v) is None


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     logit_softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k, v: (B, L, K, hd); q_pos: (1,); kv_pos: (L,),
    -1 an empty slot. Returns (B, 1, H, hd) in q's dtype."""
    fn = decode_attention_cuda if q.is_cuda else decode_attention_ref
    return fn(q, k, v, q_pos, kv_pos, causal=causal, window=window,
              logit_softcap=logit_softcap, scale=scale)
