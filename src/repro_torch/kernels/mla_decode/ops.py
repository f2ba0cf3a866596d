"""Public latent-attention decode op: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors, and nothing else.

:func:`takes` is the condition ``models.transformer._mla_step_`` hands its
``.attend`` over on: CUDA tensors the kernel takes (``kernel.refusal``: a
bf16 cache 576 wide with rank 512, 64 query heads a block, strides the TMA
descriptors take). Anything else keeps the plain chain.
"""
from __future__ import annotations

import torch

from .kernel import mla_decode_cuda, refusal
from .ref import mla_decode_ref

__all__ = ["mla_decode", "takes"]


def takes(qf: torch.Tensor, latent: torch.Tensor, rank: int) -> bool:
    """Whether the kernel runs this decode step's attention: CUDA tensors
    of shapes, dtypes and strides it takes."""
    return (isinstance(qf, torch.Tensor) and qf.is_cuda
            and refusal(qf, latent, rank) is None)


def mla_decode(qf: torch.Tensor, latent: torch.Tensor, pos_t: torch.Tensor,
               scale: float, rank: int) -> torch.Tensor:
    """qf: (B, H, rank + rope); latent: (B, L, rank + rope); pos_t: the
    query's position as a device integer tensor. Returns (B, H, rank) in
    the cache's dtype."""
    fn = mla_decode_cuda if qf.is_cuda else mla_decode_ref
    return fn(qf, latent, pos_t, scale, rank)
