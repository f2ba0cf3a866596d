"""Plain PyTorch version of latent-attention decode: the chain
``models.transformer._mla_step_`` runs wherever the kernel does not take
its tensors, op for op.

The scores ``qf . latent^T`` into f32 (bf16 operands on the card multiply
on the tensor cores into an f32 result, as ``components.matmul_f32`` does;
elsewhere both are cast to f32 first), times ``scale``, every position past
``pos_t`` masked to -inf over the whole static length, an f32 softmax, the
probabilities cast to the cache's dtype and multiplied by the ``c_kv`` half
of the cache. The CUDA kernel is held to it
(``tests/test_torch_mla_decode.py``).
"""
from __future__ import annotations

import torch


def mla_decode_ref(qf: torch.Tensor, latent: torch.Tensor,
                   pos_t: torch.Tensor, scale: float, rank: int
                   ) -> torch.Tensor:
    """qf: (B, H, rank + rope) absorbed queries; latent: (B, L, rank +
    rope) the cache; pos_t: the query's position (a 0-d or (1,) integer
    tensor): positions 0..pos_t are attended. Returns (B, H, rank) in the
    cache's dtype."""
    kt = latent.transpose(1, 2)
    if qf.is_cuda and qf.dtype == latent.dtype == torch.bfloat16:
        s = torch.bmm(qf, kt, out_dtype=torch.float32)
    else:
        s = qf.float() @ kt.float()
    s = s * scale                                           # (B, H, L)
    idx = torch.arange(latent.shape[1], device=qf.device)
    s = s.masked_fill(idx > pos_t, float("-inf"))
    return torch.bmm(torch.softmax(s, dim=-1).to(latent.dtype),
                     latent[..., :rank])
