"""Plain PyTorch version of the RWKV6 decode step (= ``models.rwkv6``'s
``wkv_step`` in the reference).

The semantics authority the CUDA kernel is held to, on any device. The
vectors are taken to f32 (the Pallas kernel's casts), the state is f32,
``y`` comes back in ``r``'s dtype and the new state is a new tensor. The
state update rounds as two f32 products and an add, which the kernel
repeats, so on the card the new states agree bit for bit; the readout is a
batched product here and a sequential sum over the key index there.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rwkv6_step_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. r,k,v,w: (B,H,hd); u: (H,hd); state: (B,H,hd,hd) f32.

    y_t[j] = sum_i r[i] (S[i,j] + u[i] k[i] v[j]);  S' = diag(w) S + k v^T
    """
    rf, kf, vf, wf, uf = (t.float() for t in (r, k, v, w, u))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", rf, state + uf[None, :, :, None] * kv)
    new_state = wf[..., :, None] * state + kv
    return y.to(r.dtype), new_state
