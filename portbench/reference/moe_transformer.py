"""A grouped-query-attention decoder with a top-k mixture of SwiGLU
experts (Mixtral, arXiv:2401.04088), in plain float32 PyTorch: a
sequence's logits from one causal forward, a layer at a time.

Per layer: x += Attn(norm1(x)); x += MoE(norm2(x)). Attention: RoPE
(theta from the configuration, halves rotated) on q and k, query head h
reading key/value head h // (H / K), causal within the sliding window,
softmax in float32. MoE: router logits ``h R``, the top k experts by them,
their weights the softmax of those k logits, each expert
``(silu(h W1) * (h W3)) W2``; no token is dropped. Departure from the
published model, as the port has it: RMSNorm's weight is ``1 + w``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .common import mm, rms_norm, rope


def _attention(cfg: Dict, w: Dict[str, torch.Tensor], b: str,
               h: torch.Tensor, precision: str) -> torch.Tensor:
    N, T, D = h.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    pos = torch.arange(T, device=h.device)
    q = mm(h, w[f"{b}.self_attn.q_proj"], precision).reshape(N, T, H, hd)
    k = mm(h, w[f"{b}.self_attn.k_proj"], precision).reshape(N, T, K, hd)
    v = mm(h, w[f"{b}.self_attn.v_proj"], precision).reshape(N, T, K, hd)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    near = pos[None, :] > pos[:, None] - cfg["window"]
    allowed = (pos[None, :] <= pos[:, None]) & near
    outs = []
    for n in range(N):              # a sequence at a time: (H, T, T) scores
        s = torch.einsum("qhd,khd->hqk", q[n], k[n]) / math.sqrt(hd)
        s = s.masked_fill(~allowed, float("-inf"))
        outs.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                 v[n]))
    o = torch.stack(outs)
    return mm(o.reshape(N, T, H * hd), w[f"{b}.self_attn.o_proj"], precision)


def _moe(cfg: Dict, w: Dict[str, torch.Tensor], b: str, h: torch.Tensor,
         precision: str, record: Optional[Dict]) -> torch.Tensor:
    N, T, D = h.shape
    x = h.reshape(N * T, D)
    router = mm(x, w[f"{b}.block_sparse_moe.gate"], precision)
    top, idx = torch.sort(router, dim=-1, descending=True, stable=True)
    k = cfg["top_k"]
    gate = torch.softmax(top[:, :k], dim=-1)
    if record is not None:          # how near the k-th expert is to losing
        margin = (top[:, k - 1] - top[:, k]).reshape(N, T)
        record["router_margin"] = torch.minimum(
            record.get("router_margin", margin), margin)
    out = torch.zeros_like(x)
    w1 = w[f"{b}.block_sparse_moe.experts.w1"]
    w3 = w[f"{b}.block_sparse_moe.experts.w3"]
    w2 = w[f"{b}.block_sparse_moe.experts.w2"]
    for e in range(cfg["num_experts"]):
        rows, slot = torch.nonzero(idx[:, :k] == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        ye = mm(F.silu(mm(xe, w1[e], precision)) * mm(xe, w3[e], precision),
                w2[e], precision)
        out.index_add_(0, rows, ye * gate[rows, slot][:, None])
    return out.reshape(N, T, D)


@torch.no_grad()
def logits(cfg: Dict, weights: Callable[[int], Dict[str, torch.Tensor]],
           tokens: torch.Tensor, first: int, precision: str = "f32",
           record: Optional[Dict] = None) -> torch.Tensor:
    """Logits (N, T - first, V) at positions ``first``..T-1 of ``tokens``
    (N, T) int64. ``weights(g)``: group g's float32 weights (0: embedding,
    final norm, head; i + 1: layer i). ``record``: gets
    ``router_margin`` (N, T), each token's least margin over the layers
    between its k-th and (k+1)-th router logits."""
    eps = cfg["norm_eps"]
    outer = weights(0)
    x = outer["embed_tokens.weight"][tokens]
    for i in range(cfg["n_layers"]):
        w, b = weights(i + 1), f"layers.{i}"
        x = x + _attention(cfg, w, b, rms_norm(
            x, w[f"{b}.input_layernorm.weight"], eps), precision)
        x = x + _moe(cfg, w, b, rms_norm(
            x, w[f"{b}.post_attention_layernorm.weight"], eps), precision,
            record)
        del w
    h = rms_norm(x[:, first:], outer["norm.weight"], eps)
    return mm(h, outer["lm_head.weight"], precision)
