"""DeepSeek-V3's block at Kimi-K2's widths (arXiv:2412.19437,
arXiv:2507.20534) in plain float32 PyTorch: a sequence's logits from one
causal forward, a layer at a time, attention a sequence at a time.

Per layer: x += MLA(norm1(x)); x += FFN(norm2(x)). Multi-head latent
attention (arXiv:2405.04434) in the expanded form: ``c_q = norm(h Wqa)``,
``q = c_q Wqb`` split per head into ``q_nope`` and ``q_pe``; ``[c_kv,
k_pe] = h Wkva``, ``c_kv`` normed, ``[k_nope, v] = c_kv Wkvb`` per head,
``k_pe`` one for every head; RoPE with YaRN's frequencies (factor,
original positions, beta_fast, beta_slow) on ``q_pe`` and ``k_pe``;
scores ``(q_nope . k_nope + q_pe . k_pe) * s``, ``s = qk_head_dim^-0.5 *
mscale(factor, mscale_all_dim)^2``, causal softmax, ``p v``, ``Wo``. The
first ``first_k_dense_replace`` layers' FFN is a SwiGLU; the others'
routes over all ``published_num_experts``: scores ``sigmoid(h R)``, the
top k of ``scores + bias``, weights the chosen scores over their sum
times ``routed_scaling_factor``; the experts held here (``held_first``
.. ``held_first + n_routed_experts - 1``) add their weighted SwiGLU, the
others nothing (their chips add it), and the shared expert adds its own.

Departures from the published model, as the port has them: RMSNorm's
weight is ``1 + w``; the weights are bf16 where the published experts are
FP8 blocks; RoPE rotates halves where the published code interleaves
pairs (on drawn weights, a fixed permutation of the rope columns of
``q_b_proj`` and ``kv_a_proj_with_mqa``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import mm, rms_norm

HEADS_AT_ONCE = 16          # (16, T, T) f32 scores at a time


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(cfg: Dict, device) -> Tuple[torch.Tensor, float, float]:
    """YaRN's inverse frequencies (qk_rope_head_dim / 2,), the softmax
    scale, and the scale of cos and sin (DeepSeek-V3's)."""
    y, d = cfg["rope_scaling"], cfg["qk_rope_head_dim"]
    theta, factor = float(cfg["rope_theta"]), float(y["factor"])
    orig = y["original_max_position_embeddings"]

    def dim(rotations):
        return d * math.log(orig / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(dim(y["beta_fast"])), 0)
    high = min(math.ceil(dim(y["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    extra = 1.0 / theta ** exps
    inter = 1.0 / (factor * theta ** exps)
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    inv = inter * ramp + extra * (1 - ramp)
    scale = (cfg["qk_nope_head_dim"] + d) ** -0.5
    if y["mscale_all_dim"]:
        scale *= _mscale(factor, y["mscale_all_dim"]) ** 2
    return inv, scale, _mscale(factor, y["mscale"]) \
        / _mscale(factor, y["mscale_all_dim"])


def _rope(x: torch.Tensor, inv: torch.Tensor, cs: float) -> torch.Tensor:
    """Halves rotated over the last dim; x: (N, T, H, d), positions 0..T-1."""
    half = x.shape[-1] // 2
    ang = torch.arange(x.shape[1], device=x.device).float()[:, None] * inv
    cos = (torch.cos(ang) * cs)[None, :, None]
    sin = (torch.sin(ang) * cs)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(cfg: Dict, w: Dict[str, torch.Tensor], a: str,
               h: torch.Tensor, eps: float, precision: str) -> torch.Tensor:
    N, T, _ = h.shape
    H = cfg["num_attention_heads"]
    nope, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    R = cfg["kv_lora_rank"]
    inv, scale, cs = rope_tables(cfg, h.device)
    cq = rms_norm(mm(h, w[f"{a}.q_a_proj"], precision),
                  w[f"{a}.q_a_layernorm.weight"], eps)
    q = mm(cq, w[f"{a}.q_b_proj"], precision).reshape(N, T, H, nope + dr)
    kva = mm(h, w[f"{a}.kv_a_proj_with_mqa"], precision)
    ckv = rms_norm(kva[..., :R], w[f"{a}.kv_a_layernorm.weight"], eps)
    kv = mm(ckv, w[f"{a}.kv_b_proj"], precision).reshape(N, T, H, nope + dv)
    q_pe = _rope(q[..., nope:], inv, cs)
    k_pe = _rope(kva[..., None, R:], inv, cs)                  # (N, T, 1, dr)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    o = torch.empty((N, T, H, dv), device=h.device)
    for n in range(N):              # a sequence at a time
        for h0 in range(0, H, HEADS_AT_ONCE):
            hs = slice(h0, h0 + HEADS_AT_ONCE)
            s = torch.einsum("qhd,khd->hqk", q[n, :, hs, :nope],
                             kv[n, :, hs, :nope]) \
                + torch.einsum("qhd,kd->hqk", q_pe[n, :, hs], k_pe[n, :, 0])
            s = (s * scale).masked_fill(~causal, float("-inf"))
            o[n, :, hs] = torch.einsum("hqk,khd->qhd",
                                       torch.softmax(s, dim=-1),
                                       kv[n, :, hs, nope:])
    return mm(o.reshape(N, T, H * dv), w[f"{a}.o_proj"], precision)


def _swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor, precision: str) -> torch.Tensor:
    return mm(F.silu(mm(x, w1, precision)) * mm(x, w3, precision), w2,
              precision)


def _moe(cfg: Dict, w: Dict[str, torch.Tensor], c: str, h: torch.Tensor,
         precision: str, record: Optional[Dict]) -> torch.Tensor:
    N, T, D = h.shape
    x = h.reshape(N * T, D)
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(mm(x, w[f"{c}.gate.weight"], precision))
    choice = scores + w[f"{c}.gate.e_score_correction_bias"]
    top, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
    if record is not None:          # how near the k-th expert is to losing
        margin = (top[:, k - 1] - top[:, k]).reshape(N, T)
        record["router_margin"] = torch.minimum(
            record.get("router_margin", margin), margin)
    chosen = idx[:, :k]
    gate = scores.gather(-1, chosen)
    gate = gate / gate.sum(dim=-1, keepdim=True) \
        * cfg["routed_scaling_factor"]
    out = _swiglu(x, w[f"{c}.shared_experts.gate_proj"],
                  w[f"{c}.shared_experts.up_proj"],
                  w[f"{c}.shared_experts.down_proj"], precision)
    w1, w3, w2 = (w[f"{c}.experts.{n}"] for n in
                  ("gate_proj", "up_proj", "down_proj"))
    for e in range(cfg["n_routed_experts"]):
        rows, slot = torch.nonzero(chosen == cfg["held_first"] + e,
                                   as_tuple=True)
        if rows.numel():
            ye = _swiglu(x[rows], w1[e], w3[e], w2[e], precision)
            out.index_add_(0, rows, ye * gate[rows, slot][:, None])
    return out.reshape(N, T, D)


@torch.no_grad()
def logits(cfg: Dict, weights: Callable[[int], Dict[str, torch.Tensor]],
           tokens: torch.Tensor, first: int, precision: str = "f32",
           record: Optional[Dict] = None) -> torch.Tensor:
    """Logits (N, T - first, V) at positions ``first``..T-1 of ``tokens``
    (N, T) int64. ``weights(g)``: group g's float32 weights (0: embedding,
    final norm, head; i + 1: layer i). ``record``: gets ``router_margin``
    (N, T), each token's least margin over the MoE layers between its
    k-th and (k+1)-th expert by ``scores + bias``."""
    eps = cfg["rms_norm_eps"]
    outer = weights(0)
    x = outer["model.embed_tokens.weight"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        w, b = weights(i + 1), f"model.layers.{i}"
        x = x + _attention(cfg, w, f"{b}.self_attn", rms_norm(
            x, w[f"{b}.input_layernorm.weight"], eps), eps, precision)
        h = rms_norm(x, w[f"{b}.post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + _swiglu(h, w[f"{b}.mlp.gate_proj"], w[f"{b}.mlp.up_proj"],
                            w[f"{b}.mlp.down_proj"], precision)
        else:
            x = x + _moe(cfg, w, f"{b}.mlp", h, precision, record)
        del w
    h = rms_norm(x[:, first:], outer["model.norm.weight"], eps)
    return mm(h, outer["lm_head.weight"], precision)
