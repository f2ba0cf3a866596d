"""DeepSeek-V3's block (Kimi-K2) in plain float32 PyTorch, for the CPU
tests: the forward of a whole sequence, a layer at a time, from the port's
parameters by name (``layers.<i>.mla.*``, ``layers.<i>.ffn.*``) and a
``ModelConfig``'s fields. It imports nothing of the port, of the JAX
package or of the benchmark: the same equations as the benchmark's copy
(``portbench/reference/mla_moe.py``), written again.

Per layer: x += MLA(norm1(x)); x += FFN(norm2(x)). Latent attention in the
expanded form: ``c_q = norm(h q_a)``, ``q = c_q q_b`` per head
``[q_nope, q_pe]``; ``[c_kv, k_pe] = h kv_a``, ``c_kv`` normed, ``[k_nope,
v] = c_kv kv_b`` per head, ``k_pe`` one for all heads; YaRN RoPE on
``q_pe`` and ``k_pe``; scores ``(q_nope . k_nope + q_pe . k_pe) * s`` with
``s = qk_head_dim^-0.5 * mscale(factor, mscale_all_dim)^2``, causal
softmax, ``p v``, ``wo``. The lead layers' FFN is a SwiGLU; the others
route over all ``num_experts``: ``scores = sigmoid(h R)``, the top k of
``scores + bias``, weights the chosen scores over their sum times
``routed_scale``; the held experts (``held_first`` .. ``held_first +
held - 1``) add their weighted SwiGLU, the others nothing, and the shared
expert its own.

Departures from the published model, as the port has them: RMSNorm's
weight is ``1 + w``; bf16 weights where the published experts are FP8
blocks (here the tests hand in whatever they hold, in f32); RoPE rotates
halves where the published code interleaves pairs.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_tables(cfg):
    """(inverse frequencies (qk_rope_head_dim / 2,), softmax scale), as
    DeepSeek-V3's ``DeepseekV3YarnRotaryEmbedding`` and attention set
    them: theta's frequencies below YaRN's correction range, those over
    ``factor`` above it, a linear ramp between."""
    m, y = cfg.mla, cfg.yarn
    d, theta = m.qk_rope_head_dim, cfg.rope_theta

    def dim(rotations):
        return d * math.log(y.original_max_position
                            / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(dim(y.beta_fast)), 0)
    high = min(math.ceil(dim(y.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, d, 2, dtype=torch.float32) / d
    extra, inter = 1.0 / theta ** exps, 1.0 / (y.factor * theta ** exps)
    mask = 1 - torch.clamp((torch.arange(d // 2, dtype=torch.float32) - low)
                           / (high - low), 0, 1)
    scale = m.qk_head_dim ** -0.5
    if y.mscale_all_dim:
        scale *= _mscale(y.factor, y.mscale_all_dim) ** 2
    return inter * (1 - mask) + extra * mask, scale


def _rope(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Halves rotated; x: (T, H, d), positions 0..T-1."""
    half = x.shape[-1] // 2
    ang = torch.arange(x.shape[0]).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(cfg, p: Params, pre: str, h: torch.Tensor) -> torch.Tensor:
    """One sequence's latent attention, h: (T, D) normed."""
    m, H = cfg.mla, cfg.n_heads
    T = h.shape[0]
    nope, R = m.qk_nope_head_dim, m.kv_lora_rank
    inv, scale = yarn_tables(cfg)
    cq = rms_norm(h @ p[f"{pre}.q_a"], p[f"{pre}.q_norm"], cfg.norm_eps)
    q = (cq @ p[f"{pre}.q_b"]).reshape(T, H, m.qk_head_dim)
    kva = h @ p[f"{pre}.kv_a"]
    ckv = rms_norm(kva[:, :R], p[f"{pre}.kv_norm"], cfg.norm_eps)
    kv = (ckv @ p[f"{pre}.kv_b"]).reshape(T, H, nope + m.v_head_dim)
    q_pe, k_pe = _rope(q[..., nope:], inv), _rope(kva[:, None, R:], inv)
    s = torch.einsum("qhd,khd->hqk", q[..., :nope], kv[..., :nope]) \
        + torch.einsum("qhd,kd->hqk", q_pe, k_pe[:, 0])
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    s = (s * scale).masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                     kv[..., nope:])
    return o.reshape(T, -1) @ p[f"{pre}.wo"]


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def moe(cfg, p: Params, pre: str, x: torch.Tensor, held_first: int = 0,
        held: Optional[int] = None) -> torch.Tensor:
    """The routed experts ``held_first`` .. ``held_first + held - 1``
    (``p``'s stacked experts, in that order) and the shared expert, over
    tokens x: (N, D) normed. ``held``: default ``cfg.moe.n_held``."""
    mo = cfg.moe
    held = mo.n_held if held is None else held
    scores = torch.sigmoid(x @ p[f"{pre}.router"])
    _, idx = torch.sort(scores + p[f"{pre}.router_bias"], dim=-1,
                        descending=True, stable=True)
    chosen = idx[:, :mo.top_k]
    gate = scores.gather(-1, chosen)
    gate = gate / gate.sum(dim=-1, keepdim=True) * mo.routed_scale
    out = swiglu(x, p[f"{pre}.s1"], p[f"{pre}.s3"], p[f"{pre}.s2"])
    for e in range(held):
        rows, slot = torch.nonzero(chosen == held_first + e, as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], p[f"{pre}.w1"][e], p[f"{pre}.w3"][e],
                       p[f"{pre}.w2"][e])
            out = out.index_add(0, rows, y * gate[rows, slot][:, None])
    return out


@torch.no_grad()
def logits(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """(N, T, V) f32 logits of ``tokens`` (N, T), a sequence at a time;
    ``p``: the port's parameters by name, any float dtype."""
    p = {k: v.float() for k, v in p.items()}
    eps, lead = cfg.norm_eps, len(cfg.lead)
    out = []
    for seq in tokens:
        x = p["embed"][seq]
        for i in range(cfg.n_layers):
            b = f"layers.{i}"
            x = x + mla(cfg, p, f"{b}.mla",
                        rms_norm(x, p[f"{b}.ln1.w"], eps))
            h = rms_norm(x, p[f"{b}.ln2.w"], eps)
            if i < lead:
                x = x + swiglu(h, p[f"{b}.ffn.w1"], p[f"{b}.ffn.w3"],
                               p[f"{b}.ffn.w2"])
            else:
                x = x + moe(cfg, p, f"{b}.ffn", h, cfg.moe.held_first)
        out.append(rms_norm(x, p["final.w"], eps) @ p["lm_head"])
    return torch.stack(out)
