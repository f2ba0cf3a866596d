"""Kimi-Linear-48B-A3B in plain float32 PyTorch: a sequence's logits from
one causal forward, a layer at a time, Kimi Delta Attention a token at a
time.

Per layer: x += MIX(norm1(x)); x += FFN(norm2(x)), MIX Kimi Delta
Attention in the layers ``linear_attn_config.kda_layers`` (numbered from
1) and latent attention in ``full_attn_layers``.

Kimi Delta Attention, per token t and head h (K = V = head_dim):
``q, k, v = x Wq, x Wk, x Wv``, each through its own depthwise causal
convolution (``short_conv_kernel_size`` taps, no bias) and SiLU; q and k
L2-normalised a head (``x rsqrt(sum x^2 + 1e-6)``), q times ``K^-0.5``;
the decay ``g = -exp(A_log[h]) softplus(x Wfa Wfb + dt_bias)`` (H, K);
``beta = sigmoid(x Wb)`` (H,); then the recurrence exactly as defined
(:func:`kda_recurrence`), ``S' = diag(exp(g_t)) S_{t-1}``, ``u = beta_t
(v_t - S'^T k_t)``, ``S_t = S' + k_t u^T``, ``o_t = S_t^T q_t``, S (K, V)
from zeros; out ``RMSNorm(o_t)`` a head (one weight of K for every head)
times ``sigmoid(x Wga Wgb)``, then ``Wo``.

Latent attention (Kimi-K2's, ``reference/mla_moe.py``, without its query
bottleneck and without RoPE, ``mla_use_nope``): ``q = x Wq`` per head
``[q_nope, q_pe]``; ``[c_kv, k_pe] = x Wkva``, ``c_kv`` normed, ``[k_nope,
v] = c_kv Wkvb`` per head, ``k_pe`` one for all heads, unrotated; scores
``(q_nope . k_nope + q_pe . k_pe) qk_head_dim^-0.5``, causal softmax,
``p v``, ``Wo``.

FFN: the first ``first_k_dense_replace`` layers a SwiGLU; the others the
held experts and the shared expert of ``reference/mla_moe.py`` (top
``num_experts_per_token`` of ``published_num_experts`` by ``sigmoid(x R) +
bias``, weights the chosen sigmoid scores over their sum times
``routed_scaling_factor``; the held ``held_first`` .. ``held_first +
num_experts - 1`` add their weighted SwiGLU, the others nothing).

Departures from the published model, as the port has them: RMSNorm's
weight is ``1 + w`` (the output norm's too); bf16 weights, A_log, dt_bias
and the selection bias f32. With ``precision="fp8"`` every product of
a weight takes float8 operands (``common.mm``); the recurrence stays f32.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .common import mm, rms_norm
from .mla_moe import HEADS_AT_ONCE, _moe, _swiglu


def kda_recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The gated delta rule a token at a time from a zero state. q, k, g:
    (N, T, H, K); v: (N, T, H, V); beta: (N, T, H). Returns o (N, T, H,
    V)."""
    N, T, H, K = k.shape
    S = torch.zeros((N, H, K, v.shape[-1]), dtype=v.dtype, device=v.device)
    o = torch.empty_like(v)
    for t in range(T):
        S = S * torch.exp(g[:, t])[..., None]
        u = beta[:, t, :, None] * (
            v[:, t] - torch.einsum("nhk,nhkv->nhv", k[:, t], S))
        S = S + k[:, t, :, :, None] * u[:, :, None, :]
        o[:, t] = torch.einsum("nhk,nhkv->nhv", q[:, t], S)
    return o


def _conv(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: ``y_t = sum_i taps[i] x_{t-w+1+i}``
    (w taps, zeros before the first position). x: (N, T, C); taps: (w,
    C)."""
    w, T = taps.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    return sum(xp[:, i:i + T] * taps[i] for i in range(w))


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def _kda(cfg: Dict, w: Dict[str, torch.Tensor], a: str, h: torch.Tensor,
         eps: float, precision: str) -> torch.Tensor:
    N, T, _ = h.shape
    la = cfg["linear_attn_config"]
    H, K = la["num_heads"], la["head_dim"]

    def branch(name):
        y = _conv(mm(h, w[f"{a}.{name}_proj"], precision),
                  w[f"{a}.{name}_conv1d"])
        return F.silu(y).reshape(N, T, H, K)

    q = _l2(branch("q")) * K ** -0.5
    k = _l2(branch("k"))
    v = branch("v")
    f = mm(mm(h, w[f"{a}.f_a_proj"], precision), w[f"{a}.f_b_proj"],
           precision) + w[f"{a}.dt_bias"]
    g = -torch.exp(w[f"{a}.A_log"])[:, None] * F.softplus(
        f.reshape(N, T, H, K))
    beta = torch.sigmoid(mm(h, w[f"{a}.b_proj"], precision))
    o = rms_norm(kda_recurrence(q, k, v, g, beta), w[f"{a}.o_norm.weight"],
                 eps)
    gate = mm(mm(h, w[f"{a}.g_a_proj"], precision), w[f"{a}.g_b_proj"],
              precision)
    o = o.reshape(N, T, H * K) * torch.sigmoid(gate)
    return mm(o, w[f"{a}.o_proj"], precision)


def _mla(cfg: Dict, w: Dict[str, torch.Tensor], a: str, h: torch.Tensor,
         eps: float, precision: str) -> torch.Tensor:
    N, T, _ = h.shape
    H = cfg["num_attention_heads"]
    nope, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    R = cfg["kv_lora_rank"]
    scale = (nope + dr) ** -0.5
    q = mm(h, w[f"{a}.q_proj"], precision).reshape(N, T, H, nope + dr)
    kva = mm(h, w[f"{a}.kv_a_proj_with_mqa"], precision)
    ckv = rms_norm(kva[..., :R], w[f"{a}.kv_a_layernorm.weight"], eps)
    kv = mm(ckv, w[f"{a}.kv_b_proj"], precision).reshape(N, T, H, nope + dv)
    k_pe = kva[..., R:]                                        # (N, T, dr)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    o = torch.empty((N, T, H, dv), device=h.device)
    for n in range(N):              # a sequence at a time
        for h0 in range(0, H, HEADS_AT_ONCE):
            hs = slice(h0, h0 + HEADS_AT_ONCE)
            s = torch.einsum("qhd,khd->hqk", q[n, :, hs, :nope],
                             kv[n, :, hs, :nope]) \
                + torch.einsum("qhd,kd->hqk", q[n, :, hs, nope:], k_pe[n])
            s = (s * scale).masked_fill(~causal, float("-inf"))
            o[n, :, hs] = torch.einsum("hqk,khd->qhd",
                                       torch.softmax(s, dim=-1),
                                       kv[n, :, hs, nope:])
    return mm(o.reshape(N, T, H * dv), w[f"{a}.o_proj"], precision)


def _moe_keys(cfg: Dict) -> Dict:
    """The keys ``mla_moe._moe`` reads, under Kimi-K2's names."""
    return {"num_experts_per_tok": cfg["num_experts_per_token"],
            "routed_scaling_factor": cfg["routed_scaling_factor"],
            "n_routed_experts": cfg["num_experts"],
            "held_first": cfg["held_first"]}


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
    kda = {n - 1 for n in cfg["linear_attn_config"]["kda_layers"]}
    moe = _moe_keys(cfg)
    outer = weights(0)
    x = outer["model.embed_tokens.weight"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        w, b = weights(i + 1), f"model.layers.{i}"
        mix = _kda if i in kda else _mla
        x = x + mix(cfg, w, f"{b}.self_attn", rms_norm(
            x, w[f"{b}.input_layernorm.weight"], eps), eps, precision)
        h = rms_norm(x, w[f"{b}.post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + _swiglu(h, w[f"{b}.mlp.gate_proj"], w[f"{b}.mlp.up_proj"],
                            w[f"{b}.mlp.down_proj"], precision)
        else:
            x = x + _moe(moe, w, f"{b}.mlp", h, precision, record)
        del w
    h = rms_norm(x[:, first:], outer["model.norm.weight"], eps)
    return mm(h, outer["lm_head.weight"], precision)
