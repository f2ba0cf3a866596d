"""Counts of Kimi-Linear-48B-A3B as the configuration holds it
(``reference/kimi_linear.py`` names the products). Kimi Delta Attention's
recurrence is counted as its definition runs it a token (the decay on
the state, ``S'^T k``, ``k u^T``, ``S^T q``: 7 H K V), its state read and
written once a decode step; latent attention as ``count/mla_moe.py``
counts it, without the query bottleneck: a decode step in the absorbed
form over the latent cache, a prefill in the expanded form. The routed
experts as there: FLOPs for the expected ``k * held / E`` held experts a
token reaches, bytes for the held experts a step's batch reaches."""
from __future__ import annotations

from typing import Dict

from .mla_moe import experts_reached

BF16, F32 = 2, 4


def _kda_widths(cfg: Dict):
    la = cfg["linear_attn_config"]
    return la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]


def _kda_products(cfg: Dict) -> int:
    """Weights a token multiplies through in one KDA layer: q, k, v, o,
    the decay's and the output gate's two factors, beta's."""
    D = cfg["hidden_size"]
    H, K, _ = _kda_widths(cfg)
    W = H * K
    return 4 * D * W + 2 * (D * K + K * W) + D * H


def _kda_params(cfg: Dict) -> Dict[str, int]:
    """A KDA layer's weights by dtype (A_log and dt_bias are f32)."""
    H, K, w = _kda_widths(cfg)
    return {"bf16": _kda_products(cfg) + 3 * w * H * K + K,
            "f32": H + H * K}


def _mla_products(cfg: Dict) -> int:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    R = cfg["kv_lora_rank"]
    return D * H * (nope + dr) + D * (R + dr) + R * H * (nope + dv) \
        + H * dv * D


def _expert(cfg: Dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def _shared(cfg: Dict) -> int:
    return cfg["num_shared_experts"] * _expert(cfg)


def _router(cfg: Dict) -> int:
    return cfg["hidden_size"] * cfg["published_num_experts"]


def _counts(cfg: Dict):
    """(KDA layers, MLA layers, dense layers, MoE layers)."""
    la = cfg["linear_attn_config"]
    n, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    return len(la["kda_layers"]), len(la["full_attn_layers"]), dense, \
        n - dense


def parameters(cfg: Dict) -> int:
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    n_kda, n_mla, n_dense, n_moe = _counts(cfg)
    kda = sum(_kda_params(cfg).values())
    mla = _mla_products(cfg) + cfg["kv_lora_rank"]
    moe = _router(cfg) + cfg["published_num_experts"] \
        + cfg["num_experts"] * _expert(cfg) + _shared(cfg)
    dense = 3 * D * cfg["intermediate_size"]
    return n_kda * kda + n_mla * mla + (n_kda + n_mla) * 2 * D \
        + n_dense * dense + n_moe * moe + 2 * V * D + D


def _recurrence_flops(cfg: Dict) -> int:
    """One token of one KDA layer's recurrence: the decay on the state,
    S'^T k, k u^T, S^T q."""
    H, K, _ = _kda_widths(cfg)
    return 7 * H * K * K


def _ffn_flops(cfg: Dict) -> float:
    """A token's FFN FLOPs summed over the layers."""
    _, _, n_dense, n_moe = _counts(cfg)
    routed = cfg["num_experts_per_token"] * cfg["num_experts"] \
        / cfg["published_num_experts"]
    moe = _router(cfg) + routed * _expert(cfg) + _shared(cfg)
    return 2 * (n_dense * 3 * cfg["hidden_size"] * cfg["intermediate_size"]
                + n_moe * moe)


def _kda_token_flops(cfg: Dict) -> int:
    """One token through every KDA layer."""
    n_kda = _counts(cfg)[0]
    return n_kda * (2 * _kda_products(cfg) + _recurrence_flops(cfg))


def _absorbed_flops(cfg: Dict, context: int) -> int:
    """One token of one layer's latent attention, absorbed, over
    ``context`` cached positions."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    R = cfg["kv_lora_rank"]
    products = D * H * (nope + dr) + D * (R + dr) + H * nope * R \
        + H * R * dv + H * dv * D
    return 2 * products + 2 * H * (R + dr + R) * context


def decode_flops(cfg: Dict, batch: int, pos: int) -> float:
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    attn = _counts(cfg)[1] * _absorbed_flops(cfg, pos + 1)
    return batch * (_kda_token_flops(cfg) + attn + _ffn_flops(cfg) + head)


def prefill_flops(cfg: Dict, batch: int, prompt: int) -> float:
    """Latent attention in the expanded form, causal scores over positions
    1..``prompt``; the head at the last position only."""
    H = cfg["num_attention_heads"]
    nope, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    keys = prompt * (prompt + 1) // 2
    attn = _counts(cfg)[1] * (2 * _mla_products(cfg) * prompt
                              + 2 * H * (nope + dr + dv) * keys)
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return batch * (attn + prompt * (_kda_token_flops(cfg)
                                     + _ffn_flops(cfg)) + head)


def state_bytes(cfg: Dict, batch: int) -> int:
    """Every KDA layer's decode state: the f32 (H, K, K) state and the
    convolution's last inputs, bf16."""
    H, K, w = _kda_widths(cfg)
    return _counts(cfg)[0] * batch * (H * K * K * F32
                                      + (w - 1) * 3 * H * K * BF16)


def latent_bytes(cfg: Dict, batch: int, positions: int) -> int:
    """The latent cache of ``positions`` positions of every latent
    attention layer, bf16."""
    return _counts(cfg)[1] * batch * positions * BF16 * (
        cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])


def decode_bytes(cfg: Dict, batch: int, pos: int) -> float:
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    n_kda, n_mla, n_dense, n_moe = _counts(cfg)
    kda = _kda_params(cfg)
    reached = experts_reached({
        "num_experts_per_tok": cfg["num_experts_per_token"],
        "published_num_experts": cfg["published_num_experts"],
        "n_routed_experts": cfg["num_experts"]}, batch)
    bf16 = n_kda * kda["bf16"] \
        + n_mla * (_mla_products(cfg) + cfg["kv_lora_rank"]) \
        + (n_kda + n_mla) * 2 * D \
        + n_dense * 3 * D * cfg["intermediate_size"] \
        + n_moe * (_router(cfg) + _shared(cfg) + reached * _expert(cfg)) \
        + D * V + D + batch * D
    f32 = n_kda * kda["f32"] + n_moe * cfg["published_num_experts"]
    weights = bf16 * BF16 + f32 * F32
    cache = 2 * state_bytes(cfg, batch) + latent_bytes(cfg, batch, pos + 1) \
        + latent_bytes(cfg, batch, 1)
    return weights + cache + 2 * batch * 4
