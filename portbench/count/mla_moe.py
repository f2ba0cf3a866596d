"""Counts of DeepSeek-V3's block as the configuration holds it
(``reference/mla_moe.py`` names the products). A decode step is counted in
latent attention's absorbed form (scores over the 576-wide latent cache,
``p . c_kv``, the V half after), a prefill in the expanded form; the
routed experts' FLOPs are the expected ``k * held / E`` held experts a
token reaches, their bytes the held experts a step's batch reaches,
``held * (1 - (1 - k/E)^B)`` in expectation under uniform routing."""
from __future__ import annotations

from typing import Dict

BF16, F32 = 2, 4


def _mla_params(cfg: Dict) -> int:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    Rq, R = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    return D * Rq + Rq + Rq * H * (nope + dr) + D * (R + dr) + R \
        + R * H * (nope + dv) + H * dv * D


def _dense(cfg: Dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["intermediate_size"]


def _expert(cfg: Dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def _shared(cfg: Dict) -> int:
    return cfg["n_shared_experts"] * _expert(cfg)


def _router(cfg: Dict) -> int:
    return cfg["hidden_size"] * cfg["published_num_experts"]


def _moe_layers(cfg: Dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def parameters(cfg: Dict) -> int:
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    E = cfg["published_num_experts"]
    n, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    per = _mla_params(cfg) + 2 * D
    moe = _router(cfg) + E + cfg["n_routed_experts"] * _expert(cfg) \
        + _shared(cfg)
    return n * per + dense * _dense(cfg) + (n - dense) * moe + 2 * V * D + D


def _routed_per_token(cfg: Dict) -> float:
    """Held experts a token reaches, in expectation."""
    return cfg["num_experts_per_tok"] * cfg["n_routed_experts"] \
        / cfg["published_num_experts"]


def experts_reached(cfg: Dict, batch: int) -> float:
    """Held experts a step of ``batch`` tokens reaches, in expectation."""
    k, E = cfg["num_experts_per_tok"], cfg["published_num_experts"]
    return cfg["n_routed_experts"] * (1.0 - (1.0 - k / E) ** batch)


def _ffn_flops(cfg: Dict) -> float:
    """A token's FFN FLOPs summed over the layers."""
    moe = _router(cfg) + _routed_per_token(cfg) * _expert(cfg) \
        + _shared(cfg)
    return 2 * (cfg["first_k_dense_replace"] * _dense(cfg)
                + _moe_layers(cfg) * moe)


def _absorbed_flops(cfg: Dict, context: int) -> int:
    """One token of one layer's latent attention, absorbed, over
    ``context`` cached positions."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    Rq, R = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    products = D * Rq + Rq * H * (nope + dr) + D * (R + dr) \
        + H * nope * R + H * R * dv + H * dv * D
    return 2 * products + 2 * H * (R + dr + R) * context


def decode_flops(cfg: Dict, batch: int, pos: int) -> float:
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    attn = cfg["num_hidden_layers"] * _absorbed_flops(cfg, pos + 1)
    return batch * (attn + _ffn_flops(cfg) + head)


def prefill_flops(cfg: Dict, batch: int, prompt: int) -> float:
    """The expanded form: every position's keys and values up-projected,
    causal scores over positions 1..``prompt``; the head at the last
    position only."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    Rq, R = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    products = D * Rq + Rq * H * (nope + dr) + D * (R + dr) \
        + R * H * (nope + dv) + H * dv * D
    keys = prompt * (prompt + 1) // 2
    attn = cfg["num_hidden_layers"] * (
        2 * products * prompt + 2 * H * (nope + dr + dv) * keys)
    head = 2 * D * cfg["vocab_size"]
    return batch * (attn + prompt * _ffn_flops(cfg) + head)


def latent_bytes(cfg: Dict, batch: int, positions: int) -> int:
    """The latent cache of ``positions`` positions of every layer, bf16:
    (kv_lora_rank + qk_rope_head_dim) x 2 B = 1,152 B a position a layer
    at Kimi-K2's widths."""
    return cfg["num_hidden_layers"] * batch * positions * BF16 * (
        cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])


def decode_bytes(cfg: Dict, batch: int, pos: int) -> float:
    D, V, E = cfg["hidden_size"], cfg["vocab_size"], \
        cfg["published_num_experts"]
    n, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    bf16 = n * (_mla_params(cfg) + 2 * D) + dense * _dense(cfg) \
        + (n - dense) * (_router(cfg) + _shared(cfg)
                         + experts_reached(cfg, batch) * _expert(cfg)) \
        + D * V + D + batch * D
    weights = bf16 * BF16 + (n - dense) * E * F32
    cache = latent_bytes(cfg, batch, pos + 1) + latent_bytes(cfg, batch, 1)
    return weights + cache + 2 * batch * 4
