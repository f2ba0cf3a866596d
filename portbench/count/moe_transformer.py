"""Counts of the attention-plus-experts decoder
(``reference/moe_transformer.py`` names the products)."""
from __future__ import annotations

from typing import Dict

BF16 = 2


def _attn_params(cfg: Dict) -> int:
    D = cfg["d_model"]
    qk = cfg["n_heads"] * cfg["head_dim"]
    kv = cfg["n_kv"] * cfg["head_dim"]
    return D * qk + 2 * D * kv + qk * D


def _expert_params(cfg: Dict) -> int:
    return 3 * cfg["d_model"] * cfg["d_ff"]


def layer_params(cfg: Dict) -> int:
    D = cfg["d_model"]
    return _attn_params(cfg) + D * cfg["num_experts"] \
        + cfg["num_experts"] * _expert_params(cfg) + 2 * D


def parameters(cfg: Dict) -> int:
    D, V = cfg["d_model"], cfg["vocab"]
    return cfg["n_layers"] * layer_params(cfg) + 2 * V * D + D


def _token_flops(cfg: Dict, context: int) -> int:
    """One token a layer: its products (the top-k experts) and attention
    over ``context`` positions (scores and the weighted sum)."""
    D = cfg["d_model"]
    products = _attn_params(cfg) + D * cfg["num_experts"] \
        + cfg["top_k"] * _expert_params(cfg)
    attn = 2 * 2 * cfg["n_heads"] * cfg["head_dim"] * \
        min(context, cfg["window"])
    return 2 * products + attn


def decode_flops(cfg: Dict, batch: int, pos: int) -> int:
    head = 2 * cfg["d_model"] * cfg["vocab"]
    return batch * (cfg["n_layers"] * _token_flops(cfg, pos + 1) + head)


def prefill_flops(cfg: Dict, batch: int, prompt: int) -> int:
    head = 2 * cfg["d_model"] * cfg["vocab"]
    per_seq = sum(_token_flops(cfg, t + 1) for t in range(prompt))
    return batch * (cfg["n_layers"] * per_seq + head)


def experts_reached(cfg: Dict, batch: int) -> int:
    """Experts a step's tokens reach: all of them once the batch routes
    more slots than there are experts (with B * k >= E uniform routing
    misses one with a chance of (1 - k/E)^B, under 1e-7 at B = 64, top 2
    of 8)."""
    return min(cfg["num_experts"], batch * cfg["top_k"])


def kv_bytes(cfg: Dict, batch: int, positions: int) -> int:
    """K and V of ``positions`` positions of every layer, bf16."""
    return 2 * cfg["n_layers"] * batch * positions * cfg["n_kv"] * \
        cfg["head_dim"] * BF16


def decode_bytes(cfg: Dict, batch: int, pos: int) -> int:
    D, V, n = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    per_layer = _attn_params(cfg) + D * cfg["num_experts"] + 2 * D \
        + experts_reached(cfg, batch) * _expert_params(cfg)
    weights = (n * per_layer + D * V + D) * BF16 + batch * D * BF16
    context = min(pos + 1, cfg["window"])
    cache = kv_bytes(cfg, batch, context) + kv_bytes(cfg, batch, 1)
    return weights + cache + 2 * batch * 4
