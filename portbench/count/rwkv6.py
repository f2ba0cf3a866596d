"""RWKV-6 counts (``reference/rwkv6.py`` names the products)."""
from __future__ import annotations

from typing import Dict

BF16, F32 = 2, 4


def _layer_product_params(cfg: Dict) -> int:
    """Weights a token multiplies through in one layer."""
    D, F = cfg["d_model"], cfg["d_ff"]
    L, L2 = cfg["rwkv_lora_mix"], cfg["rwkv_lora_decay"]
    time_mix = D * 5 * L + 5 * L * D + 5 * D * D + D * L2 + L2 * D
    channel_mix = D * D + D * F + F * D
    return time_mix + channel_mix


def _layer_params(cfg: Dict) -> Dict[str, int]:
    """A layer's weights by dtype (w0 and u are float32)."""
    D, H, hd = cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    bf16 = _layer_product_params(cfg) + 2 * D + 5 * D + D + 2 * D
    return {"bf16": bf16, "f32": D + H * hd}


def parameters(cfg: Dict) -> int:
    D, V = cfg["d_model"], cfg["vocab"]
    per = _layer_params(cfg)
    return cfg["n_layers"] * (per["bf16"] + per["f32"]) + 2 * V * D + D


def _wkv_flops(cfg: Dict) -> int:
    """One token of the recurrence a layer: k v^T, u k v^T, S + that, the
    readout r (.) (a multiply and an add), diag(w) S, + k v^T."""
    return 7 * cfg["n_heads"] * cfg["head_dim"] ** 2


def _token_flops(cfg: Dict) -> int:
    return cfg["n_layers"] * (2 * _layer_product_params(cfg)
                              + _wkv_flops(cfg))


def decode_flops(cfg: Dict, batch: int, pos: int) -> int:
    head = 2 * cfg["d_model"] * cfg["vocab"]
    return batch * (_token_flops(cfg) + head)


def prefill_flops(cfg: Dict, batch: int, prompt: int) -> int:
    head = 2 * cfg["d_model"] * cfg["vocab"]
    return batch * (prompt * _token_flops(cfg) + head)


def state_bytes(cfg: Dict, batch: int) -> int:
    """A layer's decode state: the f32 wkv state and the two bf16 token
    shifts."""
    H, hd, D = cfg["n_heads"], cfg["head_dim"], cfg["d_model"]
    return batch * (H * hd * hd * F32 + 2 * D * BF16)


def decode_bytes(cfg: Dict, batch: int, pos: int) -> int:
    D, V, n = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    per = _layer_params(cfg)
    weights = n * (per["bf16"] * BF16 + per["f32"] * F32) \
        + (D * V + D) * BF16 + batch * D * BF16
    return weights + 2 * n * state_bytes(cfg, batch) + 2 * batch * 4


def rwkv6_step_bytes(batch: int, heads: int, head_dim: int) -> int:
    """One ``rwkv6_step`` call as the port makes it: r, k, v, w f32 in, u
    f32, the state read and the new one written, y f32 out."""
    vec = batch * heads * head_dim * F32
    return 4 * vec + heads * head_dim * F32 \
        + 2 * batch * heads * head_dim * head_dim * F32 + vec
