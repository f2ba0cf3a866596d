"""Kimi-Linear-48B-A3B on the port: Kimi Delta Attention layers beside
latent attention without RoPE or a query bottleneck, a leading dense
SwiGLU layer, then sigmoid-routed experts with a shared expert, of which
this chip holds ``num_experts`` of ``published_num_experts``. The
configuration file uses the published ``config.json``'s keys; the layer
kinds come from its 1-based ``linear_attn_config.kda_layers`` and
``full_attn_layers``. ``port_config`` builds the port's ``ModelConfig``;
``layout`` names the weights after the published modules
(``model.layers.<i>.self_attn.*``, ``.mlp.*``), each mapped to the port's
parameter name, products (in, out), the convolutions' taps (width,
channels), the held experts stacked (held, in, out)."""
from __future__ import annotations

import math
from typing import Dict, List

from .layout import Leaf, dense, normal, uniform


def port_config(cfg: Dict):
    from repro_torch.configs.kimi_linear_48b import published_layers
    from repro_torch.models.config import (KdaSpec, MlaSpec, ModelConfig,
                                           MoeSpec)
    la = cfg["linear_attn_config"]
    layers = published_layers(la["kda_layers"], la["full_attn_layers"],
                              cfg["first_k_dense_replace"])
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        lead=layers, pattern=(), rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"],
        mla=MlaSpec(q_lora_rank=cfg["q_lora_rank"] or 0,
                    kv_lora_rank=cfg["kv_lora_rank"],
                    qk_nope_head_dim=cfg["qk_nope_head_dim"],
                    qk_rope_head_dim=cfg["qk_rope_head_dim"],
                    v_head_dim=cfg["v_head_dim"],
                    rope=not cfg["mla_use_nope"]),
        kda=KdaSpec(num_heads=la["num_heads"], head_dim=la["head_dim"]),
        conv_width=la["short_conv_kernel_size"],
        moe=MoeSpec(num_experts=cfg["published_num_experts"],
                    top_k=cfg["num_experts_per_token"],
                    shared_expert=cfg["num_shared_experts"] > 0,
                    scoring=cfg["moe_router_activation_func"],
                    routed_scale=cfg["routed_scaling_factor"],
                    d_expert=cfg["moe_intermediate_size"],
                    held=cfg["num_experts"], held_first=cfg["held_first"]))


def _kda_leaves(cfg: Dict, a: str, m: str) -> List[Leaf]:
    D = cfg["hidden_size"]
    la = cfg["linear_attn_config"]
    H, K, w = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    W = H * K
    return [
        Leaf(f"{a}.q_proj", f"{m}.wq", (D, W), "bf16", dense(D)),
        Leaf(f"{a}.k_proj", f"{m}.wk", (D, W), "bf16", dense(D)),
        Leaf(f"{a}.v_proj", f"{m}.wv", (D, W), "bf16", dense(D)),
        Leaf(f"{a}.q_conv1d", f"{m}.q_conv", (w, W), "bf16",
             uniform(-0.5, 0.5)),
        Leaf(f"{a}.k_conv1d", f"{m}.k_conv", (w, W), "bf16",
             uniform(-0.5, 0.5)),
        Leaf(f"{a}.v_conv1d", f"{m}.v_conv", (w, W), "bf16",
             uniform(-0.5, 0.5)),
        Leaf(f"{a}.f_a_proj", f"{m}.f_a", (D, K), "bf16", dense(D)),
        Leaf(f"{a}.f_b_proj", f"{m}.f_b", (K, W), "bf16", dense(K)),
        Leaf(f"{a}.b_proj", f"{m}.b", (D, H), "bf16", dense(D)),
        Leaf(f"{a}.g_a_proj", f"{m}.g_a", (D, K), "bf16", dense(D)),
        Leaf(f"{a}.g_b_proj", f"{m}.g_b", (K, W), "bf16", dense(K)),
        Leaf(f"{a}.A_log", f"{m}.A_log", (H,), "f32",
             uniform(0.0, math.log(16.0))),
        Leaf(f"{a}.dt_bias", f"{m}.dt_bias", (W,), "f32",
             uniform(-6.9, -2.25)),
        Leaf(f"{a}.o_norm.weight", f"{m}.o_norm", (K,), "bf16",
             normal(0.1)),
        Leaf(f"{a}.o_proj", f"{m}.wo", (W, D), "bf16", dense(W)),
    ]


def _mla_leaves(cfg: Dict, a: str, m: str) -> List[Leaf]:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    R = cfg["kv_lora_rank"]
    return [
        Leaf(f"{a}.q_proj", f"{m}.wq", (D, H * (nope + rope)), "bf16",
             dense(D)),
        Leaf(f"{a}.kv_a_proj_with_mqa", f"{m}.kv_a", (D, R + rope), "bf16",
             dense(D)),
        Leaf(f"{a}.kv_a_layernorm.weight", f"{m}.kv_norm", (R,), "bf16",
             normal(0.1)),
        Leaf(f"{a}.kv_b_proj", f"{m}.kv_b", (R, H * (nope + dv)), "bf16",
             dense(R)),
        Leaf(f"{a}.o_proj", f"{m}.wo", (H * dv, D), "bf16", dense(H * dv)),
    ]


def layout(cfg: Dict) -> List[List[Leaf]]:
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    F, Fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    Fs = Fe * cfg["num_shared_experts"]
    E, held = cfg["published_num_experts"], cfg["num_experts"]
    kda = {n - 1 for n in cfg["linear_attn_config"]["kda_layers"]}
    outer = [Leaf("model.embed_tokens.weight", "embed", (V, D), "bf16",
                  normal(0.02)),
             Leaf("model.norm.weight", "final.w", (D,), "bf16", normal(0.1)),
             Leaf("lm_head.weight", "lm_head", (D, V), "bf16",
                  normal(cfg["head_std"]))]
    groups = [outer]
    for i in range(cfg["num_hidden_layers"]):
        b, p = f"model.layers.{i}", f"layers.{i}"
        leaves = [
            Leaf(f"{b}.input_layernorm.weight", f"{p}.ln1.w", (D,), "bf16",
                 normal(0.1)),
            Leaf(f"{b}.post_attention_layernorm.weight", f"{p}.ln2.w", (D,),
                 "bf16", normal(0.1)),
        ]
        leaves += (_kda_leaves(cfg, f"{b}.self_attn", f"{p}.kda") if i in kda
                   else _mla_leaves(cfg, f"{b}.self_attn", f"{p}.mla"))
        c, f = f"{b}.mlp", f"{p}.ffn"
        if i < cfg["first_k_dense_replace"]:
            leaves += [
                Leaf(f"{c}.gate_proj", f"{f}.w1", (D, F), "bf16", dense(D)),
                Leaf(f"{c}.up_proj", f"{f}.w3", (D, F), "bf16", dense(D)),
                Leaf(f"{c}.down_proj", f"{f}.w2", (F, D), "bf16", dense(F)),
            ]
        else:
            leaves += [
                Leaf(f"{c}.gate.weight", f"{f}.router", (D, E), "bf16",
                     normal(0.02)),
                Leaf(f"{c}.gate.e_score_correction_bias", f"{f}.router_bias",
                     (E,), "f32", normal(0.01)),
                Leaf(f"{c}.experts.gate_proj", f"{f}.w1", (held, D, Fe),
                     "bf16", dense(D)),
                Leaf(f"{c}.experts.up_proj", f"{f}.w3", (held, D, Fe),
                     "bf16", dense(D)),
                Leaf(f"{c}.experts.down_proj", f"{f}.w2", (held, Fe, D),
                     "bf16", dense(Fe)),
                Leaf(f"{c}.shared_experts.gate_proj", f"{f}.s1", (D, Fs),
                     "bf16", dense(D)),
                Leaf(f"{c}.shared_experts.up_proj", f"{f}.s3", (D, Fs),
                     "bf16", dense(D)),
                Leaf(f"{c}.shared_experts.down_proj", f"{f}.s2", (Fs, D),
                     "bf16", dense(Fs)),
            ]
        groups.append(leaves)
    return groups
