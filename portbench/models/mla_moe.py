"""DeepSeek-V3's block at Kimi-K2's widths (arXiv:2412.19437,
arXiv:2507.20534) on the port: multi-head latent attention with YaRN
RoPE, leading dense SwiGLU layers, then sigmoid-routed experts with a
shared expert, of which this chip holds ``n_routed_experts`` of
``published_num_experts``. The configuration file uses the published
``config.json``'s keys. ``port_config`` builds the port's ``ModelConfig``;
``layout`` names the weights as the published checkpoint does
(``model.layers.<i>.self_attn.*``, ``.mlp.*``), each mapped to the port's
parameter name, products (in, out), the held experts stacked (held, in,
out)."""
from __future__ import annotations

from typing import Dict, List

from .layout import Leaf, dense, normal


def port_config(cfg: Dict):
    from repro_torch.models.config import (ATTN_MLA, FFN_DENSE, FFN_MOE,
                                           LayerSpec, MlaSpec, ModelConfig,
                                           MoeSpec, YarnSpec)
    y = cfg["rope_scaling"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv=cfg["num_key_value_heads"], head_dim=nope + rope,
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        lead=(LayerSpec(mix=ATTN_MLA, ffn=FFN_DENSE),)
        * cfg["first_k_dense_replace"],
        pattern=(LayerSpec(mix=ATTN_MLA, ffn=FFN_MOE),),
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        mla=MlaSpec(q_lora_rank=cfg["q_lora_rank"],
                    kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=nope,
                    qk_rope_head_dim=rope, v_head_dim=cfg["v_head_dim"]),
        yarn=YarnSpec(factor=float(y["factor"]),
                      original_max_position=y[
                          "original_max_position_embeddings"],
                      beta_fast=float(y["beta_fast"]),
                      beta_slow=float(y["beta_slow"]),
                      mscale=float(y["mscale"]),
                      mscale_all_dim=float(y["mscale_all_dim"])),
        moe=MoeSpec(num_experts=cfg["published_num_experts"],
                    top_k=cfg["num_experts_per_tok"],
                    shared_expert=cfg["n_shared_experts"] > 0,
                    scoring=cfg["scoring_func"],
                    routed_scale=cfg["routed_scaling_factor"],
                    d_expert=cfg["moe_intermediate_size"],
                    held=cfg["n_routed_experts"],
                    held_first=cfg["held_first"]))


def layout(cfg: Dict) -> List[List[Leaf]]:
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H = cfg["num_attention_heads"]
    nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    Rq, Rkv = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    F, Fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    Fs = Fe * cfg["n_shared_experts"]
    E, held = cfg["published_num_experts"], cfg["n_routed_experts"]
    outer = [Leaf("model.embed_tokens.weight", "embed", (V, D), "bf16",
                  normal(0.02)),
             Leaf("model.norm.weight", "final.w", (D,), "bf16", normal(0.1)),
             Leaf("lm_head.weight", "lm_head", (D, V), "bf16",
                  normal(cfg["head_std"]))]
    groups = [outer]
    for i in range(cfg["num_hidden_layers"]):
        b, p = f"model.layers.{i}", f"layers.{i}"
        a, m = f"{b}.self_attn", f"{p}.mla"
        leaves = [
            Leaf(f"{b}.input_layernorm.weight", f"{p}.ln1.w", (D,), "bf16",
                 normal(0.1)),
            Leaf(f"{b}.post_attention_layernorm.weight", f"{p}.ln2.w", (D,),
                 "bf16", normal(0.1)),
            Leaf(f"{a}.q_a_proj", f"{m}.q_a", (D, Rq), "bf16", dense(D)),
            Leaf(f"{a}.q_a_layernorm.weight", f"{m}.q_norm", (Rq,), "bf16",
                 normal(0.1)),
            Leaf(f"{a}.q_b_proj", f"{m}.q_b", (Rq, H * (nope + rope)),
                 "bf16", dense(Rq)),
            Leaf(f"{a}.kv_a_proj_with_mqa", f"{m}.kv_a", (D, Rkv + rope),
                 "bf16", dense(D)),
            Leaf(f"{a}.kv_a_layernorm.weight", f"{m}.kv_norm", (Rkv,),
                 "bf16", normal(0.1)),
            Leaf(f"{a}.kv_b_proj", f"{m}.kv_b", (Rkv, H * (nope + dv)),
                 "bf16", dense(Rkv)),
            Leaf(f"{a}.o_proj", f"{m}.wo", (H * dv, D), "bf16",
                 dense(H * dv)),
        ]
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
