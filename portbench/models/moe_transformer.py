"""A decoder of grouped-query attention with RoPE and a top-k mixture of
SwiGLU experts (Mixtral, arXiv:2401.04088) on the port: the
``ModelConfig`` and the benchmark's weight layout, named as the published
checkpoint names them, each mapped to the port's parameter name. The
experts of a layer are stored stacked, (E, in, out), as the port holds
them."""
from __future__ import annotations

from typing import Dict, List

from .layout import Leaf, dense, normal


def port_config(cfg: Dict):
    from repro_torch.models.config import (ATTN_LOCAL, FFN_MOE, LayerSpec,
                                           ModelConfig, MoeSpec)
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"], n_kv=cfg["n_kv"],
        head_dim=cfg["head_dim"], d_ff=cfg["d_ff"], vocab=cfg["vocab"],
        pattern=(LayerSpec(mix=ATTN_LOCAL, ffn=FFN_MOE),),
        window=cfg["window"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["norm_eps"],
        moe=MoeSpec(num_experts=cfg["num_experts"], top_k=cfg["top_k"],
                    capacity_factor=cfg["capacity_factor"]))


def layout(cfg: Dict) -> List[List[Leaf]]:
    D, F, V = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    qk = cfg["n_heads"] * cfg["head_dim"]
    kv = cfg["n_kv"] * cfg["head_dim"]
    E = cfg["num_experts"]
    outer = [Leaf("embed_tokens.weight", "embed", (V, D), "bf16",
                  normal(0.02)),
             Leaf("norm.weight", "final.w", (D,), "bf16", normal(0.1)),
             Leaf("lm_head.weight", "lm_head", (D, V), "bf16",
                  normal(cfg["head_std"]))]
    groups = [outer]
    for i in range(cfg["n_layers"]):
        b, p = f"layers.{i}", f"layers.{i}"
        groups.append([
            Leaf(f"{b}.input_layernorm.weight", f"{p}.ln1.w", (D,), "bf16",
                 normal(0.1)),
            Leaf(f"{b}.post_attention_layernorm.weight", f"{p}.ln2.w", (D,),
                 "bf16", normal(0.1)),
            Leaf(f"{b}.self_attn.q_proj", f"{p}.attn.wq", (D, qk), "bf16",
                 dense(D)),
            Leaf(f"{b}.self_attn.k_proj", f"{p}.attn.wk", (D, kv), "bf16",
                 dense(D)),
            Leaf(f"{b}.self_attn.v_proj", f"{p}.attn.wv", (D, kv), "bf16",
                 dense(D)),
            Leaf(f"{b}.self_attn.o_proj", f"{p}.attn.wo", (qk, D), "bf16",
                 dense(qk)),
            Leaf(f"{b}.block_sparse_moe.gate", f"{p}.ffn.router", (D, E),
                 "bf16", normal(0.02)),
            Leaf(f"{b}.block_sparse_moe.experts.w1", f"{p}.ffn.w1",
                 (E, D, F), "bf16", dense(D)),
            Leaf(f"{b}.block_sparse_moe.experts.w3", f"{p}.ffn.w3",
                 (E, D, F), "bf16", dense(D)),
            Leaf(f"{b}.block_sparse_moe.experts.w2", f"{p}.ffn.w2",
                 (E, F, D), "bf16", dense(F)),
        ])
    return groups
