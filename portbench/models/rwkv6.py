"""RWKV-6 "Finch" (arXiv:2404.05892) on the port: the ``ModelConfig`` and
the benchmark's weight layout, named as the published checkpoint names
them (``blocks.<i>.att.*`` time mix, ``blocks.<i>.ffn.*`` channel mix),
each mapped to the port's parameter name. Products' weights are stored
(in, out), as the port multiplies ``x @ w``."""
from __future__ import annotations

from typing import Dict, List

from .layout import Leaf, dense, normal, uniform


def port_config(cfg: Dict):
    from repro_torch.models.config import MIX_RWKV6, LayerSpec, ModelConfig
    return ModelConfig(
        name=cfg["name"], family="ssm", n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"], n_kv=cfg["n_heads"],
        head_dim=cfg["head_dim"], d_ff=cfg["d_ff"], vocab=cfg["vocab"],
        pattern=(LayerSpec(mix=MIX_RWKV6),),
        rwkv_lora_mix=cfg["rwkv_lora_mix"],
        rwkv_lora_decay=cfg["rwkv_lora_decay"], norm_eps=cfg["norm_eps"])


def layout(cfg: Dict) -> List[List[Leaf]]:
    D, F, V = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    H, hd = cfg["n_heads"], cfg["head_dim"]
    L, L2 = cfg["rwkv_lora_mix"], cfg["rwkv_lora_decay"]
    outer = [Leaf("emb.weight", "embed", (V, D), "bf16", normal(0.02)),
             Leaf("ln_out.weight", "final.w", (D,), "bf16", normal(0.1)),
             Leaf("head.weight", "lm_head", (D, V), "bf16",
                  normal(cfg["head_std"]))]
    groups = [outer]
    for i in range(cfg["n_layers"]):
        b, p = f"blocks.{i}", f"layers.{i}"
        groups.append([
            Leaf(f"{b}.ln1.weight", f"{p}.ln1.w", (D,), "bf16", normal(0.1)),
            Leaf(f"{b}.ln2.weight", f"{p}.ln2.w", (D,), "bf16", normal(0.1)),
            Leaf(f"{b}.att.time_maa", f"{p}.rwkv.mu", (5, D), "bf16",
                 uniform(0.0, 1.0)),
            Leaf(f"{b}.att.time_maa_w1", f"{p}.rwkv.maa_a", (D, 5 * L),
                 "bf16", normal(0.01)),
            Leaf(f"{b}.att.time_maa_w2", f"{p}.rwkv.maa_b", (5, L, D),
                 "bf16", normal(0.01)),
            Leaf(f"{b}.att.receptance", f"{p}.rwkv.wr", (D, D), "bf16",
                 dense(D)),
            Leaf(f"{b}.att.key", f"{p}.rwkv.wk", (D, D), "bf16", dense(D)),
            Leaf(f"{b}.att.value", f"{p}.rwkv.wv", (D, D), "bf16", dense(D)),
            Leaf(f"{b}.att.gate", f"{p}.rwkv.wg", (D, D), "bf16", dense(D)),
            Leaf(f"{b}.att.time_decay", f"{p}.rwkv.w0", (D,), "f32",
                 uniform(-5.0, -1.0)),
            Leaf(f"{b}.att.time_decay_w1", f"{p}.rwkv.wd_a", (D, L2), "bf16",
                 normal(0.01)),
            Leaf(f"{b}.att.time_decay_w2", f"{p}.rwkv.wd_b", (L2, D), "bf16",
                 normal(0.01)),
            Leaf(f"{b}.att.time_faaaa", f"{p}.rwkv.u", (H, hd), "f32",
                 normal(0.5)),
            Leaf(f"{b}.att.ln_x.weight", f"{p}.rwkv.gn_w", (D,), "bf16",
                 normal(0.1, 1.0)),
            Leaf(f"{b}.att.output", f"{p}.rwkv.wo", (D, D), "bf16", dense(D)),
            Leaf(f"{b}.ffn.time_maa_r", f"{p}.ffn.mu_r", (D,), "bf16",
                 uniform(0.0, 1.0)),
            Leaf(f"{b}.ffn.time_maa_k", f"{p}.ffn.mu_k", (D,), "bf16",
                 uniform(0.0, 1.0)),
            Leaf(f"{b}.ffn.receptance", f"{p}.ffn.wr", (D, D), "bf16",
                 dense(D)),
            Leaf(f"{b}.ffn.key", f"{p}.ffn.wk", (D, F), "bf16", dense(D)),
            Leaf(f"{b}.ffn.value", f"{p}.ffn.wv", (F, D), "bf16", dense(F)),
        ])
    return groups
