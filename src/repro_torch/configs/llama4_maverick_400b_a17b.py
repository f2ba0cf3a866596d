"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + shared expert, dense/MoE
interleave (period 2, Maverick-style). Early-fusion multimodal frontend is
a stub per the assignment — text backbone only. [hf: meta-llama/Llama-4-*]
"""
from repro_torch.models.config import (ATTN_FULL, FFN_DENSE, FFN_MOE,
                                       LayerSpec, ModelConfig, MoeSpec)

_PATTERN = (LayerSpec(mix=ATTN_FULL, ffn=FFN_DENSE),
            LayerSpec(mix=ATTN_FULL, ffn=FFN_MOE))

CONFIG = ModelConfig(
    name="llama4_maverick_400b_a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, head_dim=128,
    d_ff=8192, vocab=202048,
    pattern=_PATTERN, rope_theta=5e5,
    moe=MoeSpec(num_experts=128, top_k=1, shared_expert=True),
)

SMOKE = ModelConfig(
    name="llama4_maverick_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN,
    moe=MoeSpec(num_experts=8, top_k=1, shared_expert=True),
)
