"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (per assignment).
[arXiv:2401.04088; hf]
"""
from repro_torch.models.config import (ATTN_LOCAL, FFN_MOE, LayerSpec,
                                       ModelConfig, MoeSpec)

_PATTERN = (LayerSpec(mix=ATTN_LOCAL, ffn=FFN_MOE),)

CONFIG = ModelConfig(
    name="mixtral_8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab=32768,
    pattern=_PATTERN, window=4096, rope_theta=1e6,
    moe=MoeSpec(num_experts=8, top_k=2),
)

SMOKE = ModelConfig(
    name="mixtral_8x22b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, head_dim=8,
    d_ff=128, vocab=512,
    pattern=_PATTERN, window=32,
    moe=MoeSpec(num_experts=4, top_k=2),
)
