"""rwkv6-1.6b [ssm] "Finch": 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — data-dependent decay; 32 heads of dim 64. [arXiv:2404.05892]
"""
from repro_torch.models.config import MIX_RWKV6, LayerSpec, ModelConfig

_PATTERN = (LayerSpec(mix=MIX_RWKV6),)

CONFIG = ModelConfig(
    name="rwkv6_1p6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, head_dim=64,
    d_ff=7168, vocab=65536,
    pattern=_PATTERN,
    rwkv_lora_mix=32, rwkv_lora_decay=64,
)

SMOKE = ModelConfig(
    name="rwkv6_smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN,
    rwkv_lora_mix=8, rwkv_lora_decay=8,
)
