"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2d RoPE (half head-dim), qkv bias. [arXiv:2406.12793; hf]
"""
from repro_torch.models.config import ATTN_FULL, LayerSpec, ModelConfig

_PATTERN = (LayerSpec(mix=ATTN_FULL),)

CONFIG = ModelConfig(
    name="chatglm3_6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv=2, head_dim=128,
    d_ff=13696, vocab=65024,
    pattern=_PATTERN, rope_fraction=0.5, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="chatglm3_smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN, rope_fraction=0.5, qkv_bias=True,
)
