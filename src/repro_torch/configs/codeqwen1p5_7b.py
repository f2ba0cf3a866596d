"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (MHA kv=32) d_ff=13440
vocab=92416 — qwen1.5 arch (qkv bias). [hf: Qwen/CodeQwen1.5-7B]
"""
from repro_torch.models.config import ATTN_FULL, LayerSpec, ModelConfig

_PATTERN = (LayerSpec(mix=ATTN_FULL),)

CONFIG = ModelConfig(
    name="codeqwen1p5_7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, head_dim=128,
    d_ff=13440, vocab=92416,
    pattern=_PATTERN, qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="codeqwen_smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN, qkv_bias=True,
)
