"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama arch. [arXiv:2401.14196; hf]
"""
from repro_torch.models.config import ATTN_FULL, LayerSpec, ModelConfig

_PATTERN = (LayerSpec(mix=ATTN_FULL),)

CONFIG = ModelConfig(
    name="deepseek_coder_33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv=8, head_dim=128,
    d_ff=19200, vocab=32256,
    pattern=_PATTERN, rope_theta=1e5,
)

SMOKE = ModelConfig(
    name="deepseek_smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN,
)
