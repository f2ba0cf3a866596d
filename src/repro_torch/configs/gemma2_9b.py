"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Local(4096)/global alternating attention, logit softcaps (50 attn / 30
final), sandwich (pre+post) norms, head_dim 256, tied embeddings, embedding
scaling. [arXiv:2408.00118; hf]
"""
from repro_torch.models.config import (ATTN_FULL, ATTN_LOCAL, LayerSpec,
                                       ModelConfig)

_PATTERN = (LayerSpec(mix=ATTN_LOCAL), LayerSpec(mix=ATTN_FULL))

CONFIG = ModelConfig(
    name="gemma2_9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv=8, head_dim=256,
    d_ff=14336, vocab=256000,
    pattern=_PATTERN, window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    embed_scale=True, tie_embeddings=True, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="gemma2_9b_smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN, window=32,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    embed_scale=True, tie_embeddings=True,
)
