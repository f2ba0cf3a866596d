"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, local) 1:2.

38 = 12 complete (rec, rec, attn) superblocks + 2 tail recurrent blocks.
[arXiv:2402.19427]
"""
from repro_torch.models.config import (ATTN_LOCAL, MIX_RGLRU, LayerSpec,
                                       ModelConfig)

_PATTERN = (LayerSpec(mix=MIX_RGLRU), LayerSpec(mix=MIX_RGLRU),
            LayerSpec(mix=ATTN_LOCAL))

CONFIG = ModelConfig(
    name="recurrentgemma_9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, head_dim=256,
    d_ff=12288, vocab=256000,
    pattern=_PATTERN, window=2048,
    embed_scale=True, tie_embeddings=True, d_rnn=4096, conv_width=4,
)

SMOKE = ModelConfig(
    name="recurrentgemma_9b_smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv=1, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN, window=16,
    embed_scale=True, tie_embeddings=True, d_rnn=64, conv_width=4,
)
