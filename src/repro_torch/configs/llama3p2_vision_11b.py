"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — gated cross-attention image layers every 5th layer (8 of 40).
Vision tower is a STUB per the assignment: input_specs provides projected
patch embeddings (B, 1600, 4096). [hf: meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.models.config import ATTN_FULL, LayerSpec, ModelConfig

_PATTERN = (
    LayerSpec(mix=ATTN_FULL),
    LayerSpec(mix=ATTN_FULL),
    LayerSpec(mix=ATTN_FULL),
    LayerSpec(mix=ATTN_FULL),
    LayerSpec(mix=ATTN_FULL, cross_attn=True),
)

CONFIG = ModelConfig(
    name="llama3p2_vision_11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=128256,
    pattern=_PATTERN, rope_theta=5e5,
    n_img_tokens=1600,
)

SMOKE = ModelConfig(
    name="llama3p2_vision_smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN,
    n_img_tokens=16,
)
