"""whisper-large-v3 [audio]: enc-dec 32L each, d_model=1280 20H (MHA)
d_ff=5120 vocab=51866 — conv frontend STUB (input_specs provides frame
embeddings (B, 1500, 1280)). LayerNorm + gelu MLP. [arXiv:2212.04356]
"""
from repro_torch.models.config import (ATTN_FULL, EncoderSpec, LayerSpec,
                                       ModelConfig)

_PATTERN = (LayerSpec(mix=ATTN_FULL, cross_attn=True),)

CONFIG = ModelConfig(
    name="whisper_large_v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, head_dim=64,
    d_ff=5120, vocab=51866,
    pattern=_PATTERN, norm="ln", ffn_act="gelu", qkv_bias=True,
    encoder=EncoderSpec(n_layers=32, n_frames=1500),
    max_position=32768, norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="whisper_smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512,
    pattern=_PATTERN, norm="ln", ffn_act="gelu", qkv_bias=True,
    encoder=EncoderSpec(n_layers=2, n_frames=16),
    max_position=128, norm_eps=1e-5,
)
