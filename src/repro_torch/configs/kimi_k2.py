"""Kimi-K2-Instruct [moe]: 61L d_model=7168, multi-head latent attention
(64 heads; q_lora_rank 1536, kv_lora_rank 512, qk_nope 128, qk_rope 64,
v 128; YaRN RoPE, factor 32 over 4096 positions), layer 0 dense (SwiGLU
18432), layers 1-60 MoE: 384 routed experts of width 2048, top 8 by
sigmoid scores with a selection bias (noaux_tc, one group), weights
normalised over the chosen 8 and scaled by 2.827, one shared expert of
width 2048; vocab 163840. DeepSeek-V3's block (arXiv:2412.19437) at Kimi
K2's widths (arXiv:2507.20534). [hf: moonshotai/Kimi-K2-Instruct]

Not one of ``ARCH_IDS`` (the reference's assigned set, which has no
latent attention). ``CONFIG`` holds every expert of every layer;
``held=`` on its ``MoeSpec`` gives a chip's share of them.
"""
from repro_torch.models.config import (ATTN_MLA, FFN_DENSE, FFN_MOE,
                                       LayerSpec, MlaSpec, ModelConfig,
                                       MoeSpec, YarnSpec)

_LEAD = (LayerSpec(mix=ATTN_MLA, ffn=FFN_DENSE),)
_PATTERN = (LayerSpec(mix=ATTN_MLA, ffn=FFN_MOE),)

CONFIG = ModelConfig(
    name="kimi_k2", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=64, head_dim=192,
    d_ff=18432, vocab=163840, lead=_LEAD, pattern=_PATTERN,
    rope_theta=50000.0, norm_eps=1e-6,
    mla=MlaSpec(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128),
    yarn=YarnSpec(factor=32.0, original_max_position=4096, beta_fast=1.0,
                  beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
    moe=MoeSpec(num_experts=384, top_k=8, shared_expert=True,
                scoring="sigmoid", routed_scale=2.827, d_expert=2048),
)

SMOKE = ModelConfig(
    name="kimi_k2_smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=24,
    d_ff=128, vocab=512, lead=_LEAD, pattern=_PATTERN,
    rope_theta=50000.0, norm_eps=1e-6,
    mla=MlaSpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16),
    yarn=YarnSpec(factor=32.0, original_max_position=64, beta_fast=1.0,
                  beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
    moe=MoeSpec(num_experts=16, top_k=4, shared_expert=True,
                scoring="sigmoid", routed_scale=2.827, d_expert=32),
)
