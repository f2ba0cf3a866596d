"""Kimi-Linear-48B-A3B-Instruct [moe]: 27L d_model=2304, vocab 163840.
Layers 1-3, 5-7, ..., 25-26 (``kda_layers``, numbered from 1) are Kimi
Delta Attention: 32 heads of 128 keys and values, each of q, k and v
through a 4-tap depthwise causal convolution and SiLU, a gated delta rule
over an f32 128 x 128 state a head with a per-channel decay from a
rank-128 product, a gated RMSNorm out. Layers 4, 8, ..., 24 and 27
(``full_attn_layers``) are multi-head latent attention without RoPE
(``mla_use_nope``) and without a query bottleneck: 32 heads, kv_lora_rank
512, qk 128 + 64, v 128, the 64 cached and dotted unrotated. Layer 1's FFN
is dense (SwiGLU 9216); layers 2-27 route 256 experts of width 1024, top 8
by sigmoid scores with a selection bias, renormalised and scaled by
2.446, plus one shared expert of width 1024. RMSNorm eps 1e-5. [hf:
moonshotai/Kimi-Linear-48B-A3B-Instruct]

Not one of ``ARCH_IDS``. Layer 27 breaks the 3:1 period, so every layer
is stated in ``lead`` (``pattern`` empty), from the published 1-based
lists by :func:`published_layers`. ``CONFIG`` holds every expert of every
layer; ``held=`` on its ``MoeSpec`` gives a chip's share of them.
"""
from typing import Sequence, Tuple

from repro_torch.models.config import (ATTN_MLA, FFN_DENSE, FFN_MOE,
                                       MIX_KDA, KdaSpec, LayerSpec, MlaSpec,
                                       ModelConfig, MoeSpec)


def published_layers(kda_layers: Sequence[int],
                     full_attn_layers: Sequence[int], first_k_dense: int
                     ) -> Tuple[LayerSpec, ...]:
    """The layer kinds in order, from the published lists of 1-based layer
    numbers: Kimi Delta Attention or latent attention, the first
    ``first_k_dense`` with a dense FFN and the rest with experts."""
    kinds = {n: MIX_KDA for n in kda_layers}
    kinds.update({n: ATTN_MLA for n in full_attn_layers})
    n_layers = len(kda_layers) + len(full_attn_layers)
    if sorted(kinds) != list(range(1, n_layers + 1)):
        raise ValueError(f"kda_layers {list(kda_layers)} and "
                         f"full_attn_layers {list(full_attn_layers)} do not "
                         f"number the layers 1..{n_layers} once each")
    return tuple(LayerSpec(mix=kinds[n],
                           ffn=FFN_DENSE if n <= first_k_dense else FFN_MOE)
                 for n in range(1, n_layers + 1))


_LAYERS = published_layers(
    [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26],
    [4, 8, 12, 16, 20, 24, 27], 1)

CONFIG = ModelConfig(
    name="kimi_linear_48b", family="moe",
    n_layers=27, d_model=2304, n_heads=32, n_kv=32, head_dim=72,
    d_ff=9216, vocab=163840, lead=_LAYERS, pattern=(),
    rope_theta=10000.0, norm_eps=1e-5,
    mla=MlaSpec(q_lora_rank=0, kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128, rope=False),
    kda=KdaSpec(num_heads=32, head_dim=128), conv_width=4,
    moe=MoeSpec(num_experts=256, top_k=8, shared_expert=True,
                scoring="sigmoid", routed_scale=2.446, d_expert=1024),
)

_SMOKE_LAYERS = published_layers([1, 2, 4], [3, 5], 1)

SMOKE = ModelConfig(
    name="kimi_linear_smoke", family="moe",
    n_layers=5, d_model=64, n_heads=4, n_kv=4, head_dim=18,
    d_ff=128, vocab=512, lead=_SMOKE_LAYERS, pattern=(),
    rope_theta=10000.0, norm_eps=1e-5,
    mla=MlaSpec(q_lora_rank=0, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, rope=False),
    kda=KdaSpec(num_heads=4, head_dim=16), conv_width=4,
    moe=MoeSpec(num_experts=16, top_k=4, shared_expert=True,
                scoring="sigmoid", routed_scale=2.446, d_expert=32),
)
