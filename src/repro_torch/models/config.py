"""Model configuration: one schema covering all 10 assigned architectures.

A model is a stack of layers drawn from a repeating ``pattern`` of
:class:`LayerSpec`s (periods 1-5 cover every assigned arch). Layers inside
full pattern repetitions are executed with ``jax.lax.scan`` over stacked
parameters (compile time independent of depth); remainder layers (e.g.
recurrentgemma's 38 = 12x3 + 2) are unrolled as a tail. A model whose
layers follow no period (Kimi Linear's last layer breaks its 3:1 pattern)
states every layer in ``lead`` and leaves ``pattern`` empty.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# sequence-mixing kinds
ATTN_FULL = "full"        # causal full attention
ATTN_LOCAL = "local"      # sliding-window attention
ATTN_NONCAUSAL = "bidir"  # encoder self-attention
MIX_RGLRU = "rglru"       # RecurrentGemma recurrent block
MIX_RWKV6 = "rwkv6"       # RWKV-6 time-mix
ATTN_MLA = "mla"          # multi-head latent attention (DeepSeek-V2/V3)
MIX_KDA = "kda"           # Kimi Delta Attention (gated delta rule)

# ffn kinds
FFN_DENSE = "dense"       # swiglu (or gelu for whisper)
FFN_MOE = "moe"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mix: str = ATTN_FULL        # sequence-mixing kind
    ffn: str = FFN_DENSE
    cross_attn: bool = False    # cross-attention sublayer (enc-dec / VLM)


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    """``num_experts`` is the router's width. The defaults are the capacity
    dispatch of every expert (mixtral, llama4). ``scoring="sigmoid"`` is
    DeepSeek-V3's router (``noaux_tc``, one group): the top k of
    ``sigmoid(x R) + bias``, weighted by their sigmoid scores over the
    chosen k's sum, times ``routed_scale``; that router runs the dropless
    dispatch over the ``held`` experts ``held_first`` .. ``held_first +
    held - 1`` (0: every expert) that this chip holds of each layer, the
    others' part of the result left to the chips that hold them."""

    num_experts: int
    top_k: int
    shared_expert: bool = False   # llama4-style always-on expert
    capacity_factor: float = 1.25
    router_jitter: bool = False
    scoring: str = "softmax"      # "softmax" (k = 1: sigmoid) | "sigmoid"
    routed_scale: float = 1.0     # sigmoid scoring: the chosen weights' scale
    d_expert: int = 0             # an expert's width, shared one too (0: d_ff)
    held: int = 0                 # experts held here (0: all of them)
    held_first: int = 0           # the first held expert's index

    @property
    def n_held(self) -> int:
        return self.held or self.num_experts


@dataclasses.dataclass(frozen=True)
class MlaSpec:
    """Multi-head latent attention's widths (DeepSeek-V2,
    arXiv:2405.04434): queries through a rank-``q_lora_rank`` bottleneck
    (0: projected directly, as Kimi Linear's), keys and values from a
    ``kv_lora_rank`` latent shared by every head, plus a
    ``qk_rope_head_dim`` rotary key shared by every head. ``rope=False``
    (Kimi Linear's ``mla_use_nope``): no rotation anywhere, that part of
    the key cached and dotted as it is."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent(self) -> int:
        """A cached position's width: the latent and the rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class KdaSpec:
    """Kimi Delta Attention's widths (Moonshot AI's Kimi Linear report,
    2025): ``num_heads`` heads of ``head_dim`` keys and values each, q, k
    and v each through a depthwise causal convolution of the model's
    ``conv_width`` taps, and the decay and output gates through
    rank-``head_dim`` products. A head keeps an f32 ``head_dim`` x
    ``head_dim`` state."""

    num_heads: int
    head_dim: int

    @property
    def width(self) -> int:
        """q, k and v's width each: every head's."""
        return self.num_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class YarnSpec:
    """YaRN's RoPE scaling (arXiv:2309.00071, as DeepSeek-V3 has it)."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Whisper-style encoder (conv frontend stubbed to frame embeddings)."""

    n_layers: int
    n_frames: int = 1500          # 30 s of audio at 50 Hz post-conv


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    lead: Tuple[LayerSpec, ...] = ()   # layers before the pattern repeats
    # attention details
    window: int = 4096            # for ATTN_LOCAL layers
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # chatglm 2d-rope: 0.5
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    post_norms: bool = False      # gemma2 sandwich norms
    norm: str = "rms"             # rms | ln
    ffn_act: str = "swiglu"       # swiglu | gelu
    embed_scale: bool = False     # gemma*: x *= sqrt(d_model)
    tie_embeddings: bool = False
    # recurrent details
    d_rnn: int = 0                # rglru width (0 -> d_model)
    conv_width: int = 4           # rglru / kda temporal conv taps
    rwkv_lora_mix: int = 32
    rwkv_lora_decay: int = 64
    # latent attention (ATTN_MLA layers) and YaRN RoPE
    mla: Optional[MlaSpec] = None
    yarn: Optional[YarnSpec] = None
    # Kimi Delta Attention (MIX_KDA layers)
    kda: Optional[KdaSpec] = None
    # moe
    moe: Optional[MoeSpec] = None
    moe_groups: int = 1           # dispatch groups (set = dp degree; SPerf)
    # the reference's PartitionSpec for the (G,E,cap,D) buffer; the port
    # splits the buffer in its partitioned dispatch and reads it nowhere
    moe_pspec: Optional[object] = None
    # modality extras
    encoder: Optional[EncoderSpec] = None   # whisper
    n_img_tokens: int = 0                    # vlm cross-attn K/V length
    max_position: int = 1 << 19
    # numerics
    norm_eps: float = 1e-6
    kv_cache_dtype: str = "bf16"   # "int8": quantized decode KV (SPerf)

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def layers(self) -> Tuple[LayerSpec, ...]:
        """The full resolved per-layer spec list (lead + pattern + tail)."""
        if not self.pattern:
            return self.lead
        reps, rem = divmod(self.n_layers - len(self.lead), len(self.pattern))
        return self.lead + self.pattern * reps + self.pattern[:rem]

    @property
    def n_super(self) -> int:
        """Number of complete pattern repetitions (scanned)."""
        if not self.pattern:
            return 0
        return (self.n_layers - len(self.lead)) // len(self.pattern)

    @property
    def tail_specs(self) -> Tuple[LayerSpec, ...]:
        if not self.pattern:
            return ()
        rem = (self.n_layers - len(self.lead)) % len(self.pattern)
        return self.pattern[:rem]

    @property
    def expert_width(self) -> int:
        return self.moe.d_expert or self.d_ff

    def param_count(self) -> int:
        """Approximate total parameter count (for MODEL_FLOPS, reporting)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        qk = self.n_heads * self.head_dim
        kv = self.n_kv * self.head_dim
        total = V * D + (0 if self.tie_embeddings else D * V) + D
        for spec in self.layers:
            n = 2 * D                           # norms
            if spec.mix in (ATTN_FULL, ATTN_LOCAL, ATTN_NONCAUSAL):
                n += D * qk + 2 * D * kv + qk * D
            elif spec.mix == ATTN_MLA:
                m, H = self.mla, self.n_heads
                q = H * m.qk_head_dim
                n += (D * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * q
                      if m.q_lora_rank else D * q) \
                    + D * m.latent + m.kv_lora_rank \
                    + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim) \
                    + H * m.v_head_dim * D
            elif spec.mix == MIX_KDA:
                k = self.kda
                W, r = k.width, k.head_dim          # the gates' rank
                n += 4 * D * W + 3 * self.conv_width * W \
                    + 2 * (D * r + r * W) + D * k.num_heads \
                    + k.num_heads + W + k.head_dim  # A_log, dt_bias, norm
            elif spec.mix == MIX_RGLRU:
                R = self.rnn_width
                n += 2 * D * R + 2 * R * R + R * D + R * self.conv_width + 2 * R
            elif spec.mix == MIX_RWKV6:
                n += 4 * D * D + D * self.head_dim  # r,k,v,g,o + u; loras small
                n += D * self.rwkv_lora_mix * 10 + 2 * D * self.rwkv_lora_decay
            if spec.cross_attn:
                n += D * qk + 2 * D * kv + qk * D + D
            if spec.ffn == FFN_MOE and self.moe is not None:
                e = self.moe.num_experts
                n += D * e + self.moe.n_held * 3 * D * self.expert_width
                if self.moe.scoring == "sigmoid":
                    n += e                          # the selection bias
                if self.moe.shared_expert:
                    n += 3 * D * self.expert_width
            elif spec.mix == MIX_RWKV6:
                n += 2 * D * F                      # rwkv channel-mix (no gate)
            else:
                n += 3 * D * F if self.ffn_act == "swiglu" else 2 * D * F
            total += n
        if self.encoder is not None:
            enc_layer = 2 * D + D * qk + 2 * D * kv + qk * D + 2 * D * F
            total += self.encoder.n_layers * enc_layer + self.encoder.n_frames * D
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared instead of all; of
        a share of the experts, the held ones' expected k * held / E)."""
        if self.moe is None:
            return self.param_count()
        D, F = self.d_model, self.expert_width
        e, k, held = self.moe.num_experts, self.moe.top_k, self.moe.n_held
        inactive = 0
        for spec in self.layers:
            if spec.ffn == FFN_MOE:
                inactive += (held * e - k * held) * 3 * D * F
        return self.param_count() - inactive // e


# ---------------------------------------------------------------------------
# Input shape sets (assignment): per-arch cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = {s.name: s for s in
              (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """Which of the 4 assigned shapes apply to this arch (see DESIGN.md)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if is_subquadratic(cfg):
        out.append(LONG_500K)
    return tuple(out)


def is_subquadratic(cfg: ModelConfig) -> bool:
    """True if decode state is bounded (no full-attention layer)."""
    return all(s.mix in (MIX_RGLRU, MIX_RWKV6, MIX_KDA, ATTN_LOCAL)
               and not s.cross_attn for s in cfg.layers)
