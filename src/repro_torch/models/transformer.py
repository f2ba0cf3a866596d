"""The model zoo's single backbone in PyTorch (the reference's
``models/transformer.py``).

One implementation covers all 10 architectures of
:class:`~repro_torch.models.config.ModelConfig`: full, local (sliding
window, ring-buffer decode cache) and bidirectional attention, RG-LRU and
RWKV6 sequence mixing, swiglu and gelu FFNs, top-k MoE FFNs with a shared
expert, and beside them DeepSeek-V3's block (Kimi-K2): multi-head latent
attention over a latent decode cache, and sigmoid-routed experts of which
a chip holds a share; Kimi Linear's Kimi Delta Attention (a gated delta
rule over an f32 state a head, ``models/kda.py``) beside latent attention
without RoPE; gated cross-attention to image tokens or to the whisper encoder's
output, RMS and layer norms, learned positions and the int8 KV cache,
with the reference's dtypes (bf16 weights and activations, f32 norms and
recurrences). The reference
scans complete pattern repetitions over stacked parameters and unrolls a
tail; PyTorch runs eagerly, so :class:`Model` holds one submodule per layer
in ``cfg.layers`` order and a decode cache is a list of per-layer dicts.
``repro_torch.convert.model_state_dict`` maps the reference's stacked
parameters (and ``model_cache`` its caches) onto that order.

Training: :meth:`Model.train_params` makes the parameters require
gradients; :meth:`Model.forward` then records autograd and, as the
reference does (``remat_policy="full"``), rematerializes one
``torch.utils.checkpoint`` region a superblock of ``cfg.pattern`` layers
and one a tail layer. :meth:`Model.loss` is the reference's CE over
``labels >= 0`` plus ``0.01`` times the MoE aux loss. The whisper encoder
runs one ``torch.utils.checkpoint`` region a layer when training.
:meth:`Model.decay_names` carries the reference's weight decay layout over
(a leaf decays iff its ``ndim >= 2``, and the leaves of the reference's
superblocks and encoder layers carry a stacking axis). ``prefill`` and the
decode steps run under ``no_grad``.

Over a mesh (the partitioned train step, ``train/train_step.py``):
``forward``/``loss`` take ``params`` (each name to this rank's shard, a
plain tensor) and ``part`` (``runtime.partition.Partition``). A layer
reads how each weight is laid out from its shard's width against the
config's (a sharded width is a column- or row-parallel product, a whole
one is computed whole on every rank) and communicates through ``part``
where the layout asks; local head counts come from the shards' widths.
Such a step reads the module's own tensors for nothing but their names
and shapes, so once the state is laid out the caller drops them
(:meth:`Model.release_params`) and a rank holds only its shards.
Serving takes the same arguments (``prefill``, ``decode_step(_)``,
``init_cache``; ``serve/serve_step.py``): each rank decodes its rows
against its cache shard (``ShardingRules.cache_pspecs``: the rank's K/V
heads, or every head's head_dim chunk where the heads do not divide
"model", the rank's R, RWKV6 heads and d_model columns).

``extras`` (the reference's): ``{"frames": (B, n_frames, D)}`` for an
encoder model, ``{"img": (B, n_img_tokens, D)}`` for a vision model, both
bf16 on the model's device; the cross-attention layers read them.
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels.mla_decode import ops as mla_ops
from ..kernels.mla_decode import ref as mla_ref
from ..kernels.wkv_chunked import ops as wkv_ops
from . import kda as kd
from . import rwkv6 as rk
from ..runtime import spans
from ..runtime.partition import NO_PARTITION, Partition
from .components import (_rglru_gates, attention,
                         causal_attention_blocks, causal_conv1d, gelu_mlp,
                         layer_norm, moe_forward, moe_held_forward,
                         rglru_scan, rglru_step, rms_norm, rope, softcap,
                         swiglu, yarn_inv_freq, yarn_mscale)
from .config import (ATTN_FULL, ATTN_LOCAL, ATTN_MLA, ATTN_NONCAUSAL,
                     FFN_DENSE, FFN_MOE, MIX_KDA, MIX_RGLRU, MIX_RWKV6,
                     LayerSpec, ModelConfig)

Cache = List[Dict[str, torch.Tensor]]
_MOE_AUX_COEF = 0.01
_KDA_TOKENS = 1 << 14     # prompt tokens a Kimi Delta Attention pass takes
_ENCODER_SPEC = LayerSpec(mix=ATTN_NONCAUSAL, ffn=FFN_DENSE)


def _learned_positions(cfg: ModelConfig) -> bool:
    """Whisper's decoder adds learned positions (``pos_embed``)."""
    return bool(cfg.max_position) and cfg.norm == "ln"


# ===========================================================================
# Parameter initialization
# ===========================================================================

class _Init:
    """Draws parameters on one device from one generator, with the
    reference's shapes, dtypes and scale rules."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen, self.device = gen, device

    def param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t, requires_grad=False)

    def normal(self, shape, scale: float, dtype=torch.bfloat16):
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32).mul_(scale)
        return self.param(w.to(dtype))

    def dense(self, shape, scale: Optional[float] = None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return self.normal(shape, scale)

    def full(self, shape, value: float, dtype=torch.bfloat16):
        return self.param(torch.full(shape, value, dtype=dtype,
                                     device=self.device))


def _norm_params(cfg: ModelConfig, ini: _Init) -> nn.ParameterDict:
    if cfg.norm == "ln":
        return nn.ParameterDict({"w": ini.full((cfg.d_model,), 1.0),
                                 "b": ini.full((cfg.d_model,), 0.0)})
    return nn.ParameterDict({"w": ini.full((cfg.d_model,), 0.0)})


def _attn_params(cfg: ModelConfig, ini: _Init, cross: bool = False
                 ) -> nn.ParameterDict:
    D = cfg.d_model
    qk = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv * cfg.head_dim
    p = {"wq": ini.dense((D, qk)), "wk": ini.dense((D, kv)),
         "wv": ini.dense((D, kv)),
         "wo": ini.dense((qk, D), scale=1.0 / math.sqrt(qk))}
    if cfg.qkv_bias and not cross:
        p["bq"] = ini.full((qk,), 0.0)
        p["bk"] = ini.full((kv,), 0.0)
        p["bv"] = ini.full((kv,), 0.0)
    if cross:
        p["gate"] = ini.full((), 0.0)      # llama3.2-vision gating
    return nn.ParameterDict(p)


def _ffn_params(cfg: ModelConfig, spec: LayerSpec, ini: _Init
                ) -> nn.ParameterDict:
    D, F_ = cfg.d_model, cfg.d_ff
    if spec.mix == MIX_RWKV6:
        # rwkv channel-mix
        return nn.ParameterDict({"mu_r": ini.full((D,), 0.0),
                                 "mu_k": ini.full((D,), 0.0),
                                 "wr": ini.dense((D, D)),
                                 "wk": ini.dense((D, F_)),
                                 "wv": ini.dense((F_, D))})
    if spec.ffn == FFN_MOE:
        # the reference's scales: _Init.dense would take them from E
        E, n, Fe = cfg.moe.num_experts, cfg.moe.n_held, cfg.expert_width
        p = {"router": ini.dense((D, E), scale=0.02),
             "w1": ini.dense((n, D, Fe), scale=1.0 / math.sqrt(D)),
             "w3": ini.dense((n, D, Fe), scale=1.0 / math.sqrt(D)),
             "w2": ini.dense((n, Fe, D), scale=1.0 / math.sqrt(Fe))}
        if cfg.moe.scoring == "sigmoid":
            p["router_bias"] = ini.full((E,), 0.0, torch.float32)
        if cfg.moe.shared_expert:
            p["s1"] = ini.dense((D, Fe))
            p["s3"] = ini.dense((D, Fe))
            p["s2"] = ini.dense((Fe, D))
        return nn.ParameterDict(p)
    if cfg.ffn_act == "gelu":
        return nn.ParameterDict({"w1": ini.dense((D, F_)),
                                 "b1": ini.full((F_,), 0.0),
                                 "w2": ini.dense((F_, D)),
                                 "b2": ini.full((D,), 0.0)})
    return nn.ParameterDict({"w1": ini.dense((D, F_)),
                             "w3": ini.dense((D, F_)),
                             "w2": ini.dense((F_, D))})


def _mla_params(cfg: ModelConfig, ini: _Init) -> nn.ParameterDict:
    """Latent attention's products, (in, out), and its norms: the query's
    bottleneck ``q_a``, ``q_norm``, ``q_b``, or without one ``wq``."""
    D, H, m = cfg.d_model, cfg.n_heads, cfg.mla
    q = {"q_a": ini.dense((D, m.q_lora_rank)),
         "q_norm": ini.full((m.q_lora_rank,), 0.0),
         "q_b": ini.dense((m.q_lora_rank, H * m.qk_head_dim))} \
        if m.q_lora_rank else {"wq": ini.dense((D, H * m.qk_head_dim))}
    return nn.ParameterDict({
        **q,
        "kv_a": ini.dense((D, m.latent)),
        "kv_norm": ini.full((m.kv_lora_rank,), 0.0),
        "kv_b": ini.dense((m.kv_lora_rank,
                           H * (m.qk_nope_head_dim + m.v_head_dim))),
        "wo": ini.dense((H * m.v_head_dim, D)),
    })


def _kda_params(cfg: ModelConfig, ini: _Init) -> nn.ParameterDict:
    """Kimi Delta Attention's products (in, out), its convolutions' taps
    (width, q/k/v width), the gates' rank-``head_dim`` products, the f32
    ``A_log`` (a head) and ``dt_bias`` (a channel), and the output norm's
    weight, one for every head."""
    D, k = cfg.d_model, cfg.kda
    W, r = k.width, k.head_dim
    f32 = torch.float32
    return nn.ParameterDict({
        "wq": ini.dense((D, W)),
        "wk": ini.dense((D, W)),
        "wv": ini.dense((D, W)),
        "q_conv": ini.dense((cfg.conv_width, W), scale=0.3),
        "k_conv": ini.dense((cfg.conv_width, W), scale=0.3),
        "v_conv": ini.dense((cfg.conv_width, W), scale=0.3),
        "f_a": ini.dense((D, r)),
        "f_b": ini.dense((r, W)),
        "b": ini.dense((D, k.num_heads)),
        "g_a": ini.dense((D, r)),
        "g_b": ini.dense((r, W)),
        "A_log": ini.full((k.num_heads,), 0.0, f32),
        "dt_bias": ini.full((W,), -4.0, f32),      # a decay ~0.98 a token
        "o_norm": ini.full((k.head_dim,), 0.0),
        "wo": ini.dense((W, D)),
    })


def _rglru_params(cfg: ModelConfig, ini: _Init) -> nn.ParameterDict:
    D, R = cfg.d_model, cfg.rnn_width
    f32 = torch.float32
    return nn.ParameterDict({
        "w_gate": ini.dense((D, R)),
        "w_in": ini.dense((D, R)),
        "conv_w": ini.dense((cfg.conv_width, R), scale=0.3),
        "w_a": ini.dense((R, R)),
        "b_a": ini.full((R,), 0.0, f32),
        "w_x": ini.dense((R, R)),
        "b_x": ini.full((R,), 0.0, f32),
        "lam": ini.full((R,), -4.35, f32),   # a ~ 0.95 at r=0.5
        "w_out": ini.dense((R, D)),
    })


def _rwkv_params(cfg: ModelConfig, ini: _Init) -> nn.ParameterDict:
    D = cfg.d_model
    H, hd = cfg.n_heads, cfg.head_dim
    L, L2 = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    f32 = torch.float32
    return nn.ParameterDict({
        "mu": ini.full((5, D), 0.0),              # r,k,v,g,w lerp base
        "maa_a": ini.dense((D, 5 * L), scale=0.01),
        "maa_b": ini.normal((5, L, D), 0.01),
        "wr": ini.dense((D, D)),
        "wk": ini.dense((D, D)),
        "wv": ini.dense((D, D)),
        "wg": ini.dense((D, D)),
        "w0": ini.full((D,), -3.9, f32),          # base decay ~0.98
        "wd_a": ini.dense((D, L2), scale=0.01),
        "wd_b": ini.normal((L2, D), 0.01),
        "u": ini.normal((H, hd), 0.02, f32),
        "gn_w": ini.full((D,), 1.0),
        "wo": ini.dense((D, D)),
    })


def _layer_params(cfg: ModelConfig, spec: LayerSpec, ini: _Init
                  ) -> nn.ModuleDict:
    p: Dict[str, nn.Module] = {"ln1": _norm_params(cfg, ini),
                               "ln2": _norm_params(cfg, ini)}
    if cfg.post_norms:
        p["ln1p"] = _norm_params(cfg, ini)
        p["ln2p"] = _norm_params(cfg, ini)
    if spec.mix in (ATTN_FULL, ATTN_LOCAL, ATTN_NONCAUSAL):
        p["attn"] = _attn_params(cfg, ini)
    elif spec.mix == ATTN_MLA:
        p["mla"] = _mla_params(cfg, ini)
    elif spec.mix == MIX_KDA:
        p["kda"] = _kda_params(cfg, ini)
    elif spec.mix == MIX_RGLRU:
        p["rglru"] = _rglru_params(cfg, ini)
    elif spec.mix == MIX_RWKV6:
        p["rwkv"] = _rwkv_params(cfg, ini)
    if spec.cross_attn:
        p["lnx"] = _norm_params(cfg, ini)
        p["xattn"] = _attn_params(cfg, ini, cross=True)
    p["ffn"] = _ffn_params(cfg, spec, ini)
    return nn.ModuleDict(p)


class _Encoder(nn.Module):
    """The whisper-style encoder's parameters: learned frame positions
    ``pos`` (n_frames, D), one layer module each in ``layers`` (the
    reference stacks them), and the final norm."""

    def __init__(self, cfg: ModelConfig, ini: _Init) -> None:
        super().__init__()
        enc = cfg.encoder
        self.layers = nn.ModuleList(_layer_params(cfg, _ENCODER_SPEC, ini)
                                    for _ in range(enc.n_layers))
        self.pos = ini.normal((enc.n_frames, cfg.d_model), 0.01)
        self.final = _norm_params(cfg, ini)


# ===========================================================================
# Layer application (sequence mode and step mode share sublayer helpers)
# ===========================================================================

def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "ln":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w
    return y if b is None else y + b


def _col_in(part: Partition, x: torch.Tensor, sharded: bool
            ) -> torch.Tensor:
    """``x`` as the input of a product whose weight's columns may be
    sharded over "model" (then its gradient sums over the ranks)."""
    return part.copy(x) if sharded else x


def _row_out(part: Partition, y: torch.Tensor, sharded: bool
             ) -> torch.Tensor:
    """A product whose weight's rows may be sharded over "model": then
    ``y`` is this rank's partial sum, reduced over the ranks."""
    return part.reduce(y) if sharded else y


def _attn_inputs(cfg: ModelConfig, p, h: torch.Tensor, src: torch.Tensor,
                 part: Partition):
    """q from ``h``, k and v from ``src`` (``h`` itself for self
    attention), as the attention over "model" reads them. Returns (q
    (B, S, Hq, hd), k, v (B, T, Hk, hd), local): with ``local`` q holds
    this rank's heads (the projection's columns are sharded and whole
    heads each); else q and k/v hold every head on every rank. A head
    split across ranks (columns sharded, the head count not divisible)
    is gathered before the head reshape; so are K/V whose heads do not
    divide under local q heads, whose gradient is then a part a rank."""
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q_sh = p["wq"].shape[-1] != H * hd
    kv_sh = p["wk"].shape[-1] != K * hd
    local = q_sh and H % part.tp == 0
    hc = _col_in(part, h, q_sh)
    sc = (hc if src is h else part.copy(src)) if kv_sh else src
    bias = "bq" in p
    q = _proj(hc, p["wq"], p["bq"] if bias else None)
    k = _proj(sc, p["wk"], p["bk"] if bias else None)
    v = _proj(sc, p["wv"], p["bv"] if bias else None)
    if q_sh and not local:
        q = part.gather(q)
    if kv_sh and not (local and K % part.tp == 0):
        k, v = part.gather(k, partial=local), part.gather(v, partial=local)
    elif local and not kv_sh:
        k, v = part.copy(k), part.copy(v)
    B, S, T = h.shape[0], h.shape[1], src.shape[1]
    return (q.reshape(B, S, -1, hd), k.reshape(B, T, -1, hd),
            v.reshape(B, T, -1, hd), local)


def _kv_for_heads(cfg: ModelConfig, part: Partition, k: torch.Tensor,
                  v: torch.Tensor, local: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Under local q heads and every K/V head: the K/V head of each local
    query head (query head h reads KV head h // G, GQA), one a head."""
    if not local or k.shape[2] != cfg.n_kv or part.tp == 1:
        return k, v
    n = cfg.n_heads // part.tp
    idx = (part.tp_rank * n + torch.arange(n, device=k.device)) // (
        cfg.n_heads // cfg.n_kv)
    return k.index_select(2, idx), v.index_select(2, idx)


def _attn_out(part: Partition, out: torch.Tensor, wo: torch.Tensor,
              local: bool) -> torch.Tensor:
    """(B, S, Hq, hd) @ wo: row-parallel over local heads; heads that
    every rank holds feed a row-sharded wo through this rank's columns."""
    B, S = out.shape[:2]
    o = out.reshape(B, S, -1)
    if local:
        return part.reduce(o @ wo)
    if wo.shape[0] != o.shape[-1]:
        return part.reduce(part.split(o) @ wo)
    return o @ wo


def _self_attn_seq(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor,
                   positions: torch.Tensor, kv_chunk: int,
                   part: Partition = NO_PARTITION
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Full-sequence self attention; returns (out, kv-for-cache)."""
    q, k, v, local = _attn_inputs(cfg, p, x, x, part)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    kq, vq = _kv_for_heads(cfg, part, k, v, local)
    causal = spec.mix != ATTN_NONCAUSAL
    window = cfg.window if spec.mix == ATTN_LOCAL else 0
    out = attention(q, kq, vq, q_pos=positions, kv_pos=positions,
                    causal=causal, window=window,
                    logit_softcap=cfg.attn_softcap, kv_chunk=kv_chunk)
    return _attn_out(part, out, p["wo"], local), (k, v)


def _whole(part: Partition, t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with its last dim of ``n`` whole: gathered over "model" where
    it holds this rank's columns."""
    return part.gather(t) if t.shape[-1] != n else t


def _share(part: Partition, t: torch.Tensor, like: torch.Tensor,
           dim: int = -1) -> torch.Tensor:
    """This rank's chunk over "model" of ``t`` along ``dim`` where the
    shard ``like`` holds a part of it, else ``t``."""
    return part.split(t, dim) if t.shape[dim] != like.shape[dim] else t


def _attend(part: Partition, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, **kw) -> torch.Tensor:
    """``attention`` of q (B, S, H, hd, every head whole where k holds a
    head_dim chunk) to a cache shard k, v. Where the shard holds every
    head's head_dim chunk, the scores over the rank's chunk are summed
    over "model" in f32 before the softcap and the mask, and each rank's
    chunk of ``p @ v`` is gathered: the cache is never gathered."""
    if k.shape[-1] == q.shape[-1]:
        return attention(q, k, v, **kw)
    out = attention(part.split(q), k, v, head_dim=q.shape[-1],
                    scores=part.reduce, **kw)
    return part.gather(out)


def _cross_core(q: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                kv_chunk: int, part: Partition = NO_PARTITION
                ) -> torch.Tensor:
    """Attention to every source position (no positions, no mask)."""
    S, src_len = q.shape[1], xk.shape[1]
    kv_pos = torch.arange(src_len, device=q.device)
    q_pos = torch.full((S,), src_len, dtype=torch.int64,
                       device=q.device)            # attend to everything
    return _attend(part, q, xk, xv, q_pos=q_pos, kv_pos=kv_pos,
                   causal=False, kv_chunk=kv_chunk)


def _gated(p, out: torch.Tensor) -> torch.Tensor:
    if "gate" in p:
        out = torch.tanh(p["gate"].float()).to(out.dtype) * out
    return out


def _source_kv(cfg: ModelConfig, p, src: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cross layer's K/V of the whole source (what prefill caches)."""
    B, T, _ = src.shape
    xk = (src @ p["wk"]).reshape(B, T, cfg.n_kv, cfg.head_dim)
    xv = (src @ p["wv"]).reshape(B, T, cfg.n_kv, cfg.head_dim)
    return xk, xv


def _cross_attn(cfg: ModelConfig, p, x: torch.Tensor, xk: torch.Tensor,
                xv: torch.Tensor, kv_chunk: int,
                part: Partition = NO_PARTITION) -> torch.Tensor:
    """Cross attention to precomputed source K/V (the decode step), a
    cache shard over "model": q holds the rank's heads where the shard
    holds the rank's K/V heads, else every head."""
    B, S, _ = x.shape
    local = xk.shape[2] != cfg.n_kv
    q = x @ p["wq"]
    if not local:
        q = _whole(part, q, cfg.n_heads * cfg.head_dim)
    out = _cross_core(q.reshape(B, S, -1, cfg.head_dim), xk, xv, kv_chunk,
                      part)
    return _gated(p, _attn_out(part, out, p["wo"], local))


def _rwkv_channel_mix(cfg: ModelConfig, p, x: torch.Tensor,
                      xprev: torch.Tensor, part: Partition = NO_PARTITION
                      ) -> torch.Tensor:
    """``wk`` shards d_ff, ``wr`` and ``wv`` their d_model columns over
    "model": ``kk`` is gathered whole for ``wv``, the output gathered."""
    mr = x + p["mu_r"] * (xprev - x)
    mk = x + p["mu_k"] * (xprev - x)
    f_sh = p["wk"].shape[-1] != cfg.d_ff
    d_sh = p["wr"].shape[-1] != cfg.d_model
    kk = torch.square(F.relu(_col_in(part, mk, f_sh) @ p["wk"]))
    if f_sh:
        kk = part.gather(kk, partial=d_sh)
    else:
        kk = _col_in(part, kk, d_sh)
    out = torch.sigmoid(_col_in(part, mr, d_sh) @ p["wr"]) * (kk @ p["wv"])
    return part.gather(out) if d_sh else out


def _ffn_apply(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor,
               part: Partition = NO_PARTITION
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, moe_aux_loss)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mix == MIX_RWKV6:
        return _rwkv_channel_mix(cfg, p, x, rk.token_shift(x), part), zero
    if spec.ffn == FFN_MOE:
        shared = (p["s1"], p["s3"], p["s2"]) if "s1" in p else None
        if cfg.moe.scoring == "sigmoid":
            _one_rank(part, "sigmoid-routed experts")
            return moe_held_forward(x, p["router"], p["router_bias"],
                                    p["w1"], p["w3"], p["w2"], cfg.moe,
                                    shared)
        return moe_forward(x, p["router"], p["w1"], p["w3"], p["w2"],
                           cfg.moe, shared, groups=cfg.moe_groups,
                           part=part, d_ff=cfg.d_ff)
    sh = p["w1"].shape[-1] != cfg.d_ff
    xc = _col_in(part, x, sh)
    if cfg.ffn_act == "gelu":
        return gelu_mlp(xc, p["w1"], p["b1"], p["w2"], p["b2"],
                        lambda y: _row_out(part, y, sh)), zero
    return _row_out(part, swiglu(xc, p["w1"], p["w3"], p["w2"]), sh), zero


def _rwkv_timemix_prep(cfg: ModelConfig, p, x: torch.Tensor,
                       xprev: torch.Tensor, part: Partition = NO_PARTITION):
    """Shared r,k,v,g,lw computation for seq and step modes (f32 outputs).

    Over "model" (d_model sharded): the mixes are made on this rank's
    d_model columns (``mu``, ``maa_b``) and gathered whole for the
    column-parallel ``wr wk wv wg``, so r, k, v, g and the decay hold
    this rank's heads; the LoRA inner dims (``maa_a``, ``wd_a``) are
    gathered whole where the rules shard them."""
    B, S = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    L = cfg.rwkv_lora_mix
    d_sh = p["wr"].shape[-1] != cfg.d_model
    a_sh = p["maa_a"].shape[-1] != 5 * L
    w_sh = p["wd_a"].shape[-1] != cfg.rwkv_lora_decay
    if d_sh and cfg.n_heads % part.tp:
        raise ValueError(f"rwkv6: {cfg.n_heads} heads do not divide over "
                         f"{part.tp} 'model' ranks")
    dx = xprev - x
    dyn = torch.tanh(_col_in(part, dx, a_sh) @ p["maa_a"])   # (B,S,5L)
    if a_sh:
        dyn = part.gather(dyn, partial=d_sh)
    else:
        dyn = _col_in(part, dyn, d_sh)
    dyn = dyn.reshape(B, S, 5, L)
    xl, dxl = (part.split(x), part.split(dx)) if d_sh else (x, dx)
    mixes = [xl + (p["mu"][i] + dyn[:, :, i] @ p["maa_b"][i]) * dxl
             for i in range(5)]
    if d_sh:
        m = part.gather(torch.stack(mixes), partial=w_sh)
        mc = m if w_sh else part.copy(m)
        mixes = [mc[0], mc[1], mc[2], mc[3], m[4]]
    else:
        mixes[4] = _col_in(part, mixes[4], w_sh)
    mr, mk, mv, mg, mw = mixes
    r = (mr @ p["wr"]).float().reshape(B, S, -1, hd)
    k = (mk @ p["wk"]).float().reshape(B, S, -1, hd)
    v = (mv @ p["wv"]).float().reshape(B, S, -1, hd)
    g = mg @ p["wg"]
    t = torch.tanh(mw @ p["wd_a"])
    if w_sh:
        t = part.gather(t, partial=d_sh)
    else:
        t = _col_in(part, t, d_sh)
    dd = t @ p["wd_b"]                                    # (B,S,D)
    lw = -torch.exp(p["w0"] + dd.float())                # log decay <= 0
    lw = lw.reshape(B, S, -1, hd)
    return r, k, v, g, lw


def _rwkv_out(cfg: ModelConfig, p, y: torch.Tensor, g: torch.Tensor,
              B: int, S: int, part: Partition = NO_PARTITION
              ) -> torch.Tensor:
    """Per-head group-norm + silu gate + output proj (row-parallel)."""
    yf = y.reshape(B, S, -1, cfg.head_dim)
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, correction=0)
    yf = (yf - mu) * torch.rsqrt(var + 1e-5)
    yf = yf.reshape(B, S, -1) * p["gn_w"].float()
    out = (yf.to(g.dtype) * F.silu(g)) @ p["wo"]
    return _row_out(part, out, p["wo"].shape[0] != cfg.d_model)


def _one_rank(part: Partition, what: str) -> None:
    """Raises for a partition of more than one rank (``what`` runs on the
    rank's own share only: no collective is written for it)."""
    if not part.trivial:
        raise ValueError(f"{what} run on one rank: no partitioned form")


@functools.lru_cache(maxsize=None)
def _mla_rope(cfg: ModelConfig, device: torch.device
              ) -> Tuple[Optional[torch.Tensor], float]:
    """Latent attention's rotary frequencies on ``device`` (YaRN's where
    ``cfg.yarn``; None without RoPE) and its softmax scale,
    ``qk_head_dim^-0.5`` times YaRN's ``mscale(factor, mscale_all_dim)^2``
    (DeepSeek-V3's)."""
    m, y = cfg.mla, cfg.yarn
    d = m.qk_rope_head_dim
    if not m.rope:
        return None, m.qk_head_dim ** -0.5
    if y is None:
        freq = cfg.rope_theta ** (-torch.arange(0, d // 2,
                                                dtype=torch.float32) / (d // 2))
        return freq.to(device), m.qk_head_dim ** -0.5
    scale = m.qk_head_dim ** -0.5
    if y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return yarn_inv_freq(d, cfg.rope_theta, y).to(device), scale


def _mla_q(cfg: ModelConfig, p, h: torch.Tensor, positions: torch.Tensor
           ) -> torch.Tensor:
    """Queries (B, S, H, qk_head_dim): through the q bottleneck and its
    norm (or ``wq`` where there is none), the rotary part turned (RoPE
    halves rotated) where the model has RoPE."""
    m = cfg.mla
    B, S, _ = h.shape
    freq, _ = _mla_rope(cfg, h.device)
    if m.q_lora_rank:
        q = rms_norm(h @ p["q_a"], p["q_norm"], cfg.norm_eps) @ p["q_b"]
    else:
        q = h @ p["wq"]
    q = q.reshape(B, S, cfg.n_heads, m.qk_head_dim)
    if freq is not None:
        nope = m.qk_nope_head_dim
        q[..., nope:] = rope(q[..., nope:], positions, inv_freq=freq)
    return q


def _mla_latent(cfg: ModelConfig, p, h: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """What the cache holds of each position (B, S, latent): the normed
    ``c_kv`` and the rotary key ``k_pe`` (unrotated without RoPE), shared
    by every head."""
    R = cfg.mla.kv_lora_rank
    freq, _ = _mla_rope(cfg, h.device)
    kv = h @ p["kv_a"]
    c = rms_norm(kv[..., :R], p["kv_norm"], cfg.norm_eps)
    k_pe = kv[..., R:] if freq is None else rope(
        kv[..., None, R:], positions, inv_freq=freq)[..., 0, :]
    return torch.cat([c, k_pe], dim=-1)


def _mla_seq(cfg: ModelConfig, p, h: torch.Tensor, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent attention over a whole sequence, in the expanded form: each
    sequence's latent up-projected to every head's keys and values, laid
    out a head at a time, then causal attention a block of queries at a
    time (f32 scores bounded by the block). Returns (out, latent for the
    cache)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = h.shape
    R, nope = m.kv_lora_rank, m.qk_nope_head_dim
    _, scale = _mla_rope(cfg, h.device)
    q = _mla_q(cfg, p, h, positions)
    latent = _mla_latent(cfg, p, h, positions)
    out = torch.empty((B, S, H, m.v_head_dim), dtype=h.dtype,
                      device=h.device)
    for b in range(B):
        kv = (latent[b, :, :R] @ p["kv_b"]).reshape(S, H, -1)
        k = torch.empty((H, S, m.qk_head_dim), dtype=h.dtype,
                        device=h.device)
        k[..., :nope] = kv[..., :nope].transpose(0, 1)
        k[..., nope:] = latent[b, None, :, R:]
        out[b] = causal_attention_blocks(
            q[b].transpose(0, 1).contiguous(), k,
            kv[..., nope:].transpose(0, 1).contiguous(), scale)
    return out.reshape(B, S, -1) @ p["wo"], latent


def _mla_step_(cfg: ModelConfig, p, cache: Dict[str, torch.Tensor],
               h: torch.Tensor, pos_t: torch.Tensor) -> torch.Tensor:
    """One decode position of latent attention in the absorbed form,
    writing its latent into ``cache["latent"]``: ``q_nope`` taken into the
    latent space through ``kv_b``'s key half, scores ``q_lat . c_kv +
    q_pe . k_pe`` and ``p . c_kv`` over the latent cache (bf16 operands,
    f32 scores and softmax), then out through ``kv_b``'s value half and
    ``wo``. The scores through ``p . c_kv`` run in the ``mla_decode``
    kernel where it takes the tensors (``mla_decode.ops.takes``: CUDA, a
    bf16 cache of rank 512, heads a multiple of 64), else as the plain
    chain of batched products (``mla_decode.ref``). Device spans ``.q``,
    ``.kv_write``, ``.attend`` and ``.out``."""
    m, H = cfg.mla, cfg.n_heads
    B = h.shape[0]
    R, nope = m.kv_lora_rank, m.qk_nope_head_dim
    _, scale = _mla_rope(cfg, h.device)
    posv = pos_t.reshape(1)
    lat = cache["latent"]
    L = lat.shape[1]
    with spans.device_span(".q"):
        q = _mla_q(cfg, p, h, posv)[:, 0]                   # (B, H, dq)
    with spans.device_span(".kv_write"):
        lat.index_copy_(1, torch.clamp(posv, max=L - 1),
                        _mla_latent(cfg, p, h, posv).to(lat.dtype))
    wkv = p["kv_b"].reshape(R, H, -1)
    with spans.device_span(".attend"):
        q_lat = torch.bmm(q[..., :nope].transpose(0, 1),
                          wkv[..., :nope].permute(1, 2, 0))  # (H, B, R)
        qf = torch.cat([q_lat.transpose(0, 1), q[..., nope:]], dim=-1)
        attend = (mla_ops.mla_decode if mla_ops.takes(qf, lat, R)
                  else mla_ref.mla_decode_ref)
        o_lat = attend(qf, lat, pos_t, scale, R)            # (B, H, R)
    with spans.device_span(".out"):
        o = torch.bmm(o_lat.transpose(0, 1),
                      wkv[..., nope:].permute(1, 0, 2))     # (H, B, dv)
        return (o.transpose(0, 1).reshape(B, 1, -1) @ p["wo"])


def _kda_in(cfg: ModelConfig, p, h: torch.Tensor,
            conv: Optional[torch.Tensor] = None):
    """Kimi Delta Attention's inputs from ``h`` (B, S, D), after the
    convolution's last inputs ``conv`` (B, conv_width - 1, 3 x H x K;
    zeros where None): q, k (L2-normed a head, q times K^-0.5) and v, each
    through its depthwise causal convolution and SiLU, (B, S, H, K); the
    decay ``g = -exp(A_log) softplus(x f_a f_b + dt_bias)`` (B, S, H, K);
    ``beta = sigmoid(x b)`` (B, S, H); all f32; the output gate's logits
    (B, S, H x K) and the convolution's new last inputs, in h's dtype."""
    kc = cfg.kda
    B, S, _ = h.shape
    H, K = kc.num_heads, kc.head_dim
    x = torch.cat([h @ p["wq"], h @ p["wk"], h @ p["wv"]], dim=-1)
    w = torch.cat([p["q_conv"], p["k_conv"], p["v_conv"]], dim=-1)
    y, tail = causal_conv1d(x.float(), w.float(),
                            None if conv is None else conv.float())
    q, k, v = F.silu(y).reshape(B, S, 3, H, K).unbind(2)
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-6) * K ** -0.5
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-6)
    f = ((h @ p["f_a"]) @ p["f_b"]).float() + p["dt_bias"]
    g = -torch.exp(p["A_log"])[:, None] * F.softplus(f.reshape(B, S, H, K))
    beta = torch.sigmoid((h @ p["b"]).float())
    gate = (h @ p["g_a"]) @ p["g_b"]
    return q, k, v, g, beta, gate, tail.to(h.dtype)


def _kda_out(cfg: ModelConfig, p, o: torch.Tensor, gate: torch.Tensor
             ) -> torch.Tensor:
    """o (B, S, H, V) f32 through the norm a head (one weight for every
    head), times ``sigmoid(gate)``, then ``wo``."""
    B, S = o.shape[:2]
    o = rms_norm(o, p["o_norm"], cfg.norm_eps) * torch.sigmoid(
        gate.float()).reshape(o.shape)
    return o.to(gate.dtype).reshape(B, S, -1) @ p["wo"]


def _kda_seq(cfg: ModelConfig, p, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kimi Delta Attention over whole sequences, the chunked form
    (``kda.kda_chunked``), as many sequences at a time as hold
    ``_KDA_TOKENS`` tokens (the f32 intermediates of a pass are a few
    times its q). Returns (out, the final states (B, H, K, V), the
    convolution's last inputs); device span ``.kda_chunk`` around each
    pass's recurrence."""
    rows = max(1, _KDA_TOKENS // h.shape[1])
    outs, states, tails = [], [], []
    for b in range(0, h.shape[0], rows):
        hb = h[b:b + rows]
        q, k, v, g, beta, gate, tail = _kda_in(cfg, p, hb)
        with spans.device_span(".kda_chunk"):
            o, s = kd.kda_chunked(q, k, v, g, beta)
        del q, k, v, g, beta
        outs.append(_kda_out(cfg, p, o, gate))
        states.append(s)
        tails.append(tail)
    return torch.cat(outs), torch.cat(states), torch.cat(tails)


def _kda_step_(cfg: ModelConfig, p, cache: Dict[str, torch.Tensor],
               h: torch.Tensor) -> torch.Tensor:
    """One decode position of Kimi Delta Attention: the state
    ``cache["s"]`` and the convolution's last inputs ``cache["conv"]``
    written in place. Device spans ``.kda_in`` (projections, convolution,
    norms, gates), ``.kda_state`` (the recurrence) and ``.kda_out``."""
    with spans.device_span(".kda_in"):
        q, k, v, g, beta, gate, tail = _kda_in(cfg, p, h, cache["conv"])
        cache["conv"].copy_(tail)
    with spans.device_span(".kda_state"):
        o = kd.kda_step_(cache["s"], q[:, 0], k[:, 0], v[:, 0], g[:, 0],
                         beta[:, 0])
    with spans.device_span(".kda_out"):
        return _kda_out(cfg, p, o[:, None], gate)


def apply_layer_seq(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor,
                    positions: torch.Tensor, kv_chunk: int = 1024,
                    want_cache: bool = False,
                    extras: Optional[Dict[str, torch.Tensor]] = None,
                    part: Partition = NO_PARTITION
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """One layer over a full sequence. Returns (x, aux_loss, cache_blob).
    A cross-attention layer reads ``extras["src"]`` (B, T, D), the
    source its K/V come from (:meth:`Model._extras`). Over a mesh ``p``
    holds this rank's shards and ``x`` this rank's rows, whole over
    "model" (``part``; module docstring). Device spans (``runtime.spans``)
    ``prefill.mix`` and ``prefill.ffn`` around its halves (``forward.*``
    without the cache)."""
    blob: Dict[str, torch.Tensor] = {}
    kind = "prefill" if want_cache else "forward"
    with spans.device_span(f"{kind}.mix"):
        x = _mix_seq(cfg, spec, p, x, positions, kv_chunk, want_cache,
                     extras, part, blob)
    with spans.device_span(f"{kind}.ffn"):
        x, aux = _ffn_seq(cfg, spec, p, x, want_cache, part, blob)
    return x, aux, blob


def _mix_seq(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor,
             positions: torch.Tensor, kv_chunk: int, want_cache: bool,
             extras: Optional[Dict[str, torch.Tensor]], part: Partition,
             blob: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The mixing half of :func:`apply_layer_seq`, through the residual add
    and the cross-attention: the new x; ``blob`` gains its cache entries."""
    B, S, D = x.shape
    h = _norm(cfg, p["ln1"], x)

    if spec.mix in (ATTN_FULL, ATTN_LOCAL, ATTN_NONCAUSAL):
        out, (k, v) = _self_attn_seq(cfg, spec, p["attn"], h, positions,
                                     kv_chunk, part)
        if want_cache:
            blob["k"], blob["v"] = k, v
    elif spec.mix == ATTN_MLA:
        _one_rank(part, "latent attention")
        out, latent = _mla_seq(cfg, p["mla"], h, positions)
        if want_cache:
            blob["latent"] = latent
    elif spec.mix == MIX_KDA:
        _one_rank(part, "Kimi Delta Attention")
        out, state, tail = _kda_seq(cfg, p["kda"], h)
        if want_cache:
            blob["s"], blob["conv"] = state, tail
    elif spec.mix == MIX_RGLRU:
        rp = p["rglru"]
        # R over "model": the gates' products need v whole, the scan runs
        # on this rank's R columns, w_out is row-parallel
        r_sh = rp["w_in"].shape[-1] != cfg.rnn_width
        hc = _col_in(part, h, r_sh)
        gate = F.gelu(hc @ rp["w_gate"], approximate="tanh")
        vin = hc @ rp["w_in"]
        vin, conv_state = causal_conv1d(vin, rp["conv_w"])
        v_all = part.gather(vin, partial=True) if r_sh else None
        log_a, b = _rglru_gates(vin, rp, v_all)
        hseq = rglru_scan(log_a, b)                      # (B,S,R) f32
        out = _row_out(part, (gate * hseq.to(gate.dtype)) @ rp["w_out"],
                       r_sh)
        if want_cache:
            blob["h"] = hseq[:, -1, :]
            blob["conv"] = conv_state
    elif spec.mix == MIX_RWKV6:
        rp = p["rwkv"]
        xprev = rk.token_shift(h)
        r, k, v, g, lw = _rwkv_timemix_prep(cfg, rp, h, xprev, part)
        y, st = wkv_ops.wkv_chunked(r, k, v, lw, rp["u"])
        out = _rwkv_out(cfg, rp, y, g, B, S, part)
        if want_cache:
            blob["s"] = st
            blob["shift_t"] = h[:, -1, :]
    else:
        raise ValueError(spec.mix)

    if cfg.post_norms:
        out = _norm(cfg, p["ln1p"], out)
    x = x + out

    if spec.cross_attn:
        if extras is None or "src" not in extras:
            raise ValueError("a cross-attention layer needs extras['src']")
        xp = p["xattn"]
        hx = _norm(cfg, p["lnx"], x)
        q, xk, xv, local = _attn_inputs(cfg, xp, hx, extras["src"], part)
        kq, vq = _kv_for_heads(cfg, part, xk, xv, local)
        x = x + _gated(xp, _attn_out(part, _cross_core(q, kq, vq, kv_chunk),
                                     xp["wo"], local))
        if want_cache:
            blob["xk"], blob["xv"] = xk, xv
    return x


def _ffn_seq(cfg: ModelConfig, spec: LayerSpec, p, x: torch.Tensor,
             want_cache: bool, part: Partition,
             blob: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The feed-forward half of :func:`apply_layer_seq`: (x, aux_loss)."""
    h2 = _norm(cfg, p["ln2"], x)
    if spec.mix == MIX_RWKV6 and want_cache:
        blob["shift_c"] = h2[:, -1, :]
    out2, aux = _ffn_apply(cfg, spec, p["ffn"], h2, part)
    if cfg.post_norms:
        out2 = _norm(cfg, p["ln2p"], out2)
    x = x + out2
    return x, aux


# ---------------------------------------------------------------------------
# Decode step (x: (B, 1, D))
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     cache_len: int, device: torch.device,
                     part: Partition = NO_PARTITION
                     ) -> Dict[str, torch.Tensor]:
    """Cache blob for one layer. cache_len caps local windows. With
    ``cfg.kv_cache_dtype == "int8"`` a full-attention layer keeps int8
    ``k``/``v`` and f32 ``kscale``/``vscale`` (B, L, K, 1); a local layer
    then raises ``ValueError``, as the reference asserts. A latent
    attention layer keeps one bf16 ``latent`` (B, L, kv_lora_rank +
    qk_rope_head_dim). A Kimi Delta Attention layer keeps its f32 state
    ``s`` (B, H, K, K) and its convolution's last inputs ``conv`` (B,
    width - 1, 3 x H x K), q's, k's and v's side by side.

    ``part``: this rank's shard, as ``ShardingRules.cache_pspecs`` splits
    the whole: ``batch`` (the global batch) over the data ranks where the
    rows split (``part.rows``), over "model" the K/V heads where they
    divide it and else each head's head_dim, R, the RWKV6 heads and
    d_model (each where it divides)."""

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    batch = part.local_rows(batch)
    share = part.tp_share
    kv_split = cfg.n_kv % part.tp == 0
    K = share(cfg.n_kv)
    hd = cfg.head_dim
    kd = hd if kv_split else share(hd)
    quant = cfg.kv_cache_dtype == "int8"
    kv_dt = torch.int8 if quant else torch.bfloat16
    blob: Dict[str, torch.Tensor] = {}
    if spec.mix in (ATTN_FULL, ATTN_NONCAUSAL):
        blob["k"] = mk((batch, cache_len, K, kd), kv_dt)
        blob["v"] = mk((batch, cache_len, K, kd), kv_dt)
        if quant:
            blob["kscale"] = mk((batch, cache_len, K, 1), torch.float32)
            blob["vscale"] = mk((batch, cache_len, K, 1), torch.float32)
    elif spec.mix == ATTN_LOCAL:
        if quant:
            raise ValueError("int8 KV supports full caches only (no rings "
                             "yet)")
        L = min(cache_len, cfg.window)
        blob["k"] = mk((batch, L, K, kd), torch.bfloat16)
        blob["v"] = mk((batch, L, K, kd), torch.bfloat16)
    elif spec.mix == ATTN_MLA:
        blob["latent"] = mk((batch, cache_len, cfg.mla.latent),
                            torch.bfloat16)
    elif spec.mix == MIX_KDA:
        kc = cfg.kda
        blob["s"] = mk((batch, kc.num_heads, kc.head_dim, kc.head_dim),
                       torch.float32)
        blob["conv"] = mk((batch, cfg.conv_width - 1, 3 * kc.width),
                          torch.bfloat16)
    elif spec.mix == MIX_RGLRU:
        R = share(cfg.rnn_width)
        blob["h"] = mk((batch, R), torch.float32)
        blob["conv"] = mk((batch, cfg.conv_width - 1, R), torch.bfloat16)
    elif spec.mix == MIX_RWKV6:
        blob["s"] = mk((batch, share(cfg.n_heads), hd, hd), torch.float32)
        blob["shift_t"] = mk((batch, share(cfg.d_model)), torch.bfloat16)
        blob["shift_c"] = mk((batch, share(cfg.d_model)), torch.bfloat16)
    if spec.cross_attn:
        src_len = cfg.n_img_tokens or (cfg.encoder.n_frames if cfg.encoder
                                       else 0)
        blob["xk"] = mk((batch, src_len, K, kd), torch.bfloat16)
        blob["xv"] = mk((batch, src_len, K, kd), torch.bfloat16)
    return blob


def _quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization. t: (B, S, K, hd).
    Returns (int8 values, f32 scales (B, S, K, 1)); rounds half to even."""
    tf = t.float()
    scale = torch.amax(tf.abs(), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The reference's order: both cast to bf16, then one bf16 product."""
    return q.to(torch.bfloat16) * scale.to(torch.bfloat16)


def _cache_kv(part: Partition, t: torch.Tensor, like: torch.Tensor,
              quant: bool = False):
    """K or V ``t`` (B, T, K or K/tp heads, hd) as the cache shard ``like``
    holds it (the rank's heads, or every head's head_dim chunk); with
    ``quant`` (int8 values, f32 scales), quantized over whole heads before
    the head_dim is split."""
    t = _share(part, t, like, 2)
    if not quant:
        return _share(part, t, like)
    q, sc = _quantize_kv(t)
    return _share(part, q, like), sc


def apply_layer_step_(cfg: ModelConfig, spec: LayerSpec, p,
                      cache: Dict[str, torch.Tensor], x: torch.Tensor,
                      pos_t: torch.Tensor, part: Partition = NO_PARTITION
                      ) -> torch.Tensor:
    """One decode token, writing ``cache`` in place (the reference's donated
    cache). x: (B,1,D); pos_t: the current position, a 0-d int64 tensor on
    x's device (the reference's traced scalar). Returns the new x.

    No Python value is derived from ``pos_t``: the ring slot and the valid
    cache positions are computed on the device, so a CUDA graph can capture
    the step once and replay it at every position.

    Over a mesh (``part``): ``p`` holds this rank's shards, ``x`` its rows
    whole over "model", ``cache`` its shard (:func:`init_layer_cache`);
    the products are column- and row-parallel as in
    :func:`apply_layer_seq`. Attention works on the rank's K/V heads with
    its query heads, or, where the shard holds every head's head_dim
    chunk, on every query head over that chunk (:func:`_attend`).

    Device spans (``runtime.spans``) ``decode.mix`` and ``decode.ffn``
    around its halves."""
    with spans.device_span("decode.mix"):
        x = _mix_step_(cfg, spec, p, cache, x, pos_t, part)
    with spans.device_span("decode.ffn"):
        return _ffn_step_(cfg, spec, p, cache, x, part)


def _mix_step_(cfg: ModelConfig, spec: LayerSpec, p,
               cache: Dict[str, torch.Tensor], x: torch.Tensor,
               pos_t: torch.Tensor, part: Partition) -> torch.Tensor:
    """The mixing half of :func:`apply_layer_step_`, through the residual
    add and the cross-attention: the new x. Device spans ``.kv_write`` and
    ``.attend`` (attention; latent attention ``.q`` and ``.out`` too),
    ``.rwkv6_step`` and ``.state_copy`` (RWKV-6) or ``.kda_in``,
    ``.kda_state`` and ``.kda_out`` (Kimi Delta Attention) inside the
    caller's."""
    B = x.shape[0]
    h = _norm(cfg, p["ln1"], x)

    if spec.mix in (ATTN_FULL, ATTN_LOCAL, ATTN_NONCAUSAL):
        ap = p["attn"]
        H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
        ck, cv = cache["k"], cache["v"]
        local = ck.shape[2] != K            # the rank's K/V and query heads
        bias = "bq" in ap
        q = _proj(h, ap["wq"], ap["bq"] if bias else None)
        k = _proj(h, ap["wk"], ap["bk"] if bias else None)
        v = _proj(h, ap["wv"], ap["bv"] if bias else None)
        if not local:
            q = _whole(part, q, H * hd)
            k, v = _whole(part, k, K * hd), _whole(part, v, K * hd)
        q, k, v = (t.reshape(B, 1, -1, hd) for t in (q, k, v))
        posv = pos_t.reshape(1)
        q = rope(q, posv, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, posv, cfg.rope_theta, cfg.rope_fraction)
        L = ck.shape[1]
        slot = (torch.remainder(posv, L) if spec.mix == ATTN_LOCAL
                else torch.clamp(posv, max=L - 1))
        with spans.device_span(".kv_write"):
            if "kscale" in cache:             # int8 quantized cache
                for key, t in (("k", k), ("v", v)):
                    tq, sc = _cache_kv(part, t, cache[key], quant=True)
                    cache[key].index_copy_(1, slot, tq)
                    cache[key + "scale"].index_copy_(1, slot, sc)
                ck = _dequantize_kv(cache["k"], cache["kscale"])
                cv = _dequantize_kv(cache["v"], cache["vscale"])
            else:
                ck.index_copy_(1, slot, _cache_kv(part, k, ck).to(ck.dtype))
                cv.index_copy_(1, slot, _cache_kv(part, v, cv).to(cv.dtype))
        idx = torch.arange(L, device=x.device)
        if spec.mix == ATTN_LOCAL:
            kv_pos = posv - torch.remainder(posv - idx, L)
            kv_pos = torch.where(kv_pos >= 0, kv_pos, -1)
        else:
            kv_pos = torch.where(idx <= pos_t, idx, -1)
        window = cfg.window if spec.mix == ATTN_LOCAL else 0
        with spans.device_span(".attend"):
            out = _attend(part, q, ck, cv, q_pos=posv, kv_pos=kv_pos,
                          causal=True, window=window,
                          logit_softcap=cfg.attn_softcap,
                          kv_chunk=1024 if L % 1024 == 0 else L)
        out = _attn_out(part, out, ap["wo"], local)
    elif spec.mix == ATTN_MLA:
        _one_rank(part, "latent attention")
        out = _mla_step_(cfg, p["mla"], cache, h, pos_t)
    elif spec.mix == MIX_KDA:
        _one_rank(part, "Kimi Delta Attention")
        out = _kda_step_(cfg, p["kda"], cache, h)
    elif spec.mix == MIX_RGLRU:
        rp = p["rglru"]
        r_sh = rp["w_in"].shape[-1] != cfg.rnn_width
        gate = F.gelu(h @ rp["w_gate"], approximate="tanh")
        vin = h @ rp["w_in"]
        vin2, conv_state = causal_conv1d(vin, rp["conv_w"],
                                         state=cache["conv"])
        v_all = part.gather(vin2[:, 0, :]) if r_sh else None
        log_a, b = _rglru_gates(vin2[:, 0, :], rp, v_all)
        h_new = rglru_step(log_a, b, cache["h"])         # (B, R or R/tp)
        cache["h"].copy_(h_new)
        cache["conv"].copy_(conv_state)
        out = _row_out(part, (gate[:, 0] * h_new.to(gate.dtype))
                       @ rp["w_out"], r_sh)
        out = out[:, None, :]
    elif spec.mix == MIX_RWKV6:
        rp = p["rwkv"]
        xprev = _whole(part, cache["shift_t"], cfg.d_model)[:, None, :].to(
            h.dtype)
        r, k, v, g, lw = _rwkv_timemix_prep(cfg, rp, h, xprev, part)
        # the op returns a new state: copied in, never aliased (the kernel's
        # state and state_out are __restrict__)
        with spans.device_span(".rwkv6_step"):
            y, s_new = rk.wkv_step(r[:, 0], k[:, 0], v[:, 0],
                                   torch.exp(lw[:, 0]), rp["u"], cache["s"])
        with spans.device_span(".state_copy"):
            cache["s"].copy_(s_new)
        cache["shift_t"].copy_(_share(part, h[:, 0, :], cache["shift_t"]))
        out = _rwkv_out(cfg, rp, y[:, None], g, B, 1, part)
    else:
        raise ValueError(spec.mix)

    if cfg.post_norms:
        out = _norm(cfg, p["ln1p"], out)
    x = x + out

    if spec.cross_attn:
        hx = _norm(cfg, p["lnx"], x)
        x = x + _cross_attn(cfg, p["xattn"], hx, cache["xk"], cache["xv"],
                            kv_chunk=1 << 16, part=part)
    return x


def _ffn_step_(cfg: ModelConfig, spec: LayerSpec, p,
               cache: Dict[str, torch.Tensor], x: torch.Tensor,
               part: Partition) -> torch.Tensor:
    """The feed-forward half of :func:`apply_layer_step_` (RWKV-6's channel
    mix writes its token shift into ``cache``): the new x."""
    h2 = _norm(cfg, p["ln2"], x)
    if spec.mix == MIX_RWKV6:
        xprev_c = _whole(part, cache["shift_c"], cfg.d_model)[:, None, :].to(
            h2.dtype)
        out2 = _rwkv_channel_mix(cfg, p["ffn"], h2, xprev_c, part)
        cache["shift_c"].copy_(_share(part, h2[:, 0, :], cache["shift_c"]))
    else:
        out2, _ = _ffn_apply(cfg, spec, p["ffn"], h2, part)
    if cfg.post_norms:
        out2 = _norm(cfg, p["ln2p"], out2)
    return x + out2


def _pos_tensor(pos, device: torch.device) -> torch.Tensor:
    """``pos`` (an int or a tensor) as a 0-d int64 tensor on ``device``; an
    int is written by a fill on the device, with no copy from the host."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(pos), dtype=torch.int64, device=device)


def apply_layer_step(cfg: ModelConfig, spec: LayerSpec, p,
                     cache: Dict[str, torch.Tensor], x: torch.Tensor,
                     pos) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode token. x: (B,1,D); pos: the current position (an int or
    a 0-d tensor). Returns the new x and a new cache dict; ``cache`` is
    left as it was (:func:`apply_layer_step_` on a copy)."""
    new_cache = {key: t.clone() for key, t in cache.items()}
    x = apply_layer_step_(cfg, spec, p, new_cache, x,
                          _pos_tensor(pos, x.device))
    return x, new_cache


# ===========================================================================
# Whisper-style encoder
# ===========================================================================

def encode(cfg: ModelConfig, enc, frames: torch.Tensor,
           kv_chunk: int = 1024, remat: bool = False,
           part: Partition = NO_PARTITION,
           layer: Optional[Callable[[int], Mapping]] = None
           ) -> torch.Tensor:
    """frames: (B, n_frames, D) stubbed conv-frontend output. With
    ``remat`` each layer is one non-reentrant ``torch.utils.checkpoint``
    region (the reference's ``jax.checkpoint`` a layer). ``enc``: the
    encoder's ``pos`` and ``final`` (an :class:`_Encoder`, or a namespace
    of this rank's tensors); ``layer(i)``: layer i's parameters, fetched
    inside its region (default ``enc.layers[i]``)."""
    pos = enc.pos
    if pos.shape[-1] != cfg.d_model:
        pos = part.gather(pos)
    x = frames + pos[None]
    positions = torch.arange(frames.shape[1], device=frames.device)

    def body(x, i):
        lp = enc.layers[i] if layer is None else layer(i)
        return apply_layer_seq(cfg, _ENCODER_SPEC, lp, x, positions,
                               kv_chunk, part=part)[0]

    for i in range(cfg.encoder.n_layers):
        if remat:
            x = checkpoint(body, x, i, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x, i)
    return _norm(cfg, enc.final, x)


# ===========================================================================
# Model facade
# ===========================================================================

class Model(nn.Module):
    """The backbone for ``cfg``. It holds no parameters until :meth:`init`
    draws them (the reference's ``Model`` holds only the config and
    ``init`` returns the parameters); ``load_state_dict`` then takes the
    reference's through ``repro_torch.convert.model_state_dict``."""

    def __init__(self, cfg: ModelConfig, kv_chunk: int = 1024) -> None:
        super().__init__()
        self.cfg = cfg
        self.kv_chunk = kv_chunk
        self.device: Optional[torch.device] = None
        self._released = False

    # -- params ---------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> "Model":
        """Draw every parameter on ``device`` (the card unless the caller
        passes ``"cpu"``) from ``generator`` (a ``torch.Generator`` on that
        device), with the reference's shapes, dtypes and scale rules.
        Returns self."""
        cfg = self.cfg
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"parameters go to {dev}")
        ini = _Init(generator, dev)
        self.device = dev
        self._released = False
        self.embed = ini.normal((cfg.vocab, cfg.d_model), 0.02)
        self.final = _norm_params(cfg, ini)
        if not cfg.tie_embeddings:
            self.lm_head = ini.dense((cfg.d_model, cfg.vocab), scale=0.02)
        self.layers = nn.ModuleList(_layer_params(cfg, spec, ini)
                                    for spec in cfg.layers)
        if cfg.encoder is not None:
            self.encoder = _Encoder(cfg, ini)
        if _learned_positions(cfg):
            self.pos_embed = ini.normal(
                (min(cfg.max_position, 1 << 16), cfg.d_model), 0.01)
        return self

    def _params(self, own: bool = True) -> None:
        """Raises unless the parameters were drawn and, where ``own``,
        are still held (not released)."""
        if self.device is None:
            raise RuntimeError("call init() first: the model holds no "
                               "parameters yet")
        if own and self._released:
            raise RuntimeError("the model's parameters were released "
                               "(release_params): pass params= (a rank's "
                               "shards) or bind_params() first")

    @torch.no_grad()
    def release_params(self) -> None:
        """Drop the module's own tensors, keeping each parameter's name,
        shape and dtype on the ``meta`` device (no memory). A step over a
        mesh reads only the state's shards (``params=`` of
        :meth:`forward`), so a rank need not hold the whole model beside
        them: the launcher and the dry run release it once the state is
        laid out. :meth:`bind_params` takes values in again; until then
        :meth:`forward` without ``params`` and decoding raise."""
        self._params(own=False)
        for name, p in list(self.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(mod), leaf, nn.Parameter(
                torch.empty_like(p, device="meta"),
                requires_grad=p.requires_grad))
        self._released = True

    # -- forward ----------------------------------------------------------------
    def _param(self, name: str, params: Optional[Mapping[str, torch.Tensor]],
               part: Partition) -> torch.Tensor:
        """Parameter ``name``: the module's own, or this rank's from
        ``params`` (gathered over the data axes where it is sharded there
        at rest, ``Partition.param``)."""
        if params is None:
            return self.get_parameter(name)
        return part.param(name, params[name])

    def _tree(self, prefix: str, params: Optional[Mapping[str, torch.Tensor]],
              part: Partition):
        """The parameters under ``prefix`` as the layers read them: the
        submodule itself, or a nested dict of :meth:`_param`'s tensors."""
        mod = self.get_submodule(prefix)
        if params is None:
            return mod
        out: Dict[str, object] = {}
        for rel, _ in mod.named_parameters():
            *path, leaf = rel.split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = self._param(f"{prefix}.{rel}", params, part)
        return out

    def _embed(self, tokens: torch.Tensor, E: Optional[torch.Tensor] = None,
               part: Partition = NO_PARTITION) -> torch.Tensor:
        """The lookup; over "model" a vocab-sharded (tied) table looks up
        the rank's rows and sums over the ranks, a d_model-sharded one
        gathers its columns."""
        cfg = self.cfg
        E = self.embed if E is None else E
        if E.shape[0] != cfg.vocab:
            n = E.shape[0]
            t = tokens.long() - part.tp_rank * n
            mine = (t >= 0) & (t < n)
            x = E[torch.where(mine, t, 0)]
            x = part.reduce(torch.where(mine[..., None], x, torch.zeros(
                (), dtype=x.dtype, device=x.device)))
        else:
            x = E[tokens.long()]
            if E.shape[1] != cfg.d_model:
                x = part.gather(x)
        if cfg.embed_scale:
            x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
        return x

    def _extras(self, extras: Optional[Mapping[str, torch.Tensor]],
                remat: bool = False,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                part: Partition = NO_PARTITION
                ) -> Optional[Dict[str, torch.Tensor]]:
        """The cross-attention source: the encoder's output over
        ``extras["frames"]``, or ``extras["img"]`` as it is (gathered over
        "model" where the batch's layout shards its d_model)."""
        cfg = self.cfg
        key = "frames" if cfg.encoder is not None else "img"
        if cfg.encoder is None and not cfg.n_img_tokens:
            return None
        if extras is None or key not in extras:
            raise ValueError(f"{cfg.name} needs extras[{key!r}]")
        src = extras[key]
        if src.shape[-1] != cfg.d_model:
            src = part.gather(src)
        if cfg.encoder is None:
            return {"src": src}
        if params is None:
            enc, layer = self.encoder, None
        else:
            enc = SimpleNamespace(
                pos=self._param("encoder.pos", params, part),
                final=self._tree("encoder.final", params, part))

            def layer(i):
                return self._tree(f"encoder.layers.{i}", params, part)
        return {"src": encode(cfg, enc, src, self.kv_chunk, remat, part,
                              layer)}

    def _logits(self, x: torch.Tensor,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                part: Partition = NO_PARTITION) -> torch.Tensor:
        """f32 logits; over "model" this rank's vocabulary columns where
        the head is vocab-sharded."""
        cfg = self.cfg
        x = _norm(cfg, self._tree("final", params, part), x)
        head = self._param("embed", params, part).T if cfg.tie_embeddings \
            else self._param("lm_head", params, part)
        x = _col_in(part, x, head.shape[-1] != cfg.vocab)
        logits = (x @ head).float()
        return softcap(logits, cfg.final_softcap)

    def train_params(self) -> Dict[str, nn.Parameter]:
        """Every parameter by name (the ``state_dict`` names), each made to
        require gradients: the train state's ``params``."""
        self._params()
        params = dict(self.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        return params

    @torch.no_grad()
    def bind_params(self, params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, nn.Parameter]:
        """The model's own parameters holding ``params``' values: a tensor
        that is not the model's own (a restored checkpoint's, a converted
        state's) is copied in. A state over a mesh (``DTensor``\\s) is not
        bound: its step runs on each rank's shards (``params=`` of
        :meth:`forward`). A released model (:meth:`release_params`) holds
        its parameters again. Returns :meth:`train_params`."""
        self._params(own=False)
        names = {k for k, _ in self.named_parameters()}
        if set(params) != names:
            raise ValueError(f"parameter names differ: "
                             f"{sorted(set(params) ^ names)[:6]}")
        for name, src in params.items():
            if isinstance(src, DTensor):
                raise TypeError(f"{name}: a DTensor (a state over a mesh) "
                                "is not bound into the model; "
                                "train.make_train_step partitions its step")
        if self._released:
            self.to_empty(device=self.device)
            self._released = False
        own = self.train_params()
        for name, p in own.items():
            if params[name] is not p:
                p.copy_(params[name])
        return own

    def decay_names(self) -> Set[str]:
        """The parameters the reference's AdamW decays: those whose leaf
        there has ``ndim >= 2``. A parameter of a superblock layer or of an
        encoder layer is a slice of a stacked leaf, one axis more than its
        own; so its 1-D weights decay and its 0-d cross-attention gate
        does not. Elsewhere a parameter decays iff it is 2-D or more."""
        self._params(own=False)
        lead = len(self.cfg.lead)
        scanned = lead + self.cfg.n_super * len(self.cfg.pattern)
        out = set()
        for name, p in self.named_parameters():
            parts = name.split(".")
            stacked = (parts[0] == "layers"
                       and lead <= int(parts[1]) < scanned) \
                or parts[:2] == ["encoder", "layers"]
            if p.dim() + stacked >= 2:
                out.add(name)
        return out

    def _blocks(self) -> List[Tuple[int, ...]]:
        """The reference's remat regions as layer indices: one leading
        layer each, one superblock of ``cfg.pattern`` layers each, then one
        tail layer each."""
        cfg = self.cfg
        period, lead = len(cfg.pattern), len(cfg.lead)
        end = lead + cfg.n_super * period
        return ([(n,) for n in range(lead)]
                + [tuple(range(lead + i * period, lead + (i + 1) * period))
                   for i in range(cfg.n_super)]
                + [(n,) for n in range(end, cfg.n_layers)])

    def _run_block(self, x: torch.Tensor, positions: torch.Tensor,
                   layers: Tuple[int, ...], want_cache: bool = False,
                   src: Optional[Dict[str, torch.Tensor]] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None,
                   part: Partition = NO_PARTITION
                   ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
        """One remat region. Its layers' parameters are fetched here, so
        a parameter sharded over the data axes at rest is gathered at the
        region's start, again in its recompute, and freed with it."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        blobs: Cache = []
        for n in layers:
            x, a, blob = apply_layer_seq(
                self.cfg, self.cfg.layers[n],
                self._tree(f"layers.{n}", params, part), x, positions,
                self.kv_chunk, want_cache, src, part)
            aux = aux + a
            blobs.append(blob)
        return x, aux, blobs

    def forward(self, tokens: torch.Tensor,
                extras: Optional[Mapping[str, torch.Tensor]] = None,
                want_cache: bool = False,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                part: Partition = NO_PARTITION, last: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
        """Full-sequence forward. Returns (logits, aux_loss, caches), the
        caches one dict a layer. ``extras``: the encoder's frames or the
        image tokens (module docstring); the reference's ``positions``
        argument is not taken (its default, ``arange(S)``, is). ``last``:
        the logits of the last position alone, (B, 1, V).

        It records autograd when the caller's grad mode is on and the
        parameters require gradients (:meth:`train_params`); each remat
        region (:meth:`_blocks`) then runs under a non-reentrant
        ``torch.utils.checkpoint`` and is recomputed in the backward, and
        so does each encoder layer.

        ``params``/``part``: the partitioned step over a mesh
        (``train/train_step.py``): ``params`` maps each name to this
        rank's at-rest shard (a plain tensor), ``part``
        (``runtime.partition.Partition``) says how they and this rank's
        rows of ``tokens`` sit on the mesh; the logits are then this
        rank's vocabulary columns where the head is vocab-sharded."""
        self._params(own=params is None)
        B, S = tokens.shape
        x = self._embed(tokens, self._param("embed", params, part), part)
        if _learned_positions(self.cfg):
            pos = self._param("pos_embed", params, part)[:S]
            if pos.shape[-1] != self.cfg.d_model:
                pos = part.gather(pos)
            x = x + pos[None]
        positions = torch.arange(S, device=x.device)
        lead = self.embed if params is None else params["embed"]
        remat = torch.is_grad_enabled() and lead.requires_grad \
            and not want_cache
        src = self._extras(extras, remat, params, part)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches: Cache = []
        for layers in self._blocks():
            if remat:
                # the layers draw no random numbers: no RNG state to keep
                x, aux, blobs = checkpoint(
                    self._run_block, x, positions, layers, False, src,
                    params, part, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, aux, blobs = self._run_block(x, positions, layers,
                                                want_cache, src, params,
                                                part)
            aux_total = aux_total + aux
            caches += blobs
        if last:
            x = x[:, -1:]
        return self._logits(x, params, part), aux_total, caches

    def loss(self, batch: Mapping[str, torch.Tensor],
             params: Optional[Mapping[str, torch.Tensor]] = None,
             part: Partition = NO_PARTITION
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens (B, S), labels (B, S) with -100 (any negative) =
        ignore, and ``extras`` where the model reads them, on the model's
        device. The reference's mask-sum CE: the label's logit is taken by
        a gather, which picks the same f32 value as its masked sum over the
        vocabulary (every other term is an exact 0) without a (B, S, V)
        mask. Returns (ce + 0.01 aux, {"ce", "aux", "tokens"}).

        Partitioned (``params``/``part``, :meth:`forward`): the CE is the
        mean over the global batch (this rank's NLL sum and valid count
        summed over the data ranks, so every rank's loss is the global
        one and the sum of their gradients the global gradient), the
        logsumexp of vocab-sharded logits an all-reduced max and sum, the
        label's logit taken on the rank that holds it."""
        logits, aux, _ = self.forward(batch["tokens"], batch.get("extras"),
                                      params=params, part=part)
        labels = batch["labels"].long()
        valid = labels >= 0
        safe = torch.clamp(labels, min=0)
        if logits.shape[-1] != self.cfg.vocab:          # vocab-parallel
            n = logits.shape[-1]
            m = part.tp_max(torch.amax(logits.detach(), dim=-1))
            lse = m + torch.log(part.reduce(
                torch.exp(logits - m[..., None]).sum(dim=-1)))
            t = safe - part.tp_rank * n
            mine = (t >= 0) & (t < n)
            mine_logit = torch.gather(logits, -1, torch.where(
                mine, t, 0)[..., None])[..., 0]
            label_logit = part.reduce(torch.where(mine, mine_logit, 0.0))
        else:
            lse = torch.logsumexp(logits, dim=-1)
            label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = lse - label_logit
        denom = torch.clamp(part.dp_sum(valid.sum()), min=1)
        ce = part.dp_sum(torch.where(valid, nll, 0.0).sum()) / denom
        total = ce + _MOE_AUX_COEF * aux
        return total, {"ce": ce, "aux": aux,
                       "tokens": denom.to(torch.float32)}

    # -- decode ----------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int,
                   part: Partition = NO_PARTITION) -> Cache:
        """A zero cache for ``batch`` sequences (the global batch); over a
        mesh this rank's shard of it (:func:`init_layer_cache`)."""
        self._params(own=False)
        return [init_layer_cache(self.cfg, spec, batch, cache_len,
                                 self.device, part)
                for spec in self.cfg.layers]

    @torch.no_grad()
    def decode_step_(self, cache: Cache, tokens: torch.Tensor,
                     pos_t: torch.Tensor,
                     params: Optional[Mapping[str, torch.Tensor]] = None,
                     part: Partition = NO_PARTITION) -> torch.Tensor:
        """One token for every sequence, writing ``cache`` in place.
        tokens: (B, 1) on the model's device; pos_t: the position of that
        token, a 0-d int64 tensor there. Returns the logits (B, 1, V).
        Nothing here reads a value back to the host, so a CUDA graph can
        capture it (``serve.make_serve_step``). Device spans
        ``decode.embed`` and ``decode.head`` (the final norm and the
        logits) around the layers' (:func:`apply_layer_step_`).

        ``params``/``part`` (as :meth:`forward`'s): ``tokens`` are this
        rank's rows, ``cache`` its shard (:meth:`init_cache`), and the
        logits this rank's vocabulary columns where the head is
        vocab-sharded."""
        self._params(own=params is None)
        cfg = self.cfg
        rows = next(iter(cache[0].values())).shape[0]
        if tokens.shape[0] != rows:
            raise ValueError(f"{tokens.shape[0]} rows of tokens for a cache "
                             f"of {rows} (over a mesh: this rank's rows)")
        with spans.device_span("decode.embed"):
            x = self._embed_at(tokens, pos_t, params, part)
        for n, (spec, cb) in enumerate(zip(cfg.layers, cache)):
            x = apply_layer_step_(cfg, spec,
                                  self._tree(f"layers.{n}", params, part),
                                  cb, x, pos_t, part)
        with spans.device_span("decode.head"):
            return self._logits(x, params, part)

    def _embed_at(self, tokens: torch.Tensor, pos_t: torch.Tensor,
                  params: Optional[Mapping[str, torch.Tensor]],
                  part: Partition) -> torch.Tensor:
        """The decode step's embedding of ``tokens`` at ``pos_t``, learned
        positions added (:meth:`decode_step_`)."""
        cfg = self.cfg
        x = self._embed(tokens, self._param("embed", params, part), part)
        if _learned_positions(cfg):
            pe = self._param("pos_embed", params, part)
            at = torch.clamp(pos_t, max=pe.shape[0] - 1).reshape(1)
            x = x + _whole(part, pe.index_select(0, at), cfg.d_model)[None]
        return x

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos,
                    params: Optional[Mapping[str, torch.Tensor]] = None,
                    part: Partition = NO_PARTITION
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token for every sequence. tokens: (B, 1); pos: the position
        of that token (an int or a 0-d tensor). Returns (logits (B, 1, V),
        new cache); ``cache`` is left as it was: :meth:`decode_step_` on
        one copy of it (``params``/``part`` as there)."""
        self._params(own=params is None)
        new_cache = [{key: t.clone() for key, t in cb.items()}
                     for cb in cache]
        logits = self.decode_step_(new_cache, tokens,
                                   _pos_tensor(pos, self.device), params,
                                   part)
        return logits, new_cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int,
                extras: Optional[Mapping[str, torch.Tensor]] = None,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                part: Partition = NO_PARTITION, last: bool = False
                ) -> Tuple[torch.Tensor, Cache]:
        """Process a prompt, building a decode cache. Returns (logits, cache);
        with ``last`` the last position's logits alone (what a server
        serves: at Kimi-K2's vocabulary a 32 x 4,096 prompt's every logit
        would be 80 GiB in f32).

        Attention K/V computed for the prompt are written into the cache
        (ring-placed for local windows; quantized for an int8 cache), and a
        cross-attention layer's source K/V too.

        ``params``/``part`` (:meth:`forward`'s): ``tokens`` and ``extras``
        are this rank's rows, the logits as :meth:`forward` gives them,
        the cache this rank's shard (:meth:`init_cache`): the rank's heads
        or head_dim chunk of the K/V that ``forward`` computed, its
        columns of the recurrent states. Host spans ``prefill.forward``
        and ``prefill.cache_fill`` (``runtime.spans``).
        """
        with spans.host_span("prefill.forward"):
            logits, _, blobs = self.forward(tokens, extras, want_cache=True,
                                            params=params, part=part,
                                            last=last)
        with spans.host_span("prefill.cache_fill"):
            return logits, self._fill_cache(blobs, tokens.shape, cache_len,
                                            part)

    def _fill_cache(self, blobs: List[Dict[str, torch.Tensor]],
                    shape: Tuple[int, int], cache_len: int,
                    part: Partition) -> Cache:
        """A decode cache of ``cache_len`` holding what the prompt's forward
        left in ``blobs`` (:meth:`prefill`; ``shape``: the prompt's)."""
        cfg = self.cfg
        B, S = shape
        cache = self.init_cache(B * part.rows, cache_len, part)
        for spec, blob, slot in zip(cfg.layers, blobs, cache):
            if spec.mix in (ATTN_FULL, ATTN_NONCAUSAL):
                take = min(S, slot["k"].shape[1])
                for key in ("k", "v"):
                    seq = blob[key][:, S - take:]
                    if "kscale" in slot:
                        q, sc = _cache_kv(part, seq, slot[key], quant=True)
                        slot[key][:, :take] = q
                        slot[key + "scale"][:, :take] = sc
                    else:
                        slot[key][:, :take] = _cache_kv(part, seq, slot[key])
            elif spec.mix == ATTN_LOCAL:
                L = slot["k"].shape[1]
                take = min(S, L)
                slots = torch.remainder(
                    torch.arange(S - take, S, device=self.device), L)
                for key in ("k", "v"):
                    slot[key][:, slots] = _cache_kv(
                        part, blob[key][:, S - take:], slot[key]).to(
                        slot[key].dtype)
            if spec.mix == ATTN_MLA:
                take = min(S, slot["latent"].shape[1])
                slot["latent"][:, :take] = blob["latent"][:, S - take:]
            for key in ("h", "conv", "s", "shift_t", "shift_c"):
                if key in blob:     # the token shifts: the rank's columns
                    slot[key].copy_(_share(part, blob[key], slot[key]))
            for key in ("xk", "xv"):
                if key in blob:
                    slot[key].copy_(_cache_kv(part, blob[key], slot[key]))
        return cache
