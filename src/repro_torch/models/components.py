"""Model building blocks in PyTorch (the reference's ``models/components.py``).

Numerics policy, as in the reference: parameters and activations are bf16;
softmax, norms and recurrences accumulate in f32. Attention is a chunked
online softmax (flash-style) in plain PyTorch, as the reference's is plain
JAX; one query position on the card (the decode step) goes to the port's
``decode_attention`` kernel, which reads each cached K/V row once for all
its query heads where the plain path repeats the cache to every head. The
RG-LRU recurrence runs through the port's ``rglru_scan`` op: the
hand-written CUDA kernel on the card, its plain version on the CPU; under
autograd its gradient is the hand-written gradient kernel (its plain
version on the CPU), where the reference differentiates its own scan. The
reference scans with ``jax.lax.associative_scan`` (folding ``h0`` into the
first step) and steps with ``exp(log_a) h + b``; the op walks time in order,
so the two agree to f32 rounding. f32 products here need TF32 off on the
card (PyTorch's default for matrix products).

The MoE dispatch (``moe_forward``) is the reference's capacity dispatch in
plain PyTorch, as the reference's is plain JAX: the expert products are
``torch.einsum``. It reads nothing back to the host (every shape follows
from the input's), so a CUDA graph can capture a decode step through it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.rglru_scan import ops as rglru_ops
from ..runtime import spans
from ..runtime.partition import NO_PARTITION, Partition
from .config import MoeSpec

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return ((1.0 + w.float()) * out).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (w.float() * out + b.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        ang = positions.float()[None, :, None] * freqs[None, None, :]
    else:
        ang = positions.float()[..., None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]    # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention (chunked online softmax; GQA; sliding window; softcap)
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, kv_pos: torch.Tensor,
              causal: bool = True, window: int = 0,
              logit_softcap: Optional[float] = None,
              kv_chunk: int = 1024, head_dim: Optional[int] = None,
              scores: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> torch.Tensor:
    """Memory-bounded attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H = K * G.
    q_pos: (Sq,) absolute positions; kv_pos: (Sk,) absolute positions, -1
    marks invalid cache slots. Never materializes more than (.., Sq, chunk)
    scores. GQA k/v are repeated to H heads up front, query head h reading
    KV head h // G (``jnp.repeat``'s interleaving).

    ``head_dim``/``scores``: q, k, v hold a chunk of each head's
    ``head_dim`` dims (the scale is the whole head's), and ``scores``
    takes each block's partial f32 scores to the whole's (their sum over
    the chunks' ranks) before the softcap and the mask.

    One query position without ``scores``, on CUDA tensors the kernel
    takes (``decode_attention.ops.takes``: f32 or bf16, head_dim a
    multiple of 8 up to 256), runs the ``decode_attention`` kernel: the
    direct path's arithmetic with an online softmax, the cache never
    repeated or widened in memory.
    """
    B, Sq, H, hd = q.shape
    if Sq == 1 and scores is None and decode_ops.takes(q, k, v):
        return decode_ops.decode_attention(
            q, k, v, q_pos, kv_pos, causal=causal, window=window,
            logit_softcap=logit_softcap,
            scale=1.0 / math.sqrt(head_dim or hd))
    _, Sk, K, _ = k.shape
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scale = 1.0 / math.sqrt(head_dim or hd)
    qf = q.float() * scale

    def block(kc, kp):
        """Masked scores for one kv chunk: (B, H, Sq, C)."""
        s = torch.einsum("bqhd,bchd->bhqc", qf, kc.float())
        if scores is not None:
            s = scores(s)
        if logit_softcap is not None:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        m = kp[None, :] >= 0
        if causal:
            m = m & (kp[None, :] <= q_pos[:, None])
        if window:
            m = m & (kp[None, :] > q_pos[:, None] - window)
        return torch.where(m[None, None, :, :], s,
                           torch.full((), _NEG_INF, device=s.device))

    if Sk <= kv_chunk or Sk % kv_chunk != 0:
        # direct path (also the fallback for non-divisible small shapes)
        s = block(k, kv_pos)
        mx = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - mx)
        p = torch.where(s > 0.5 * _NEG_INF, p, torch.zeros((),
                                                            device=p.device))
        denom = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bhqc,bchd->bqhd", p, v.float())
        o = o / denom.clamp(min=1e-20).permute(0, 2, 1, 3)
        return o.to(q.dtype)

    n = Sk // kv_chunk
    m_run = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for c in range(n):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        s = block(k[:, sl], kv_pos[sl])                  # (B,H,Sq,C)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s > 0.5 * _NEG_INF, p, torch.zeros((),
                                                            device=p.device))
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqc,bchd->bhqd", p, v[:, sl].float())
        m_run = m_new
    out = acc / l_run.clamp(min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor,
             reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> torch.Tensor:
    """``reduce``: applied to ``h @ w2`` before the bias (a row-parallel
    ``w2``'s partial products summed over "model")."""
    h = F.gelu(x @ w1 + b1, approximate="tanh")    # jax.nn.gelu's default
    y = h @ w2
    return (y if reduce is None else reduce(y)) + b2


def gelu_ffn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
             ) -> torch.Tensor:
    return F.gelu(x @ w1, approximate="tanh") @ w2


# ---------------------------------------------------------------------------
# Mixture of Experts — capacity-based sort-free dispatch
# ---------------------------------------------------------------------------

def _positions_in_expert(flat_e: torch.Tensor, num_experts: int
                         ) -> torch.Tensor:
    """Rank of each routed token within its expert, via one stable sort
    along the last axis (leading axes are independent dispatch groups).
    int32, the shape of ``flat_e``."""
    tk = flat_e.shape[-1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(num_experts, dtype=sorted_e.dtype,
                           device=flat_e.device)
    seg_start = torch.searchsorted(
        sorted_e, experts.expand(*sorted_e.shape[:-1],
                                 num_experts).contiguous(), side="left")
    pos_sorted = torch.arange(tk, device=flat_e.device) - torch.gather(
        seg_start, -1, sorted_e)
    return torch.zeros_like(flat_e, dtype=torch.int32).scatter_(
        -1, order, pos_sorted.to(torch.int32))


def moe_forward(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
                w3: torch.Tensor, w2: torch.Tensor, moe: MoeSpec,
                shared: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]] = None,
                groups: int = 1, part: Partition = NO_PARTITION,
                d_ff: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity-factor dispatch (tokens over capacity drop).

    x: (B, S, D); router_w: (D, E); experts w1/w3: (E, D, F), w2: (E, F, D).
    Returns (out, aux_loss). ``groups``: dispatch groups, each with its own
    capacity (1 unless it divides the B*S tokens).

    ``part`` (the partitioned step, ``runtime/partition.py``): ``x`` holds
    this rank's rows and the experts its shards. The aux statistics are
    means over the global batch; the groups are the global batch's, so a
    rank whose rows are whole groups dispatches them alone, and otherwise
    (one group, or groups across ranks) the routing is gathered over the
    data ranks, each rank adds its tokens to the whole buffer, and each
    rank computes the expert products of its chunk of every expert's
    slots of the buffer summed over them (or of all of them, summed both
    ways, where the capacity does not divide). Over "model" the experts
    are split (expert-parallel: this rank's experts of the buffer, their
    outputs gathered) or each expert's d_ff is (row-parallel ``w2``,
    summed); ``d_ff``: the unsharded width, to tell the two apart (None:
    whole). The reference's ``buf_pspec`` (its ``with_sharding_constraint``
    on the ``(G, E, cap, D)`` buffer, ``cfg.moe_pspec``) has no
    counterpart: the partitioned dispatch is where the buffer is split.

    The top k come from a stable descending sort of the bf16-rounded router
    logits, so ties go to the lower expert index as ``jax.lax.top_k``
    gives them. A dropped token is written to slot ``cap - 1`` of its
    expert with a zero contribution, as the reference's ``.at[].add``
    does; the scatter adds, so that slot keeps its one kept token exactly.

    With a ``runtime.spans.Timeline`` open: device spans ``.route`` (the
    router, the top k, the capacity positions and the dispatch into the
    slots), ``.experts`` and ``.combine`` inside the caller's, and between
    the first two the device counters ``moe_tokens_kept`` and ``moe_slots``
    (G·E·cap), this rank's share of each.
    """
    phase = spans.phases()
    phase(".route")
    B, S, D = x.shape
    E, k = moe.num_experts, moe.top_k
    T = B * S
    xt = x.reshape(T, D)
    logits = (xt @ router_w).float()                       # (T, E)
    top_logits, top_idx = torch.sort(logits, dim=-1, descending=True,
                                     stable=True)
    top_logits, top_idx = top_logits[:, :k], top_idx[:, :k]  # (T, k)
    if k == 1:
        weights = torch.sigmoid(top_logits)                # llama4-style
    else:
        weights = torch.softmax(top_logits, dim=-1)        # mixtral-style

    # load-balancing aux loss (Switch/Mixtral form); the one-hot is a
    # comparison, not F.one_hot (which reads its input's range back)
    probs = torch.softmax(logits, dim=-1)
    experts = torch.arange(E, device=x.device)
    first = (top_idx[:, :1] == experts).float()
    if part.rows > 1:                   # means over the global batch
        n = T * part.rows
        density = part.dp_sum(probs.sum(dim=0)) / n
        usage = part.dp_sum(first.sum(dim=0)) / n
    else:
        density = probs.mean(dim=0)                        # (E,)
        usage = first.mean(dim=0)
    aux = E * torch.sum(density * usage)

    T_all = T * part.rows
    G = groups if T_all % groups == 0 else 1
    Tg = T_all // G
    cap = int(math.ceil(moe.capacity_factor * Tg * k / E))
    cap = max(8, (cap + 7) // 8 * 8)

    local = G % part.rows == 0          # this rank's rows: whole groups
    if local:
        Gx = Gb = G // part.rows
        flat_e = top_idx.reshape(Gx, Tg * k)
        pos = _positions_in_expert(flat_e, E)
        group = torch.arange(Gx, device=x.device)[:, None]
    else:                               # the routing of every rank's rows
        Gx, Gb = 1, G
        flat_e = part.dp_gather(top_idx).reshape(G, Tg * k)   # no grad
        pos = _positions_in_expert(flat_e, E)
        group = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
        mine = slice(part.dp_rank * T * k, (part.dp_rank + 1) * T * k)
        flat_e, pos, group = (t.reshape(1, -1)[:, mine]
                              for t in (flat_e, pos, group))
    n = flat_e.shape[1]                 # routed tokens a group row
    keep = pos < cap
    pos_c = torch.clamp(pos, max=cap - 1).long()

    # token-major, k-minor: each token's row repeated k times
    xg = xt.reshape(Gx, n // k, 1, D).expand(Gx, n // k, k, D).reshape(
        Gx, n, D)
    contrib = torch.where(keep[..., None], xg, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    slot = ((group * E + flat_e) * cap + pos_c).reshape(-1)
    buf = torch.zeros((Gb * E * cap, D), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, contrib.reshape(-1, D)).reshape(
        Gb, E, cap, D)
    # every rank's tokens summed; the slots' expert products split over
    # the data ranks where the capacity divides
    split_cap = not local and cap % part.rows == 0
    if split_cap:
        buf = part.dp_scatter(buf, 2)
    elif not local:
        buf = part.dp_all(buf)
    phase(None)
    if spans.timeline() is not None:
        spans.device_counter("moe_tokens_kept", keep.sum())
        spans.device_counter("moe_slots",
                             Gb * E * cap // (1 if local else part.rows))

    phase(".experts")
    if w1.shape[0] != E:                # expert-parallel over "model"
        y = part.gather(_experts(part.split(buf, 1), w1, w3, w2), 1)
    else:
        ff_sh = d_ff is not None and w1.shape[-1] != d_ff
        y = _experts(part.copy(buf) if ff_sh else buf, w1, w3, w2)
        y = part.reduce(y) if ff_sh else y             # (G, E, cap, D)
    if split_cap:
        y = part.dp_gather(y, 2)

    phase(".combine")
    gathered = y.reshape(-1, D)[slot].reshape(Gx, n, D)
    wk = (weights.reshape(Gx, n, 1) * keep[..., None]).to(x.dtype)
    out = (gathered * wk).reshape(Gx, n // k, k, D).sum(dim=2)

    out = out.reshape(T, D)
    if shared is not None:
        s1, s3, s2 = shared
        s_sh = d_ff is not None and s1.shape[-1] != d_ff
        ys = swiglu(part.copy(xt) if s_sh else xt, s1, s3, s2)
        out = out + (part.reduce(ys) if s_sh else ys)
    phase(None)
    return out.reshape(B, S, D), aux


def _experts(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    """Each expert's swiglu over its slots: (G, E, cap, D) -> same."""
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, w1)) * \
        torch.einsum("gecd,edf->gecf", buf, w3)
    return torch.einsum("gecf,efd->gecd", h, w2)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def _rglru_gates(v: torch.Tensor, p, v_all: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a (decay, in log space, <= 0) and gated input, both f32.
    ``v_all``: ``v`` whole where ``v`` holds this rank's R columns (the
    gates' products ``w_a``/``w_x`` give this rank's columns of a whole
    input)."""
    vf = v.float()
    va = vf if v_all is None else v_all.float()
    r = torch.sigmoid(va @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(va @ p["w_x"].float() + p["b_x"])
    log_a = -_RGLRU_C * r * F.softplus(p["lam"])      # (.., R) <= 0
    gated = i * vf
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * gated


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal conv. x: (B,S,R); w: (width,R).

    Returns (y, new_state) where state carries the trailing (width-1) inputs.
    """
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return y, new_state


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal linear recurrence h_t = exp(log_a_t) h_{t-1} + b_t.

    log_a, b: (B, S, R) f32; h0: (B, R) or None (zeros). One ``rglru_scan``
    op call, walking time in order (differentiable: ``ops.RGLRUScan``).
    """
    return rglru_ops.rglru_scan(log_a, b, h0)


def rglru_step(log_a: torch.Tensor, b: torch.Tensor, h: torch.Tensor
               ) -> torch.Tensor:
    """One decode step: (B, R) each; the ``rglru_scan`` op with S = 1."""
    return rglru_ops.rglru_scan(log_a[:, None], b[:, None], h)[:, 0]
