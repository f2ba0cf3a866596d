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
``moe_held_forward`` is DeepSeek-V3's router over a chip's share of the
experts, dropless; it reads its rows' counts back in a prefill only.
Latent attention's products (``matmul_f32``) keep bf16 operands on the
tensor cores with f32 results.
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
from .config import MoeSpec, YarnSpec

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
         fraction: float = 1.0, inv_freq: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (S,) or (B, S).
    ``inv_freq``: the rotated half's frequencies (``yarn_inv_freq``) in
    place of ``theta``'s."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half) \
        if inv_freq is None else inv_freq.to(x.device)
    if positions.dim() == 1:
        ang = positions.float()[None, :, None] * freqs[None, None, :]
    else:
        ang = positions.float()[..., None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]    # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def _yarn_dim(rotations: float, dim: int, theta: float, original: int
              ) -> float:
    """The rotary dimension whose wavelength turns ``rotations`` times over
    the ``original`` context (YaRN's correction dimension)."""
    return dim * math.log(original / (rotations * 2 * math.pi)) \
        / (2 * math.log(theta))


def yarn_inv_freq(dim: int, theta: float, yarn: YarnSpec) -> torch.Tensor:
    """YaRN's frequencies for a rotary head of ``dim`` (f32, dim // 2):
    ``theta``'s own below the correction range, divided by ``factor``
    above it, a linear ramp between (DeepSeek-V3's ``inv_freq``)."""
    low = max(math.floor(_yarn_dim(yarn.beta_fast, dim, theta,
                                   yarn.original_max_position)), 0)
    high = min(math.ceil(_yarn_dim(yarn.beta_slow, dim, theta,
                                   yarn.original_max_position)), dim - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    return extra / yarn.factor * ramp + extra * (1 - ramp)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale ``0.1 m ln(factor) + 1`` (1 without scaling)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or batched 3-D) into f32. bf16 operands on the card
    multiply on the tensor cores and accumulate into an f32 result
    (``out_dtype``): the f32 products of their values, summed in another
    order. Elsewhere the operands are cast to f32 first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def causal_attention_blocks(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float, block: int = 512
                            ) -> torch.Tensor:
    """Causal attention of one sequence, a block of queries at a time,
    each over the keys up to its last position: q, k (H, S, dq), v (H, S,
    dv) -> (S, H, dv) in q's dtype. The scale is folded into q (one
    rounding in q's dtype); scores and softmax are f32
    (:func:`matmul_f32`), so a block holds (H, block, S) f32 scores at
    most, masked on its diagonal square alone; the probabilities are cast
    to v's dtype for ``p v``. q and k may be wider than v (latent
    attention's expanded form)."""
    H, S, _ = q.shape
    qs = (q.float() * scale).to(q.dtype)
    out = torch.empty((S, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    pos = torch.arange(block, device=q.device)
    above = pos[None, :] > pos[:, None]
    for a in range(0, S, block):
        e = min(a + block, S)
        s = matmul_f32(qs[:, a:e], k[:, :e].transpose(1, 2))   # (H, q, k)
        s[..., a:].masked_fill_(above[:e - a, :e - a], float("-inf"))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out[a:e] = matmul_f32(p, v[:, :e]).transpose(0, 1)
    return out


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


def moe_held_forward(x: torch.Tensor, router_w: torch.Tensor,
                     router_bias: torch.Tensor, w1: torch.Tensor,
                     w3: torch.Tensor, w2: torch.Tensor, moe: MoeSpec,
                     shared: Optional[Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's routed experts over the ``moe.held`` experts this
    chip holds (``MoeSpec``), dropping no token. Returns (out, aux), aux 0
    (``noaux_tc`` balances through the bias, not a loss).

    x: (B, S, D); router_w: (D, E) over all E experts; router_bias: (E,);
    w1/w3: (held, D, F), w2: (held, F, D). The router runs in f32: the top
    k of ``sigmoid(x R) + bias``, each weighted by its sigmoid score over
    the chosen k's sum, times ``moe.routed_scale``. The layer returns the
    held experts' weighted outputs plus the shared expert's; a token's
    absent experts add nothing here (their chips add it). The weighted
    sum is f32, cast to x's dtype once.

    A decode step (S = 1) gives each held expert a slot for every token
    (a token reaches an expert at most once): static shapes, so a CUDA
    graph captures it, and nothing drops. A longer input (the prefill) is
    dispatched grouped: the routed rows sorted by held expert, each
    expert's rows multiplied as one block, their counts read back to the
    host once.

    With a ``runtime.spans.Timeline`` open: device spans ``.route``,
    ``.experts``, ``.shared``, ``.combine`` inside the caller's, and the
    counters ``moe_tokens_kept`` (rows computed for held experts) and
    ``moe_slots`` (rows the experts were given: held x tokens in a step,
    the kept rows in the grouped dispatch)."""
    phase = spans.phases()
    phase(".route")
    B, S, D = x.shape
    T, k, held = B * S, moe.top_k, moe.n_held
    xt = x.reshape(T, D)
    scores = torch.sigmoid(matmul_f32(xt, router_w))           # (T, E)
    idx = torch.topk(scores + router_bias.float(), k, dim=-1).indices
    weights = scores.gather(-1, idx)
    weights = weights / weights.sum(dim=-1, keepdim=True) * moe.routed_scale
    local = idx - moe.held_first                               # (T, k)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    if S == 1:
        hit = local[:, :, None] == torch.arange(held, device=x.device)
        gate = (weights[:, :, None] * hit).sum(dim=1).T        # (held, T)
        reached = hit.any(dim=1).T                             # (held, T)
        buf = torch.where(reached[..., None], xt[None], torch.zeros(
            (), dtype=x.dtype, device=x.device))               # (held, T, D)
        slots = held * T
    else:
        mine = (local >= 0) & (local < held)
        expert = local[mine]
        order = torch.argsort(expert, stable=True)
        rows = torch.arange(T, device=x.device)[:, None].expand(T, k)[
            mine][order]
        gate = weights[mine][order]
        counts = torch.bincount(expert, minlength=held).tolist()
        slots = sum(counts)
    phase(None)
    if spans.timeline() is not None:
        spans.device_counter("moe_tokens_kept",
                             reached.sum() if S == 1 else slots)
        spans.device_counter("moe_slots", slots)

    phase(".experts")
    if S == 1:
        y = _experts(buf[None], w1, w3, w2)[0]                 # (held, T, D)
    else:
        xs = xt[rows]
        y = torch.empty_like(xs)
        at = 0
        for e, n in enumerate(counts):
            if n:
                y[at:at + n] = swiglu(xs[at:at + n], w1[e], w3[e], w2[e])
            at += n
    if shared is not None:
        phase(".shared")
        out += swiglu(xt, *shared).float()
    phase(".combine")
    if S == 1:
        out += (y.float() * gate[..., None]).sum(dim=0)
    else:
        out.index_add_(0, rows, y.float() * gate[:, None])
    phase(None)
    return out.to(x.dtype).reshape(B, S, D), torch.zeros(
        (), dtype=torch.float32, device=x.device)


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
