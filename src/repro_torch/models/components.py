"""Model building blocks in PyTorch (the reference's ``models/components.py``).

Numerics policy, as in the reference: parameters and activations are bf16;
softmax, norms and recurrences accumulate in f32. Attention is a chunked
online softmax (flash-style) in plain PyTorch, as the reference's is plain
JAX. The RG-LRU recurrence runs through the port's ``rglru_scan`` op: the
hand-written CUDA kernel on the card, its plain version on the CPU; under
autograd its gradient is the hand-written gradient kernel (its plain
version on the CPU), where the reference differentiates its own scan. The
reference scans with ``jax.lax.associative_scan`` (folding ``h0`` into the
first step) and steps with ``exp(log_a) h + b``; the op walks time in order,
so the two agree to f32 rounding. f32 products here need TF32 off on the
card (PyTorch's default for matrix products).

Not ported yet (ROADMAP queue 1 item 11): ``moe_forward`` and
``_positions_in_expert``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan import ops as rglru_ops

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
              kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-bounded attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H = K * G.
    q_pos: (Sq,) absolute positions; kv_pos: (Sk,) absolute positions, -1
    marks invalid cache slots. Never materializes more than (.., Sq, chunk)
    scores. GQA k/v are repeated to H heads up front, query head h reading
    KV head h // G (``jnp.repeat``'s interleaving).
    """
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale

    def block(kc, kp):
        """Masked scores for one kv chunk: (B, H, Sq, C)."""
        s = torch.einsum("bqhd,bchd->bhqc", qf, kc.float())
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
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ w1 + b1, approximate="tanh")    # jax.nn.gelu's default
    return h @ w2 + b2


def gelu_ffn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
             ) -> torch.Tensor:
    return F.gelu(x @ w1, approximate="tanh") @ w2


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def _rglru_gates(v: torch.Tensor, p) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a (decay, in log space, <= 0) and gated input, both f32."""
    vf = v.float()
    r = torch.sigmoid(vf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(vf @ p["w_x"].float() + p["b_x"])
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
