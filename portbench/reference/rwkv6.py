"""RWKV-6 "Finch" (arXiv:2404.05892), the port's form of it, in plain
float32 PyTorch: a sequence's logits, the recurrence walked a token at a
time.

Per layer: x += TimeMix(norm1(x)); x += ChannelMix(norm2(x)). TimeMix:
the data-dependent token shift ``m_j = h + (mu_j + tanh((h' - h) A) B_j)
(h' - h)`` (h' the previous token's, 0 before the first) for r, k, v, g
and the decay, ``w = exp(-exp(w0 + tanh(m_w Da) Db))``, per head

    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T

then a group norm a head (eps 1e-5), ``* ln_x``, ``* silu(g)``, the output
product. ChannelMix: ``sigmoid(m_r Wr) * (relu(m_k Wk)^2 Wv)``. Departures
from the published model, as the port has them: RMSNorm with weight
``1 + w`` in place of LayerNorm, no ``ln0``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from .common import mm, rms_norm


def _shift(h: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)


def _time_mix(cfg: Dict, w: Dict[str, torch.Tensor], b: str,
              h: torch.Tensor, precision: str) -> torch.Tensor:
    N, T, D = h.shape
    H, hd, L = cfg["n_heads"], cfg["head_dim"], cfg["rwkv_lora_mix"]
    dx = _shift(h) - h
    dyn = torch.tanh(mm(dx, w[f"{b}.att.time_maa_w1"], precision))
    dyn = dyn.reshape(N, T, 5, L)
    mu, lora_b = w[f"{b}.att.time_maa"], w[f"{b}.att.time_maa_w2"]
    mr, mk, mv, mg, mw = (h + (mu[j] + dyn[:, :, j] @ lora_b[j]) * dx
                          for j in range(5))
    r = mm(mr, w[f"{b}.att.receptance"], precision).reshape(N, T, H, hd)
    k = mm(mk, w[f"{b}.att.key"], precision).reshape(N, T, H, hd)
    v = mm(mv, w[f"{b}.att.value"], precision).reshape(N, T, H, hd)
    g = mm(mg, w[f"{b}.att.gate"], precision)
    dd = torch.tanh(mw @ w[f"{b}.att.time_decay_w1"]) \
        @ w[f"{b}.att.time_decay_w2"]
    decay = torch.exp(-torch.exp(w[f"{b}.att.time_decay"] + dd))
    decay = decay.reshape(N, T, H, hd)
    u = w[f"{b}.att.time_faaaa"]
    state = torch.zeros((N, H, hd, hd), dtype=torch.float32, device=h.device)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("nhi,nhij->nhj", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = decay[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1)                               # (N,T,H,hd)
    mu_y = y.mean(dim=-1, keepdim=True)
    var = ((y - mu_y) ** 2).mean(dim=-1, keepdim=True)
    y = ((y - mu_y) * torch.rsqrt(var + 1e-5)).reshape(N, T, D)
    y = y * w[f"{b}.att.ln_x.weight"] * F.silu(g)
    return mm(y, w[f"{b}.att.output"], precision)


def _channel_mix(w: Dict[str, torch.Tensor], b: str, h: torch.Tensor,
                 precision: str) -> torch.Tensor:
    dx = _shift(h) - h
    mr = h + w[f"{b}.ffn.time_maa_r"] * dx
    mk = h + w[f"{b}.ffn.time_maa_k"] * dx
    kk = torch.square(F.relu(mm(mk, w[f"{b}.ffn.key"], precision)))
    return torch.sigmoid(mm(mr, w[f"{b}.ffn.receptance"], precision)) * \
        mm(kk, w[f"{b}.ffn.value"], precision)


@torch.no_grad()
def logits(cfg: Dict, weights: Callable[[int], Dict[str, torch.Tensor]],
           tokens: torch.Tensor, first: int, precision: str = "f32",
           record=None) -> torch.Tensor:
    """Logits (N, T - first, V) at positions ``first``..T-1 of ``tokens``
    (N, T) int64. ``weights(g)``: group g's float32 weights (0: embedding,
    final norm, head; i + 1: layer i). ``record``: nothing to record (no
    routing)."""
    eps = cfg["norm_eps"]
    outer = weights(0)
    x = outer["emb.weight"][tokens]
    for i in range(cfg["n_layers"]):
        w, b = weights(i + 1), f"blocks.{i}"
        x = x + _time_mix(cfg, w, b, rms_norm(x, w[f"{b}.ln1.weight"], eps),
                          precision)
        x = x + _channel_mix(w, b, rms_norm(x, w[f"{b}.ln2.weight"], eps),
                             precision)
        del w
    h = rms_norm(x[:, first:], outer["ln_out.weight"], eps)
    return mm(h, outer["head.weight"], precision)
