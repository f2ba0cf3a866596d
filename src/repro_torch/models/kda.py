"""Kimi Delta Attention's recurrence (Kimi Linear's gated delta rule), in
PyTorch.

Per head, with keys and queries of K channels, values of V and an f32
state S of (K, V), at token t:

    S'  = diag(exp(g_t)) S_{t-1}            (g_t <= 0: a decay a key channel)
    u_t = beta_t (v_t - S'^T k_t)
    S_t = S' + k_t u_t^T
    o_t = S_t^T q_t

:func:`kda_step_` is one token, writing the state in place (the decode
step's, inside the captured graph). :func:`kda_chunked` is the prefill's
chunked form: with G the decays summed within a chunk from its start,
every pair of positions s <= t of a chunk meets through
``exp(G_t - G_s)``, and the chunk's outputs and final state follow from
the state at its start by a unit lower-triangular solve and a few
products (the WY form of the delta rule). Each such decay is taken as
``exp(G_t - G_r) * exp(G_r - G_s)`` around a position r with s <= r < t,
a block of pairs at a time, so every exponential evaluated has a
non-positive argument: however strong the decay, nothing overflows.
"""
from __future__ import annotations

from typing import Tuple

import torch

CHUNK = 64              # positions a chunk of the prefill


def kda_step_(state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor
              ) -> torch.Tensor:
    """One token for every sequence and head, ``state`` (B, H, K, V) f32
    updated in place: scaled by the decay, read at k, written by k u^T,
    read at q. q, k, g: (B, H, K); v: (B, H, V); beta: (B, H); all f32.
    Returns o (B, H, V)."""
    B, H, K, V = state.shape
    s = state.view(B * H, K, V)
    state.mul_(torch.exp(g)[..., None])
    ks = torch.bmm(k.reshape(B * H, 1, K), s)                 # S'^T k
    u = beta.reshape(B * H, 1, 1) * (v.reshape(B * H, 1, V) - ks)
    s.baddbmm_(k.reshape(B * H, K, 1), u)
    return torch.bmm(q.reshape(B * H, 1, K), s).view(B, H, V)


def _pairs(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within each chunk (the last two dims, (C, K), C a power of two):
    ``Aqk[t, s] = sum_c q_t k_s exp(G_t - G_s)`` for s <= t and ``Akk``
    the same with k_t for s < t, zero elsewhere. The chunk is halved again
    and again: at each level every block's lower-left quarter is one
    product, its decays taken around the last position r of the block's
    first half (t past r, s not)."""
    *lead, C, K = k.shape
    Aqk = q.new_zeros(*lead, C, C)
    Akk = q.new_zeros(*lead, C, C)
    b = C
    while b > 1:
        h, n = b // 2, C // b
        qb, kb, Gb = (t.reshape(*lead, n, b, K) for t in (q, k, G))
        Gr = Gb[..., h - 1:h, :]
        e = torch.exp(Gb[..., h:, :] - Gr)                      # t > r
        right = (kb[..., :h, :] * torch.exp(Gr - Gb[..., :h, :])
                 ).transpose(-1, -2)                             # s <= r
        for A, x in ((Aqk, qb), (Akk, kb)):
            blocks = torch.diagonal(A.view(*lead, n, b, n, b), dim1=-4,
                                    dim2=-2).movedim(-1, -3)  # (.., n, b, b)
            blocks[..., h:, :h] = (x[..., h:, :] * e) @ right
        b = h
    torch.diagonal(Aqk, dim1=-2, dim2=-1).copy_((q * k).sum(-1))
    return Aqk, Akk


def kda_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, beta: torch.Tensor, chunk: int = CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over whole sequences from a zero state, a chunk of
    ``chunk`` positions (a power of two) at a time. q, k, g: (B, S, H, K);
    v: (B, S, H, V); beta: (B, S, H); all f32. Returns (o (B, S, H, V),
    the final state (B, H, K, V)). A sequence not a whole number of chunks
    is padded with positions that leave the state as it is (k = 0, g =
    0). The host walks the chunks; everything within a chunk is products
    over every sequence and head at once."""
    B, S, H, K = k.shape
    V = v.shape[-1]
    n = -(-S // chunk)
    pad = n * chunk - S

    def blocks(t):                                    # (B, H, n, C, ...)
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(B, n, chunk, H, -1).permute(0, 3, 1, 2,
                                                     4).contiguous()

    q, k, v, g = (blocks(t) for t in (q, k, v, g))
    beta = blocks(beta[..., None])
    G = torch.cumsum(g, dim=-2)                       # <= 0, falling
    Aqk, Akk = _pairs(q, k, G)
    # (I + beta Akk) [w u] = beta [k exp(G)  v]: each position's write
    # with the earlier ones' inside the chunk taken out (the solve reads
    # the strictly lower part, the unit diagonal taken as given)
    wu = torch.linalg.solve_triangular(
        Akk * beta, beta * torch.cat([k * torch.exp(G), v], dim=-1),
        upper=False, unitriangular=True)
    w, u = wu[..., :K], wu[..., K:]
    qg = q * torch.exp(G)
    kd = (k * torch.exp(G[..., -1:, :] - G)).transpose(-1, -2)  # to its end
    decay = torch.exp(G[..., -1, :])[..., None]              # (B, H, n, K, 1)
    s = torch.zeros((B, H, K, V), dtype=torch.float32, device=k.device)
    out = torch.empty((B, H, n, chunk, V), dtype=torch.float32,
                      device=k.device)
    for i in range(n):
        vn = u[:, :, i] - w[:, :, i] @ s
        out[:, :, i] = qg[:, :, i] @ s + Aqk[:, :, i] @ vn
        s = s * decay[:, :, i] + kd[:, :, i] @ vn
    o = out.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H, V)[:, :S]
    return o, s
