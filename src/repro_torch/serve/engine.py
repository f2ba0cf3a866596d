"""Batched serving engine over the tiered, paged KV cache.

A compact GQA attention LM whose decode path reads K/V through the
:class:`TieredKvCache` page tables and the ``paged_attention`` kernel —
the end-to-end demonstration that policy-driven page tiering (DESIGN SS2)
serves real traffic: requests admit/prefill/decode/finish while the policy
engine moves pages between the card and host tiers underneath them.

The model's weights and the K/V pools live on the engine's device (the
CUDA card unless the caller passes ``device="cpu"``). Per layer and token
only the page table and the length cross to the card; a page's K/V crosses
when the policy releases it or a touch restores it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..kernels.paged_attention.ops import paged_attention
from ..kvcache.paged import PagePool
from ..kvcache.tiering import TieredKvCache


@dataclasses.dataclass
class PagedLMConfig:
    vocab: int = 512
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 4
    n_kv: int = 2
    head_dim: int = 16
    d_ff: int = 128
    page_size: int = 16
    n_pages: int = 64         # hot-pool capacity (per layer)
    high_wm: float = 80.0
    low_wm: float = 50.0


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _normal(shape, scale: float, gen: torch.Generator,
            device: torch.device) -> nn.Parameter:
    w = torch.randn(shape, generator=gen, device=device).mul_(scale)
    return nn.Parameter(w, requires_grad=False)


class PagedLayer(nn.Module):
    """One block's weights, in the reference's (in, out) layout."""

    def __init__(self, cfg: PagedLMConfig, gen: torch.Generator,
                 device: torch.device) -> None:
        super().__init__()
        s = 1.0 / np.sqrt(cfg.d_model)
        qk = cfg.n_heads * cfg.head_dim
        kv = cfg.n_kv * cfg.head_dim
        self.wq = _normal((cfg.d_model, qk), s, gen, device)
        self.wk = _normal((cfg.d_model, kv), s, gen, device)
        self.wv = _normal((cfg.d_model, kv), s, gen, device)
        self.wo = _normal((qk, cfg.d_model), s, gen, device)
        self.w1 = _normal((cfg.d_model, cfg.d_ff), s, gen, device)
        self.w2 = _normal((cfg.d_ff, cfg.d_model), 1.0 / np.sqrt(cfg.d_ff),
                          gen, device)


class PagedLM(nn.Module):
    """``embed`` (vocab, d), ``head`` (d, vocab) and the layers' weights,
    drawn on ``device`` from ``gen`` with the reference's scales."""

    def __init__(self, cfg: PagedLMConfig, gen: torch.Generator,
                 device: torch.device) -> None:
        super().__init__()
        self.embed = _normal((cfg.vocab, cfg.d_model), 0.05, gen, device)
        self.head = _normal((cfg.d_model, cfg.vocab), 0.05, gen, device)
        self.layers = nn.ModuleList(PagedLayer(cfg, gen, device)
                                    for _ in range(cfg.n_layers))


class ServingEngine:
    def __init__(self, cfg: PagedLMConfig, seed: int = 0,
                 device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.model = PagedLM(cfg, gen, self.device)
        # one tiered cache per layer (pages are per-layer entries)
        self.caches = [
            TieredKvCache(PagePool(cfg.n_pages, cfg.page_size, cfg.n_kv,
                                   cfg.head_dim, device=self.device),
                          cfg.high_wm, cfg.low_wm)
            for _ in range(cfg.n_layers)]
        self.requests: Dict[int, Request] = {}
        self._lengths: Dict[int, int] = {}

    # -- model math -----------------------------------------------------------
    def _token_qkv(self, layer: PagedLayer, x: torch.Tensor):
        cfg = self.cfg
        q = (x @ layer.wq).reshape(cfg.n_heads, cfg.head_dim)
        k = (x @ layer.wk).reshape(cfg.n_kv, cfg.head_dim)
        v = (x @ layer.wv).reshape(cfg.n_kv, cfg.head_dim)
        return q, k, v

    @torch.inference_mode()
    def _logits(self, req: Request, token: int) -> torch.Tensor:
        """Run one token through all layers for one request."""
        cfg = self.cfg
        x = self.model.embed[token]
        pos = self._lengths[req.req_id]
        max_pages = -(-(pos + 1) // cfg.page_size)
        length = np.asarray([pos + 1], np.int32)
        for li, layer in enumerate(self.model.layers):
            cache = self.caches[li]
            q, k, v = self._token_qkv(layer, x)
            cache.append_token(req.req_id, k, v)
            pt = cache.page_table(req.req_id, max_pages)
            out = paged_attention(q[None], cache.pool.k, cache.pool.v,
                                  pt[None], length)
            cache.unpin()
            attn = out[0].reshape(-1) @ layer.wo
            x = x + attn
            x = x + F.gelu(x @ layer.w1, approximate="tanh") @ layer.w2
        self._lengths[req.req_id] = pos + 1
        return x @ self.model.head

    def _step_token(self, req: Request, token: int) -> int:
        return int(torch.argmax(self._logits(req, token)))

    # -- request lifecycle ------------------------------------------------------
    def admit(self, req: Request) -> None:
        self.requests[req.req_id] = req
        self._lengths[req.req_id] = 0
        for cache in self.caches:
            cache.admit(req.req_id)

    def run(self, requests: List[Request],
            policy_interval: int = 4) -> List[Request]:
        """Serve a batch of requests to completion (greedy decoding)."""
        for r in requests:
            self.admit(r)
        # prefill: feed prompts token by token (writes pages)
        for r in requests:
            nxt = 0
            for t in r.prompt:
                nxt = self._step_token(r, t)
            r.generated.append(nxt)
        # decode rounds (interleaved across requests = continuous batching)
        step = 0
        while any(not r.done for r in requests):
            for r in requests:
                if r.done:
                    continue
                nxt = self._step_token(r, r.generated[-1])
                r.generated.append(nxt)
                if len(r.generated) >= r.max_new:
                    r.done = True
            step += 1
            if step % policy_interval == 0:
                for cache in self.caches:
                    cache.maybe_run_policies()
        for r in requests:
            for cache in self.caches:
                cache.finish(r.req_id)
        return requests

    def tier_report(self) -> List[dict]:
        return [c.tier_report() for c in self.caches]
