"""Serving steps: prefill (prompt -> cache) and decode (one token/step).

The port's :class:`~repro_torch.models.Model` holds its parameters, so the
steps take no ``params`` argument; otherwise they are the reference's. The
prefill takes the reference's ``extras`` (encoder frames, image tokens);
the decode step reads the cross-attention K/V that prefill put in the
cache.

The reference compiles its decode step once, ``jax.jit(serve_step,
donate_argnums=1)``: one program a step, the cache updated in place, the
position a traced scalar. On the card the port's counterpart is
:class:`GraphedServeStep`: the step captured once into a CUDA graph over a
static cache, then replayed, so one host call submits every operation of
the step, the ``rglru_scan`` / ``rwkv6_step`` launches among them. On the
CPU the step runs eagerly, as :meth:`Model.decode_step` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import _launches
from ..models.transformer import Cache, init_layer_cache


def make_eager_serve_step(model):
    """The eager step: ``model.decode_step`` and the argmax; the returned
    cache is new and ``cache`` is left as it was."""

    def serve_step(cache: Cache, tokens: torch.Tensor, pos
                   ) -> Tuple[torch.Tensor, Cache]:
        logits, new_cache = model.decode_step(cache, tokens, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], new_cache

    return serve_step


def make_serve_step(model):
    """serve_step(cache, tokens (B,1), pos) -> (next (B,1) i32, cache).

    On a CUDA model, a :class:`GraphedServeStep` (the returned tokens and
    cache are overwritten by the next call: see there); on a CPU model the
    eager step, which leaves ``cache`` as it was."""
    if model.device is not None and model.device.type == "cuda":
        return GraphedServeStep(model)
    return make_eager_serve_step(model)


def make_prefill(model, cache_len: int):
    """prefill(tokens, extras=None) -> (last-token logits (B, V), cache)."""

    def prefill(tokens: torch.Tensor,
                extras: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Cache]:
        logits, cache = model.prefill(tokens, cache_len, extras)
        return logits[:, -1, :].clone(), cache

    return prefill


class _Graph:
    """One decode step captured at one (batch, cache length): its static
    inputs, cache and outputs, and the kernel launches it replays."""

    def __init__(self, cache: Cache, device: torch.device) -> None:
        batch = next(iter(cache[0].values())).shape[0]
        self.cache = cache
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.next: Optional[torch.Tensor] = None
        self.logits: Optional[torch.Tensor] = None
        self.tally: Dict[Tuple[str, str], int] = {}


class GraphedServeStep:
    """The decode step as one CUDA graph a call, over a static cache.

    Called as ``step(cache, tokens, pos) -> (next (B, 1) int32, cache)``,
    like the eager step. :meth:`capture` builds the graph for a (batch,
    cache length) ahead of time; a first call with a cache of a new shape
    captures it then. A call copies the caller's cache into the static one
    unless it is the static one already (every call after the first
    returns it), writes ``pos`` on the device, copies ``tokens`` in unless
    they are the last call's output (the graph writes its argmax into its
    token input), and replays the graph.

    Donation, as the reference's ``donate_argnums=1``: the returned cache
    and tokens are the step's static tensors, overwritten by the next call;
    clone what must outlive it. :attr:`logits` are the last call's (B, V)
    logits, overwritten likewise.

    Launch counts: the warm-up before a capture runs its kernels, which
    count; the captured launches count once on each replay
    (:mod:`repro_torch.kernels._launches`). There is no fallback: a capture
    or replay that fails raises, and so does a cache or token batch whose
    shapes, dtypes or device differ from what the model's ``init_cache``
    gives.
    """

    def __init__(self, model) -> None:
        if model.device is None or model.device.type != "cuda":
            raise ValueError("GraphedServeStep needs a model on a CUDA device "
                             f"(the model is on {model.device})")
        self.model = model
        index = model.device.index
        self.device = torch.device(
            "cuda", torch.cuda.current_device() if index is None else index)
        self._graphs: Dict[Tuple[int, int], _Graph] = {}
        self.logits: Optional[torch.Tensor] = None

    # -- shapes -------------------------------------------------------------
    def _key(self, cache: Cache) -> Tuple[int, int]:
        """(batch, cache length) of a cache, after checking every tensor of
        it against ``init_cache`` of those sizes."""
        cfg = self.model.cfg
        if not isinstance(cache, (list, tuple)) or len(cache) != len(
                cfg.layers):
            raise ValueError(f"the cache must be a list of {len(cfg.layers)} "
                             f"layer dicts, got {type(cache).__name__}")
        batch = next(iter(cache[0].values())).shape[0]
        # full-attention rings hold the cache length, local ones at most it
        length = max((cb["k"].shape[1] for cb in cache if "k" in cb),
                     default=1)
        meta = torch.device("meta")
        for n, (spec, cb) in enumerate(zip(cfg.layers, cache)):
            want = init_layer_cache(cfg, spec, batch, length, meta)
            got = {key: (tuple(t.shape), t.dtype, t.device)
                   for key, t in cb.items()}
            exp = {key: (tuple(t.shape), t.dtype, self.device)
                   for key, t in want.items()}
            if got != exp:
                raise ValueError(
                    f"layer {n} ({spec.mix}) cache is {got}; the step takes "
                    f"{exp} (batch {batch}, cache length {length})")
        return batch, length

    def _check_tokens(self, tokens: torch.Tensor, batch: int) -> None:
        if (not isinstance(tokens, torch.Tensor)
                or tuple(tokens.shape) != (batch, 1)
                or tokens.device != self.device
                or tokens.dtype.is_floating_point):
            raise ValueError(
                f"tokens must be integer ({batch}, 1) on {self.device}, got "
                f"{getattr(tokens, 'dtype', type(tokens).__name__)} "
                f"{tuple(getattr(tokens, 'shape', ()))} on "
                f"{getattr(tokens, 'device', None)}")

    # -- capture ------------------------------------------------------------
    def _body(self, cache: Cache, tokens: torch.Tensor, pos: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.model.decode_step_(cache, tokens, pos)[:, -1, :]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits

    @torch.no_grad()
    def _capture(self, key: Tuple[int, int], cache: Cache) -> _Graph:
        g = _Graph(cache, self.device)
        # warm up on a throwaway cache, on a side stream: a kernel's first
        # launch loads its module, which must not happen inside a capture
        throwaway = [{k: torch.zeros_like(t) for k, t in cb.items()}
                     for cb in cache]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body(throwaway, g.tokens, g.pos)
        main.wait_stream(side)
        del throwaway
        with _launches.capturing() as tally:
            with torch.cuda.graph(g.graph):
                g.next, g.logits = self._body(g.cache, g.tokens, g.pos)
                g.tokens.copy_(g.next)
        g.tally = dict(tally)
        self._graphs[key] = g
        return g

    def capture(self, batch: int, cache_len: int) -> None:
        """Capture the step for ``batch`` sequences and ``cache_len`` (ahead
        of the first call, as the reference lowers and compiles ahead)."""
        cache = self.model.init_cache(batch, cache_len)
        key = self._key(cache)
        if key not in self._graphs:
            self._capture(key, cache)

    # -- call ---------------------------------------------------------------
    @torch.no_grad()
    def __call__(self, cache: Cache, tokens: torch.Tensor, pos
                 ) -> Tuple[torch.Tensor, Cache]:
        g = next((g for g in self._graphs.values() if g.cache is cache),
                 None)
        if g is not None:
            self._check_tokens(tokens, g.tokens.shape[0])
        else:
            key = self._key(cache)
            self._check_tokens(tokens, key[0])
            g = self._graphs.get(key)
            if g is None:
                g = self._capture(key, [{k: torch.zeros_like(t)
                                         for k, t in cb.items()}
                                        for cb in cache])
            for dst, src in zip(g.cache, cache):
                for k, t in src.items():
                    dst[k].copy_(t)
        if isinstance(pos, torch.Tensor):
            g.pos.copy_(pos.reshape(()))
        else:
            g.pos.fill_(int(pos))
        if tokens is not g.next:
            g.tokens.copy_(tokens)
        g.graph.replay()
        _launches.replayed(g.tally)
        self.logits = g.logits
        return g.next, g.cache
