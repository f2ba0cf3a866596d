"""Serving steps: prefill (prompt -> cache) and decode (one token/step).

The reference's steps take the parameters as an argument; the port's
:class:`~repro_torch.models.Model` holds its own, so ``params`` is
optional: without it (and ``part``) the steps run the whole batch on the
model's own parameters. The prefill takes the reference's ``extras``
(encoder frames, image tokens); the decode step reads the
cross-attention K/V that prefill put in the cache.

**Over a mesh** (the reference's ``jax.jit(prefill, in_shardings=(
param_sh, batch_sh))`` and ``jax.jit(serve_step, in_shardings=(param_sh,
cache_sh, tok_sh, P()), out_shardings=(tok_sh, cache_sh),
donate_argnums=1)``, ``launch/dryrun.py``). ``params`` maps each name to
this rank's shard, a plain tensor, and ``part`` is the
``runtime.partition.Partition`` of the mesh
(``runtime.sharding.lay_out_params`` gives both; ``rows_split`` as
``batch_pspecs`` splits the batch). Each rank then runs its rows of the
batch on its parameter shards and its cache shard:

* ``prefill(tokens, extras)`` takes the global batch (a whole tensor every
  rank holds, or a ``DTensor`` laid out by ``batch_pspecs``) and returns
  the rank's rows of the last-token logits, gathered whole over "model"
  (the reference's ``P(dp, None)``), and the rank's cache shard
  (``cache_pspecs``, ``Model.init_cache(part=)``);
* ``serve_step(cache, tokens, pos)`` takes the rank's cache shard and its
  rows of the tokens (what the last step returned: the reference's
  ``tok_sh``), and returns the next tokens of those rows through the
  vocab-parallel argmax (``Partition.tp_argmax``) and the cache.

The reference compiles its decode step once, ``jax.jit(serve_step,
donate_argnums=1)``: one program a step, the cache updated in place, the
position a traced scalar. On the card the port's counterpart is
:class:`GraphedServeStep`: the step captured once into a CUDA graph over a
static cache, then replayed, so one host call submits every operation of
the step, the ``rglru_scan`` / ``rwkv6_step`` launches among them. On the
CPU the step runs eagerly, as :meth:`Model.decode_step` does. On a
partition of more than one rank the step is eager on the card too, by
design: its collectives would have to be captured into the graph, which
one card cannot test (one NCCL rank a card). A 1x1 partition calls no
collective, so its step is graphed like the unpartitioned one.

**Spans** (``runtime/spans.py``), under an ambient trace of a
``core.telemetry.MetricRegistry``: host spans ``serve.prefill``
(``prefill.forward``, ``prefill.cache_fill``) and ``serve.step``
(``step.check``, ``step.cache_copy_in``, ``step.replay``,
``step.capture``). With a ``spans.Timeline`` open too,
:class:`GraphedServeStep` times each replay on the device
(``decode.graph``, events recorded on the stream around it) and, where
the timeline asks for the layers, replays a graph captured with the
model's device spans and counters in it, kept beside the plain graph,
which it never replaces.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..kernels import _launches
from ..models.transformer import Cache, _whole, init_layer_cache
from ..runtime import spans
from ..runtime.partition import NO_PARTITION, Partition
from ..runtime.sharding import local_batch

Params = Optional[Mapping[str, torch.Tensor]]


def _next_tokens(model, logits: torch.Tensor, part: Partition
                 ) -> torch.Tensor:
    """(B, 1) int32 argmax of the last position's logits."""
    return part.tp_argmax(logits[:, -1, :], model.cfg.vocab).to(
        torch.int32)[:, None]


def make_eager_serve_step(model, params: Params = None,
                          part: Optional[Partition] = None):
    """The eager step: ``model.decode_step`` and the argmax; the returned
    cache is new and ``cache`` is left as it was."""
    part = part or NO_PARTITION

    def serve_step(cache: Cache, tokens: torch.Tensor, pos
                   ) -> Tuple[torch.Tensor, Cache]:
        with spans.host_span("serve.step"):
            logits, new_cache = model.decode_step(cache, tokens, pos, params,
                                                  part)
            return _next_tokens(model, logits, part), new_cache

    return serve_step


def make_serve_step(model, params: Params = None,
                    part: Optional[Partition] = None):
    """serve_step(cache, tokens (B,1), pos) -> (next (B,1) i32, cache).

    On a CUDA model, a :class:`GraphedServeStep` (the returned tokens and
    cache are overwritten by the next call: see there), unless ``part``
    spans more than one rank; otherwise the eager step, which leaves
    ``cache`` as it was."""
    part = part or NO_PARTITION
    if model.device is not None and model.device.type == "cuda" and \
            part.trivial:
        return GraphedServeStep(model, params, part)
    return make_eager_serve_step(model, params, part)


def make_prefill(model, cache_len: int, params: Params = None,
                 part: Optional[Partition] = None):
    """prefill(tokens, extras=None) -> (last-token logits (B, V), cache);
    over a mesh the rank's rows and cache shard (module docstring). The
    head runs at the last position alone."""
    part = part or NO_PARTITION

    def prefill(tokens: torch.Tensor,
                extras: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Cache]:
        with spans.host_span("serve.prefill"):
            return _prefill(tokens, extras)

    def _prefill(tokens, extras):
        if part.mesh is not None:
            batch = {"tokens": tokens} | ({"extras": extras} if extras
                                          else {})
            batch, rows_split = local_batch(model.cfg, part.mesh, batch,
                                            model.device)
            if rows_split != part.rows_split and part.dp > 1:
                raise ValueError(
                    f"the batch's rows {'' if rows_split else 'do not '}"
                    "split over the data axes (batch_pspecs), the partition"
                    f" has rows_split={part.rows_split}")
            tokens, extras = batch["tokens"], batch.get("extras")
        logits, cache = model.prefill(tokens, cache_len, extras, params,
                                      part, last=True)
        last = _whole(part, logits[:, -1, :], model.cfg.vocab)
        return last.clone(), cache

    return prefill


def _layers() -> bool:
    """Whether a replay now is of the graph with the spans inside it."""
    tl = spans.timeline()
    return tl is not None and tl.layers


class _Static:
    """The static inputs and cache of one (batch, cache length), shared by
    its graphs: ``graphs[False]`` the plain one, ``graphs[True]`` the one
    captured with the device spans and counters in it."""

    def __init__(self, cache: Cache, device: torch.device) -> None:
        batch = next(iter(cache[0].values())).shape[0]
        self.cache = cache
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.graphs: Dict[bool, _Graph] = {}
        self.last: Optional[torch.Tensor] = None   # the last call's tokens


class _Graph:
    """One decode step captured over a :class:`_Static`: its outputs, the
    kernel launches it replays and the device spans it records."""

    def __init__(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.next: Optional[torch.Tensor] = None
        self.logits: Optional[torch.Tensor] = None
        self.tally: Dict[Tuple[str, str], int] = {}
        self.spans: list = []


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

    With a ``spans.Timeline`` open (module docstring) the replay is timed
    by a ``decode.graph`` device span around it and, while the timeline's
    ``layers`` is set, is that of a second graph of the same static cache
    and inputs, captured with the device spans and counters in it: the
    plain and the instrumented graph can take turns within a batch. A
    capture under such a timeline makes the second one.

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

    ``params``/``part``: the step over a 1x1 mesh (``make_serve_step``):
    the rank's shards (the whole tensors) in place of the model's own, and
    the cache checked against ``init_cache(part=)``. A partition of more
    than one rank is refused: its step is the eager one.
    """

    def __init__(self, model, params: Params = None,
                 part: Optional[Partition] = None) -> None:
        if model.device is None or model.device.type != "cuda":
            raise ValueError("GraphedServeStep needs a model on a CUDA device "
                             f"(the model is on {model.device})")
        part = part or NO_PARTITION
        if not part.trivial:
            raise ValueError("GraphedServeStep captures no collective: a "
                             f"partition of {part.dp} x {part.tp} ranks "
                             "decodes eagerly (make_serve_step)")
        self.model, self.params, self.part = model, params, part
        index = model.device.index
        self.device = torch.device(
            "cuda", torch.cuda.current_device() if index is None else index)
        self._statics: Dict[Tuple[int, int], _Static] = {}
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
        # full-attention rings and latent caches hold the cache length,
        # local ones at most it
        length = max((cb[key].shape[1] for cb in cache
                      for key in ("k", "latent") if key in cb), default=1)
        meta = torch.device("meta")
        for n, (spec, cb) in enumerate(zip(cfg.layers, cache)):
            want = init_layer_cache(cfg, spec, batch, length, meta,
                                    self.part)
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
        logits = self.model.decode_step_(cache, tokens, pos, self.params,
                                         self.part)
        return _next_tokens(self.model, logits, self.part), logits[:, -1, :]

    @torch.no_grad()
    def _capture(self, st: _Static, timed: bool) -> _Graph:
        """Captures the plain graph of ``st``, or with ``timed`` the one
        with the open timeline's device spans and counters in it."""
        with spans.host_span("step.capture"), \
                contextlib.nullcontext() if timed else spans.paused():
            g = _Graph()
            # warm up on a throwaway cache, on a side stream: a kernel's
            # first launch loads its module, which must not happen inside a
            # capture; its device spans and counts are not the trace's
            throwaway = [{k: torch.zeros_like(t) for k, t in cb.items()}
                         for cb in st.cache]
            main = torch.cuda.current_stream(self.device)
            with spans.discarded():
                side = torch.cuda.Stream(self.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    self._body(throwaway, st.tokens, st.pos)
                main.wait_stream(side)
            del throwaway
            tl = spans.timeline()
            mark = tl.mark() if tl else 0
            with _launches.capturing() as tally:
                with torch.cuda.graph(g.graph):
                    g.next, g.logits = self._body(st.cache, st.tokens,
                                                  st.pos)
                    st.tokens.copy_(g.next)
            g.tally = dict(tally)
            g.spans = tl.take(mark) if tl else []
            st.graphs[timed] = g
            return g

    def capture(self, batch: int, cache_len: int) -> None:
        """Capture the step for ``batch`` sequences and ``cache_len`` (ahead
        of the first call, as the reference lowers and compiles ahead); with
        a ``spans.Timeline`` open that asks for the layers, the instrumented
        graph."""
        cache = self.model.init_cache(batch, cache_len, self.part)
        key = self._key(cache)
        st = self._statics.get(key)
        if st is None:
            st = self._statics[key] = _Static(cache, self.device)
        timed = _layers()
        if timed not in st.graphs:
            self._capture(st, timed)

    # -- call ---------------------------------------------------------------
    @torch.no_grad()
    def __call__(self, cache: Cache, tokens: torch.Tensor, pos
                 ) -> Tuple[torch.Tensor, Cache]:
        with spans.host_span("serve.step"):
            return self._step(cache, tokens, pos)

    def _step(self, cache: Cache, tokens: torch.Tensor, pos
              ) -> Tuple[torch.Tensor, Cache]:
        with spans.host_span("step.check"):
            st = next((s for s in self._statics.values()
                       if s.cache is cache), None)
            copy_in = st is None
            if st is not None:
                self._check_tokens(tokens, st.tokens.shape[0])
            else:
                key = self._key(cache)
                self._check_tokens(tokens, key[0])
                st = self._statics.get(key)
                if st is None:
                    st = self._statics[key] = _Static(
                        [{k: torch.zeros_like(t) for k, t in cb.items()}
                         for cb in cache], self.device)
        timed = _layers()
        g = st.graphs.get(timed)
        if g is None:
            g = self._capture(st, timed)
        if copy_in:
            with spans.host_span("step.cache_copy_in"):
                for dst, src in zip(st.cache, cache):
                    for k, t in src.items():
                        dst[k].copy_(t)
        with spans.host_span("step.replay"):
            if isinstance(pos, torch.Tensor):
                st.pos.copy_(pos.reshape(()))
            else:
                st.pos.fill_(int(pos))
            if tokens is not st.last:
                st.tokens.copy_(tokens)
            with spans.device_span("decode.graph"):
                g.graph.replay()
            _launches.replayed(g.tally)
            spans.replayed(g.spans)
        st.last = g.next
        self.logits = g.logits
        return g.next, st.cache
