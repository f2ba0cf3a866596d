"""Partitioned serving over a mesh (``serve/serve_step.py``,
``Model.prefill`` / ``decode_step`` with ``params=``/``part=``) on gloo
ranks, against the port's unsharded steps and the reference's
``make_prefill`` / ``make_serve_step``.

One world of 4 gloo ranks (``tests/torch_dist.py``) runs every case. Each
rank draws the case's model from one seed, runs the unsharded
``make_prefill`` of B prompts of P tokens and STEPS decode steps itself,
then lays the parameters out by ``param_pspecs``
(``runtime.sharding.lay_out_params``), releases the model's own tensors
(``Model.release_params``, so the steps read nothing but the shards) and
runs the partitioned ``make_prefill`` (the whole batch given, the rank's
rows taken by ``batch_pspecs``) and STEPS eager steps of
``make_serve_step`` on its rows and cache shard. Both runs are fed the
unsharded run's tokens (teacher forcing), so a flip cannot carry on. The
cases:

* 2x2 ``tp``: recurrentgemma-9b (the ``rglru_scan`` op's plain version on
  each rank's R columns; its one K/V head: the local-window ring holds
  each head_dim chunk), gemma2-9b (the tied embedding vocab-sharded, both
  softcaps: the attention softcap after the partial scores' sum), mixtral-
  8x22b (E = 4 expert-parallel at tp = 2; one dispatch group over both
  data ranks, its capacity the global batch's) and rwkv6-1.6b (the
  ``rwkv6_step`` op on each rank's heads, the token shifts' d_model
  columns);
* 1x4 ``tp``: chatglm3-6b (n_kv = 2 at tp = 4: every head's head_dim
  chunk in the cache) and gemma2-9b (the same, its attention softcap cut
  from 50 to 2 so that the softcap bends the smoke model's scores: it
  must come after the partial scores' sum);
* 2x2 ``tp``: whisper-large-v3 (the encoder over each rank's rows of the
  frames, split on d_model and gathered, the cross-attention K/V of the
  rank's heads in the cache, learned positions);
* 1x4 ``tp``: llama3.2-vision-11b with the int8 KV cache (each head
  quantized whole, then its head_dim chunk kept beside the head's
  scale; the image tokens' cross-attention K/V as head_dim chunks);
* 2x2 ``fsdp``: gemma2-9b widened to d_ff and vocab 16,384, so its FFN
  weights and embedding are sharded over "data" at rest and gathered
  where they are used;
* 2x2 with 3 rows (recurrentgemma-9b): the rows do not divide the data
  axis, so the rules leave the batch whole and each data rank serves all
  of it.

Bounds. Every parameter is cast to f32 (as ``tests/test_torch_partition
.py`` does), so the partitioned and unsharded runs differ only in the
order of f32 sums: a row-parallel product's partial sums over "model"
(at most 64 f32 terms a rank's part, a few ranks), the partial attention
scores over head_dim chunks, the LoRA and channel mixes' gathered
products. Each such sum is exact to ~2^-24 relative a term; a handful of
layers and norms amplify it, so the prefill's logits are held within
``SERVE_F32 = 2**-14`` of the largest unsharded logit (measured: at most
1.1e-6 of it). The caches hold bf16 K/V, conv states and token shifts:
an f32 value that moved by such a rounding may round to the
neighbouring bf16 value (one step, 2^-8 relative), and every later step
reads it. So each cache tensor of each rank is held, in relative L2 to
the matching slice of the unsharded cache, within ``SERVE_F32`` plus one
step of its type (bf16: 2^-8 of its largest element; int8: one unit of
the quantized values, whose f32 scales hold), over its norm (f32 states,
``h``, ``s`` and the int8 cache's scales, within ``SERVE_F32``), and a
decode step's logits within
``CACHE_ROUND = 2**-10`` of the largest: a flipped element's step, 2^-8,
reaches a logit through a softmax-weighted sum or a mix of at least four
terms. Measured: up to 1.9e-4 (mixtral, a flip in a V cache); the same
runs with every cache tensor in f32 stay within 3e-6. A next token must
equal the unsharded one wherever the unsharded top-2 gap exceeds twice
the step's logit bound.

The reference case (recurrentgemma-9b at 2x2, bf16 as the reference
serves): the reference's initial parameters through ``convert``, the
partitioned steps' logits within the zoo's bound for bf16 across XLA and
PyTorch on the CPU, ``0.05 * scale + 0.05`` (``tests/zoo_pairs.py``), and
the tokens equal where the reference's top-2 gap exceeds twice it.

A planted vocab tie across two "model" ranks (1x4) must go to the lower
global index, as ``torch.argmax`` and ``jnp.argmax`` break it.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(__file__))
from torch_dist import run_ranks  # noqa: E402

from repro_torch import convert  # noqa: E402

# name: (arch, mesh, profile, config fields replaced, batch)
CASES = {
    "recurrentgemma_9b": ("recurrentgemma_9b", (2, 2), "tp", {}, 4),
    "gemma2_9b": ("gemma2_9b", (2, 2), "tp", {}, 4),
    "mixtral_8x22b": ("mixtral_8x22b", (2, 2), "tp", {}, 4),
    "rwkv6_1p6b": ("rwkv6_1p6b", (2, 2), "tp", {}, 4),
    "chatglm3_6b": ("chatglm3_6b", (1, 4), "tp", {}, 4),
    "gemma2_9b_1x4": ("gemma2_9b", (1, 4), "tp", {"attn_softcap": 2.0}, 4),
    "whisper_large_v3": ("whisper_large_v3", (2, 2), "tp", {}, 4),
    "llama3p2_vision_11b_int8": ("llama3p2_vision_11b", (1, 4), "tp",
                                 {"kv_cache_dtype": "int8"}, 4),
    "gemma2_9b_fsdp": ("gemma2_9b", (2, 2), "fsdp",
                       {"d_ff": 16384, "vocab": 16384}, 4),
    "recurrentgemma_9b_rows3": ("recurrentgemma_9b", (2, 2), "tp", {}, 3),
}
REF_CASE = "recurrentgemma_9b"
P, STEPS, CACHE_LEN = 20, 4, 24     # the ring (window 16) wraps
SERVE_F32 = 2.0 ** -14
CACHE_ROUND = 2.0 ** -10
BF16_STEP = 2.0 ** -8

_RANKS = r"""
import dataclasses
import json
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.runtime.partition import NO_PARTITION, Partition
from torch.distributed.tensor import Shard
from repro_torch.runtime.sharding import ShardingRules, lay_out_params
from repro_torch.serve import make_prefill, make_serve_step


def shard(t, shape, coord, spec):
    for axis, size, c in (("data", shape[0], coord[0]),
                          ("model", shape[1], coord[1])):
        for d, e in enumerate(spec):
            if e == axis or (isinstance(e, tuple) and axis in e):
                t = t.chunk(size, d)[c]
    return t


def draw(cfg, state=None):
    model = Model(cfg, kv_chunk=8).init(torch.Generator().manual_seed(5),
                                        "cpu")
    if state is not None:
        model.load_state_dict(state)
        return model
    for name, p in model.named_parameters():    # f32: the sums' order only
        p.data = p.data.float()
        if name.endswith(".gate"):          # drawn 0: tanh(0) hides it
            p.data.fill_(0.5)
    return model


def extras_for(cfg, B):
    n = cfg.encoder.n_frames if cfg.encoder is not None else \
        cfg.n_img_tokens
    if not n:
        return None
    g = torch.Generator().manual_seed(3)
    key = "frames" if cfg.encoder is not None else "img"
    return {key: torch.randn((B, n, cfg.d_model), generator=g) * 0.1}


def serve(model, prompt, extras, toks=None, params=None,
          part=NO_PARTITION):
    # make_prefill and STEPS steps, fed toks (None: the argmax of the
    # logits before); the logits gathered whole over "model"
    prefill = make_prefill(model, CACHE_LEN, params, part)
    step = make_serve_step(model, params, part)
    last, cache = prefill(prompt, extras)
    caches = [cache]
    logits, nexts, fed = [last], [], []
    tok = torch.argmax(last, -1).to(torch.int32)[:, None]
    for i in range(STEPS):
        tok = tok if toks is None else toks[i]
        fed.append(tok)
        lg, _ = model.decode_step(cache, tok, P + i, params, part)
        logits.append(lg[:, 0] if lg.shape[-1] == model.cfg.vocab
                      else part.gather(lg[:, 0]))
        tok, cache = step(cache, tok, P + i)
        nexts.append(tok)
    caches.append(cache)
    return logits, nexts, caches, fed


out = {}
for name, (arch, shape, profile, repl, B) in CASES.items():
    cfg = dataclasses.replace(get_config(arch, smoke=True), **repl)
    g = torch.Generator().manual_seed(9)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=g)
    ref = None
    if name == REF_CASE:
        ref = torch.load(f"{DIR}/ref.pt")
        prompt = ref["prompt"]
    model = draw(cfg, None if ref is None else ref["state"])
    extras = extras_for(cfg, B)
    if ref is None:                 # the unsharded run gives the tokens
        want_logits, want_next, want_caches, toks = serve(model, prompt,
                                                          extras)
    else:
        toks = ref["toks"]
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    rules = ShardingRules(cfg, mesh, profile)
    params, placements = lay_out_params(
        cfg, mesh, dict(model.named_parameters()), profile)
    model.release_params()          # the steps read the shards only
    rows_split = rules._dp_if(B) is not None
    part = Partition(mesh, placements, rows_split)
    coord = mesh.get_coordinate()
    rows = slice(None)
    if rows_split:
        b = B // shape[0]
        rows = slice(coord[0] * b, (coord[0] + 1) * b)
    got_logits, got_next, got_caches, _ = serve(
        model, prompt, extras, [t[rows] for t in toks], params, part)
    rec = {"fsdp": sum(isinstance(pl[0], Shard)
                       for pl in placements.values()),
           "shapes_ok": True, "rows": [int(x) for x in
                                       torch.arange(B)[rows]]}
    if ref is not None:
        rec["logits"] = [t.float().tolist() for t in got_logits]
        rec["next"] = [t.tolist() for t in got_next]
        out[name] = rec
        continue
    rec["logit_errs"] = [float((g_ - w[rows]).abs().max())
                         for g_, w in zip(got_logits, want_logits)]
    rec["logit_scale"] = max(float(w.abs().max()) for w in want_logits)
    # each step's unsharded top-2 gap and whether the tokens agree
    rec["tokens"] = []
    for w, gn, wn in zip(want_logits[1:], got_next, want_next):
        top2 = torch.topk(w[rows], 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).tolist()
        rec["tokens"].append([[float(a), int(x), int(y)] for a, x, y in
                              zip(gap, gn[:, 0], wn[rows][:, 0])])
    rec["cache"] = []
    specs = rules.cache_pspecs(want_caches[0])
    init = model.init_cache(B, CACHE_LEN, part)
    for when, (gc, wc) in enumerate(zip(got_caches, want_caches)):
        for n, (gl, wl) in enumerate(zip(gc, wc)):
            for key, w in wl.items():
                w = shard(w, shape, coord, specs[n][key])
                gt = gl[key]
                ok = (gt.shape == w.shape == init[n][key].shape and
                      gt.dtype == w.dtype)
                rec["shapes_ok"] = rec["shapes_ok"] and ok
                wf, gf = w.float(), gt.float()
                rec["cache"].append([
                    when, n, key, str(w.dtype), float((gf - wf).norm()),
                    float(wf.norm()), float(wf.abs().max())])
    out[name] = rec

# the planted vocab tie on the 1x4 mesh: every rank holds 4 of 16 columns
mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
part = Partition(mesh)
whole = torch.zeros((3, 16))
whole[0, 6] = whole[0, 13] = 5.0        # ranks 1 and 3: global 6 wins
whole[1, 1] = whole[1, 2] = 2.0         # within rank 0: 1
whole[2, 9] = whole[2, 10] = 1.0        # rank 2 ties below rank 3's max
whole[2, 15] = 3.0
mine = whole.chunk(4, -1)[mesh.get_coordinate()[1]]
out["tie"] = {"got": part.tp_argmax(mine, 16).tolist(),
              "want": torch.argmax(whole, -1).tolist()}
with open(f"{DIR}/rank{RANK}.json", "w") as f:
    json.dump(out, f)
print("done")
"""


def _reference_run():
    """The reference's unsharded ``make_prefill`` / ``make_serve_step`` on
    REF_CASE (bf16), and the converted state for the ranks."""
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    from repro.serve.serve_step import make_prefill, make_serve_step
    arch, _, _, _, B = CASES[REF_CASE]
    cfg = get_config(arch, smoke=True)
    jm = JaxModel(cfg, kv_chunk=8)
    key = jax.random.PRNGKey(11)
    params = jm.init(key)
    prompt = np.array(jax.random.randint(jax.random.fold_in(key, 1),
                                         (B, P), 0, cfg.vocab))
    last, cache = jax.jit(make_prefill(jm, CACHE_LEN))(params,
                                                      jnp.asarray(prompt))
    step = jax.jit(make_serve_step(jm))
    decode = jax.jit(jm.decode_step)
    logits, toks = [np.asarray(last, np.float32)], []
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    for i in range(STEPS):
        toks.append(np.asarray(tok))
        lg, _ = decode(params, cache, tok, jnp.int32(P + i))
        logits.append(np.asarray(lg[:, 0], np.float32))
        tok, cache = step(params, cache, tok, jnp.int32(P + i))
    state = convert.model_state_dict(jax.tree.map(np.asarray, params), cfg)
    return {"prompt": torch.from_numpy(prompt).long(), "state": state,
            "toks": [torch.from_numpy(np.array(t)) for t in toks]}, logits


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_partition")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        saved, ref_logits = _reference_run()
    finally:
        torch.set_num_threads(threads)
    torch.save(saved, d / "ref.pt")
    code = (f"CASES = {CASES!r}; DIR = {str(d)!r}; P = {P}; "
            f"STEPS = {STEPS}; CACHE_LEN = {CACHE_LEN}; "
            f"REF_CASE = {REF_CASE!r}\n" + _RANKS)
    run_ranks(code, 4, timeout=240)
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(4)]
    return {"ranks": ranks, "ref_logits": ref_logits}


_F32 = [n for n in CASES if n != REF_CASE]


@pytest.mark.parametrize("name", _F32)
def test_partitioned_logits_match_unsharded(world, name):
    """Prefill's last-token logits, every rank's rows, within SERVE_F32 of
    the largest unsharded logit, each step's within CACHE_ROUND; every
    cache shape is ``init_cache(part=)``'s and the slice's of the
    unsharded cache."""
    for rank, out in enumerate(world["ranks"]):
        rec = out[name]
        assert rec["shapes_ok"], (name, rank)
        scale = rec["logit_scale"]
        first, *steps = rec["logit_errs"]
        assert first <= SERVE_F32 * scale, (name, rank, first, scale)
        assert max(steps) <= CACHE_ROUND * scale, (name, rank, steps, scale)


@pytest.mark.parametrize("name", _F32)
def test_partitioned_tokens_match_where_the_gap_allows(world, name):
    """The vocab-parallel argmax gives the unsharded token wherever the
    unsharded top-2 gap exceeds twice the step's logit bound."""
    for rank, out in enumerate(world["ranks"]):
        rec = out[name]
        tol = CACHE_ROUND * rec["logit_scale"]
        held = 0
        for step in rec["tokens"]:
            for gap, got, want in step:
                if gap > 2 * tol:
                    assert got == want, (name, rank, gap, got, want)
                    held += 1
        assert held > 0, (name, rank)


@pytest.mark.parametrize("name", _F32)
def test_partitioned_cache_shards_match_unsharded_slices(world, name):
    """After prefill and after the last step: each rank's cache shard
    against the matching slice (``cache_pspecs``) of the unsharded cache,
    in relative L2: SERVE_F32, plus one step of its type for a bf16 or
    int8 tensor (a rounding that went the other way)."""
    for rank, out in enumerate(world["ranks"]):
        for when, n, key, dtype, err, norm, amax in out[name]["cache"]:
            tol = SERVE_F32 * norm + {"torch.bfloat16": BF16_STEP * amax,
                                      "torch.int8": 1.0}.get(dtype, 0.0)
            assert err <= tol, (name, rank, when, n, key, err, norm)


def test_partitioned_serving_matches_the_reference(world):
    """recurrentgemma-9b on 2x2 in bf16 against the reference's unsharded
    ``make_prefill`` / ``make_serve_step`` from the same parameters: the
    logits within the zoo's bound, the tokens where the gap allows."""
    want = world["ref_logits"]
    scale = max(float(np.abs(w).max()) for w in want)
    tol = 0.05 * scale + 0.05
    B = CASES[REF_CASE][4]
    seen = set()
    for out in world["ranks"]:
        rec = out[REF_CASE]
        rows = rec["rows"]
        seen.update(rows)
        for got, w in zip(rec["logits"], want):
            err = float(np.abs(np.asarray(got) - w[rows]).max())
            assert err <= tol, (err, tol)
        for i, nxt in enumerate(rec["next"]):
            w = want[i + 1][rows]
            top2 = np.sort(w, -1)[:, -2:]
            for r, (gap, got) in enumerate(zip(top2[:, 1] - top2[:, 0],
                                               nxt)):
                if gap > 2 * tol:
                    assert got[0] == int(np.argmax(w[r])), (i, r)
    assert seen == set(range(B))


def test_fsdp_case_shards_parameters_over_data(world):
    """The fsdp case's parameters are sharded over "data" at rest, the
    tp cases' are not."""
    for name, (_, _, profile, _, _) in CASES.items():
        n = world["ranks"][0][name]["fsdp"]
        assert (n > 0) == (profile == "fsdp"), (name, n)


def test_rows_that_do_not_divide_stay_whole(world):
    """3 rows on 2 data ranks: every rank serves all three."""
    for out in world["ranks"]:
        assert out["recurrentgemma_9b_rows3"]["rows"] == [0, 1, 2]
    for out in world["ranks"]:
        assert out["recurrentgemma_9b"]["rows"] in ([0, 1], [2, 3])


def test_vocab_tie_across_ranks_breaks_to_the_lower_index(world):
    """A max held by ranks 1 and 3 of "model" goes to rank 1's index, as
    ``torch.argmax`` of the whole row gives it."""
    for out in world["ranks"]:
        assert out["tie"]["got"] == out["tie"]["want"] == [6, 1, 15]
