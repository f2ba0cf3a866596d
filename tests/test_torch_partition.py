"""The partitioned train step over a mesh (``runtime/partition.py``,
``train/train_step.py``) on gloo ranks, against the port's unsharded step
and the reference's ``make_train_step``.

Each case starts from the reference's initial train state (its gates at
0.5), converted (``convert.train_state``), and one seeded batch a step
(``DataPipeline``, 8 rows of 16 tokens in 2 microbatches; seeded
``frames``/``img`` where the arch reads them). The cases:

* 2x2 ``tp``: recurrentgemma-9b (the ``rglru_scan`` op's plain version on
  each rank's R columns; its one K/V head split over "model"), gemma2-9b
  (the tied embedding vocab-sharded, both softcaps, local attention),
  mixtral-8x22b (E = 4: expert-parallel at tp = 2; one dispatch group
  over both data ranks), whisper-large-v3 (frames over the data axis,
  the encoder, cross-attention) and rwkv6-1.6b (the LoRA mixes across
  "model", the time mix on local heads, the channel mix's ``kk``
  gathered, the row-parallel ``wo``);
* 1x4 ``tp``: chatglm3-6b (n_kv = 2 at tp = 4: K/V heads split, each
  rank's query head reading its GQA group);
* 2x2 ``fsdp``: gemma2-9b widened to d_ff 16,384 and vocab 16,384, so its
  FFN weights and embedding reach the rules' 2^20 elements and are
  sharded over "data" at rest, gathered a remat region at a time.

One world of 4 gloo ranks (``tests/torch_dist.py``) runs every case,
each rank's model released (``Model.release_params``) once the state is
laid out, so its step reads nothing but the shards; the checks read what
it saved. What each case holds, and why the bounds are
what they are:

* **f32** (every parameter cast to f32, so the arithmetic is exact up to
  f32 rounding): one step's losses within ``2**-16`` relative of the
  unsharded step's, and each rank's f32 gradient accumulator within
  ``2**-12`` relative (L2, tensor by tensor) of its shard of the
  unsharded step's. What differs is only the order of the sums: the CE
  and MoE statistics summed over the data ranks, the row-parallel
  products' partial sums over "model", the gradients' reduce-scatters.
  Each is a sum of at most ~2^11 f32 terms (2^-24 each), so ``2**-12``
  holds them with room for the few layers they pass through. A gradient
  that is 0 in exact arithmetic is rounding noise of the terms it sums
  (a K bias on the dims RoPE leaves alone: the softmax drops the shift
  it adds), so each tensor's error may also reach ``2**-20`` of the
  largest accumulator's norm. These are the check on the gradients'
  values: AdamW's update is nearly blind to a gradient's scale, so a
  gradient off by a factor (a collective's backward summing where it
  should not) would pass the parameter checks below.
* **bf16** (as the reference trains): two steps' losses within ``5e-4``
  relative of the unsharded step's and of the reference's. bf16
  activations round each partial product and a rank's gradient of its
  rows rounds to bf16 before the f32 sum (steps of ``2**-8``), which
  moves the loss by a few 1e-5; a near-tie MoE routing decision can flip
  with such a step, and moves mixtral's loss by 3.5e-4 (the port's
  unsharded step and the reference's differ by as much); rwkv6's second
  loss moves by 3.3e-4 (two thirds of its bf16 parameters differ after
  the first step, in the unsharded step against the reference's too).
  Every parameter
  after them is within one AdamW update's reach of the unsharded step's
  and the reference's: Adam's first steps are close to ``lr * sign(g)``,
  so a gradient near 0 may flip, which moves an element by at most ``2 *
  lr`` a step (``lr_1 + lr_2`` summed over the two steps, times 2, plus
  1% for Adam's ``m / sqrt(v)`` past 1), and the bf16 cast by one step
  of its value. After the second step a bf16 parameter lies within its
  update's difference of a rounding boundary on 10-30% of the elements
  (two thirds in rwkv6; the second update depends on ``g_2 / g_1``), in
  the port's unsharded
  step against the reference's as much: the partitioned step differs
  from the reference's in at most 3% more of the elements than the
  unsharded step does.
* **FLOPs**: each rank's ``FlopCounterMode`` count of a step (its
  microbatches: AdamW does no counted operation) at most 0.35 of the
  unsharded step's on 2x2, a quarter plus what the rules leave whole
  (the router, K/V heads that do not divide).
"""
import contextlib
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(__file__))
from torch_dist import (F32_ACCUM_FLOOR, PARTITION_LOSS,  # noqa: E402
                        accum_close, accumulators, run_ranks,
                        within_adam_reach)

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW, cosine_warmup  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

# name: (arch, mesh, profile, config fields replaced)
CASES = {
    "recurrentgemma_9b": ("recurrentgemma_9b", (2, 2), "tp", {}),
    "gemma2_9b": ("gemma2_9b", (2, 2), "tp", {}),
    "mixtral_8x22b": ("mixtral_8x22b", (2, 2), "tp", {}),
    "whisper_large_v3": ("whisper_large_v3", (2, 2), "tp", {}),
    "rwkv6_1p6b": ("rwkv6_1p6b", (2, 2), "tp", {}),
    "chatglm3_6b": ("chatglm3_6b", (1, 4), "tp", {}),
    "gemma2_9b_fsdp": ("gemma2_9b", (2, 2), "fsdp",
                       {"d_ff": 16384, "vocab": 16384}),
}
STEPS, ACCUM, BATCH, SEQ = 2, 2, 8, 16
LR = (3e-3, 3, 20)                  # cosine_warmup(peak, warmup, total)
F32_LOSS = 2.0 ** -16
BF16_MORE = 0.03
FLOP_SHARE = 0.35


def _cfgs(name):
    from repro.configs import get_config
    arch, _, _, repl = CASES[name]
    return (dataclasses.replace(get_config(arch, smoke=True), **repl),
            dataclasses.replace(torch_config(arch, smoke=True), **repl))


def _batches(cfg):
    """STEPS batches (accum, rows, seq), numpy; extras drawn per step."""
    from repro.data import DataPipeline
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                        seed=2)
    rng = np.random.default_rng(7)
    out = []
    for step in range(STEPS):
        b = {k: v.reshape(ACCUM, BATCH // ACCUM, SEQ)
             for k, v in pipe.batch_for(step).items()}
        width = cfg.encoder.n_frames if cfg.encoder is not None \
            else cfg.n_img_tokens
        if width:
            key = "frames" if cfg.encoder is not None else "img"
            b["extras"] = {key: (rng.standard_normal(
                (ACCUM, BATCH // ACCUM, width, cfg.d_model)) * 0.1
            ).astype(np.float32)}
        out.append(b)
    return out


def _torch_batch(b, dtype):
    out = {k: torch.from_numpy(b[k]) for k in ("tokens", "labels")}
    if "extras" in b:
        out["extras"] = {k: torch.from_numpy(v).to(dtype)
                         for k, v in b["extras"].items()}
    return out


def _reference(name):
    """The reference's initial state (numpy) and its STEPS steps: the
    losses and the parameters after them (port names)."""
    import jax.numpy as jnp
    from repro.models import Model as JaxModel
    from repro.optim import AdamW as JaxAdamW
    from repro.optim import cosine_warmup as jax_cosine
    from repro.train import init_train_state as jax_init
    from repro.train import make_train_step as jax_step
    from zoo_pairs import with_gates
    cfg, _ = _cfgs(name)
    jm = JaxModel(cfg, kv_chunk=8)
    jopt = JaxAdamW(lr=jax_cosine(*LR), weight_decay=0.01)
    state = jax_init(jm, jopt, jax.random.PRNGKey(4))
    state["params"] = with_gates(state["params"], 0.5)
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jax_step(jm, jopt))
    losses = []
    for b in _batches(cfg):
        jb = {k: jnp.asarray(b[k]) for k in ("tokens", "labels")}
        if "extras" in b:
            jb["extras"] = {k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in b["extras"].items()}
        state, m = step(state, jb)
        losses.append(float(m["loss"]))
    params = convert.model_state_dict(
        jax.tree.map(np.asarray, state["params"]), cfg)
    return init, losses, params


def _as(state, dtype):
    """A copy of the state, its bf16 parameters in ``dtype``."""
    from repro_torch.runtime.sharding import tree_map
    out = tree_map(lambda t: t.clone(), state)
    out["params"] = {k: p.to(dtype) if p.dtype == torch.bfloat16 else p
                     for k, p in out["params"].items()}
    return out


def _unsharded(name, state, batches):
    """The port's unsharded step: bf16 losses and parameters after STEPS
    steps; f32 one step's losses, accumulators and FLOPs (counted in the
    f32 step only: the count depends on shapes, not dtypes)."""
    from torch.utils.flop_counter import FlopCounterMode
    _, tcfg = _cfgs(name)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = Model(tcfg, kv_chunk=8).init(
            torch.Generator().manual_seed(0), device="cpu")
        opt = AdamW(lr=cosine_warmup(*LR), weight_decay=0.01)
        step = make_train_step(model, opt)
        st = _as(state, dtype)
        if dtype == torch.float32:
            for p in model.parameters():
                if p.dtype == torch.bfloat16:
                    p.data = p.data.float()
        losses, flops = [], FlopCounterMode(display=False)
        f32 = dtype == torch.float32
        with accumulators() as accs:
            for b in batches[:1 if f32 else STEPS]:
                with flops if f32 else contextlib.nullcontext():
                    st, m = step(st, _torch_batch(b, dtype))
                losses.append(float(m["loss"]))
        out[str(dtype)] = dict(
            losses=losses, accum=accs[0], flops=flops.get_total_flops(),
            params={k: v.detach().clone() for k, v in st["params"].items()})
    return out


_RANKS = """
import contextlib
import dataclasses
import sys
sys.path.insert(0, TESTS)
from torch_dist import accumulators
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_warmup
from repro_torch.runtime.elastic import reshard_state, state_shardings
from repro_torch.runtime.sharding import ShardingRules
from repro_torch.train import make_train_step
out = {}
for name, (arch, shape, profile, repl) in CASES.items():
    cfg = dataclasses.replace(get_config(arch, smoke=True), **repl)
    saved = torch.load(f"{DIR}/{name}.in.pt")
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    rules = ShardingRules(cfg, mesh, profile)
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = Model(cfg, kv_chunk=8).init(
            torch.Generator().manual_seed(0), device="cpu")
        opt = AdamW(lr=cosine_warmup(*LR), weight_decay=0.01)
        st = saved[str(dtype)]
        st = reshard_state(st, state_shardings(cfg, mesh, st, profile))
        model.release_params()      # the step reads the shards only
        step = make_train_step(
            model, opt, grad_pspecs=rules.opt_state_pspecs(st["params"]))
        losses, flops = [], FlopCounterMode(display=False)
        f32 = dtype == torch.float32
        with accumulators() as accs:
            for b in saved["batches"][str(dtype)][:1 if f32 else STEPS]:
                with flops if f32 else contextlib.nullcontext():
                    st, m = step(st, b)
                losses.append(float(m["loss"]))
        whole = {k: v.full_tensor() for k, v in st["params"].items()}
        rec[str(dtype)] = dict(
            losses=losses, accum=accs[0], flops=flops.get_total_flops(),
            fsdp=sum(any(p.is_shard() for i, p in enumerate(v.placements)
                         if mesh.mesh_dim_names[i] == "data")
                     for v in st["params"].values()),
            params=whole if RANK == 0 else None)
    torch.save(rec, f"{DIR}/{name}.rank{RANK}.pt")
print("done")
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case: the reference's steps, the port's unsharded steps (in
    this process) and the partitioned steps (4 gloo ranks, one world)."""
    d = tmp_path_factory.mktemp("partition")
    cases = {}
    # one intra-op thread: the models are tiny, and beside other test
    # workers a pool of spinning threads slows them 50x
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _fill(cases, d)
    finally:
        torch.set_num_threads(threads)
    code = (f"CASES = {CASES!r}; DIR = {str(d)!r}; STEPS = {STEPS}; "
            f"LR = {LR!r}; TESTS = {os.path.dirname(__file__)!r}\n"
            + _RANKS)
    run_ranks(code, 4, timeout=240)
    for name in CASES:
        cases[name]["ranks"] = [torch.load(d / f"{name}.rank{r}.pt")
                                for r in range(4)]
    return cases


def _fill(cases, d):
    """The reference's and the unsharded steps of every case; the
    partitioned steps' inputs saved under ``d``."""
    for name in CASES:
        cfg, _ = _cfgs(name)
        init, ref_losses, ref_params = _reference(name)
        batches = _batches(cfg)
        state = convert.train_state(init, cfg)
        unsharded = _unsharded(name, state, batches)
        torch.save({str(dt): _as(state, dt) for dt in (torch.bfloat16,
                                                        torch.float32)}
                   | {"batches": {str(dt): [_torch_batch(b, dt)
                                            for b in batches]
                                  for dt in (torch.bfloat16,
                                             torch.float32)}},
                   d / f"{name}.in.pt")
        cases[name] = dict(ref_losses=ref_losses, ref_params=ref_params,
                           unsharded=unsharded)


def _mesh_shard(t, shape, rank, spec):
    """Rank ``rank``'s shard of ``t`` under ``spec`` on a ("data",
    "model") mesh of ``shape`` (row-major ranks), as ``shard_view``."""
    coord = (rank // shape[1], rank % shape[1])
    for axis, size, c in (("data", shape[0], coord[0]),
                          ("model", shape[1], coord[1])):
        for d, e in enumerate(spec):
            if e == axis or (isinstance(e, tuple) and axis in e):
                t = t.chunk(size, d)[c]
    return t


@pytest.mark.parametrize("name", list(CASES))
def test_partitioned_step_in_f32_matches_unsharded(world, name):
    """One f32 step: the losses on every rank, and each rank's
    accumulator against its shard of the unsharded step's."""
    from repro_torch.runtime.sharding import ShardingRules
    case = world[name]
    _, shape, profile, _ = CASES[name]
    want = case["unsharded"][str(torch.float32)]
    _, tcfg = _cfgs(name)
    specs = ShardingRules(tcfg, _FakeMesh(shape)).opt_state_pspecs(
        want["accum"])
    floor = F32_ACCUM_FLOOR * max(float(t.norm())
                                  for t in want["accum"].values())
    for rank, rec in enumerate(case["ranks"]):
        got = rec[str(torch.float32)]
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= F32_LOSS * abs(b), (rank, got["losses"],
                                                     want["losses"])
        accum_close(got["accum"], {
            k: _mesh_shard(w, shape, rank, specs[k])
            for k, w in want["accum"].items()}, floor, rank)


@pytest.mark.parametrize("name", list(CASES))
def test_partitioned_step_in_bf16_matches_unsharded_and_reference(world,
                                                                 name):
    """Two bf16 steps: losses and parameters against the port's unsharded
    step and the reference's; every rank reports the same losses."""
    case = world[name]
    want = case["unsharded"][str(torch.bfloat16)]
    got = [rec[str(torch.bfloat16)] for rec in case["ranks"]]
    assert all(g["losses"] == got[0]["losses"] for g in got)
    for other in (want["losses"], case["ref_losses"]):
        for a, b in zip(got[0]["losses"], other):
            assert abs(a - b) <= PARTITION_LOSS * abs(b), (
                got[0]["losses"], other)
    lr = cosine_warmup(*LR)
    within_adam_reach(got[0]["params"], want["params"], lr, STEPS,
                      "unsharded")
    share = within_adam_reach(got[0]["params"], case["ref_params"], lr,
                              STEPS, "reference")
    base = within_adam_reach(want["params"], case["ref_params"], lr, STEPS,
                             "unsharded against the reference")
    assert share <= base + BF16_MORE, (share, base)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][1] == (2, 2)])
def test_partitioned_step_counts_a_quarter_of_the_flops(world, name):
    """On 2x2 each rank counts at most FLOP_SHARE of the unsharded step's
    FLOPs."""
    case = world[name]
    whole = case["unsharded"][str(torch.float32)]["flops"]
    assert whole > 0
    for rec in case["ranks"]:
        share = rec[str(torch.float32)]["flops"] / whole
        assert 0 < share <= FLOP_SHARE, (name, share)


def test_fsdp_case_shards_parameters_over_data(world):
    """The fsdp case has parameters sharded over "data" at rest (so its
    remat regions gather them), the tp cases none."""
    for name, (_, _, profile, _) in CASES.items():
        n = world[name]["ranks"][0][str(torch.float32)]["fsdp"]
        assert (n > 0) == (profile == "fsdp"), (name, n)


class _FakeMesh:
    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
