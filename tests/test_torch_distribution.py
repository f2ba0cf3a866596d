"""Distribution on the port against the JAX package, on the CPU: the
cases of ``tests/runtime/test_distribution.py`` run on ``repro_torch``.

* The sharding rules: for every arch (smoke), both profiles and the
  reference's fake 16x16 and 2x16x16 meshes, the port's specs for the
  parameters, the optimizer moments, a decode cache and a batch equal the
  reference's leaf for leaf, through ``convert``'s name mapping, with the
  reference's stacking axis dropped (each reference leaf is marked with
  its index, and ``convert`` carries the mark to the port's tensors).
* The int8 error-feedback all-reduce: the reference's ``shard_map`` on 4
  fake XLA devices and the port on 4 gloo ranks, the same ``(4, 64)``
  gradients from ``default_rng(0)``, 11 rounds of error feedback:
  ``g_hat`` and ``err`` equal bit for bit every round.
* Elastic restore: a train state laid out on a 2x2 mesh (4 ranks) is
  saved and restored onto a 4x2 mesh (8 ranks) and onto 1 rank; every
  leaf equals the state before the save bit for bit, and each local shard
  has the shape its placements give.
* The mini dry run: gemma2-9b smoke on a 4x4 fake mesh (16 ranks of
  PyTorch's fake process group in one subprocess), a train, a prefill and
  a decode step traced: FLOPs > 0; each partitioned step counts at most
  an eighth of the 1x1 step's FLOPs (the reference's XLA count falls
  12.4x for the train step, 9.8x for decode), its collectives over
  "model" include the row-parallel and vocab all-reduces, and the model's
  own tensors are released; every arch's partitioned train, prefill and
  decode cells trace to ``ok`` records; and the dry-run CLI writes an
  ``ok`` record for a full gemma2-9b decode cell on the 16x16 production
  mesh.
* The roofline's arithmetic: ``model_flops`` and ``roofline_terms`` equal
  the reference's for every arch and shape given the same constants, and
  the ring factors give the reference's wire bytes for every collective
  kind.

Multi-rank runs are CPU processes of one gloo group
(``tests/torch_dist.py``), each with a timeout.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(__file__))
from conftest import run_subprocess  # noqa: E402
from torch_dist import SRC, run_ranks  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.runtime.sharding import ShardingRules  # noqa: E402

ARCHS = ["recurrentgemma_9b", "rwkv6_1p6b", "gemma2_9b", "chatglm3_6b",
         "codeqwen1p5_7b", "deepseek_coder_33b", "mixtral_8x22b",
         "llama4_maverick_400b_a17b", "llama3p2_vision_11b",
         "whisper_large_v3"]


class FakeMesh:
    """The reference test's mesh stand-in: axis names and sizes only."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _stacked(path) -> bool:
    from repro.runtime.sharding import _key_str
    return any(_key_str(k) in ("scan", "layers") for k in path)


def _marked(tree):
    """Each leaf replaced by an int32 array of its shape holding the
    leaf's index; returns (marked tree, [(path, leaf)])."""
    import jax
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    marks = [np.full(leaf.shape, i, np.int32)
             for i, (_, leaf) in enumerate(flat)]
    return jax.tree_util.tree_unflatten(treedef, marks), flat


def _ref_specs(specs_tree, flat):
    import jax
    from jax.sharding import PartitionSpec as JP
    leaves = jax.tree_util.tree_leaves(
        specs_tree, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(flat)
    return leaves


def _want(ref_spec, path) -> tuple:
    """The reference's spec with its stacking axis dropped."""
    spec = tuple(ref_spec)
    return spec[1:] if _stacked(path) else spec


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_match_reference(arch, profile, mesh):
    """Params, opt state, a decode cache and a batch, leaf for leaf."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    from repro.runtime.sharding import ShardingRules as JaxRules
    shape, names = MESHES[mesh]
    cfg = get_config(arch, smoke=True)
    tcfg = torch_config(arch, smoke=True)
    jrules = JaxRules(cfg, FakeMesh(shape, names), profile)
    trules = ShardingRules(tcfg, FakeMesh(shape, names), profile)
    jm = JaxModel(cfg)

    # parameters and moments: the port's tensors carry the marks
    specs = jm.param_specs()
    marked, flat = _marked(specs)
    ported = convert.model_state_dict(marked, cfg)
    for which in ("param_pspecs", "opt_state_pspecs"):
        ref = _ref_specs(getattr(jrules, which)(specs), flat)
        got = getattr(trules, which)(ported)
        assert set(got) == set(ported)
        for name, t in ported.items():
            i = int(t.reshape(-1)[0]) if t.numel() else None
            assert i is not None, name
            want = _want(ref[i], flat[i][0])
            assert tuple(got[name]) == want, (which, name, got[name], want)
            assert len(got[name]) <= t.dim(), (name, got[name], t.shape)

    # a decode cache (batch 16: the dp axes divide it)
    cache = jm.init_cache(16, 64, abstract=True)
    cmarked, cflat = _marked(cache)
    tcache = convert.model_cache(cmarked, cfg)
    ref = _ref_specs(jrules.cache_pspecs(cache), cflat)
    got = trules.cache_pspecs(tcache)
    for n, (layer, specs_n) in enumerate(zip(tcache, got)):
        assert set(layer) == set(specs_n)
        for key, t in layer.items():
            i = int(t.reshape(-1)[0])
            want = _want(ref[i], cflat[i][0])
            assert tuple(specs_n[key]) == want, (n, key, specs_n[key], want)

    # a batch with a leading accum dim, the extras where the arch reads them
    batch = {"tokens": jax.ShapeDtypeStruct((2, 16, 32), jnp.int32),
             "labels": jax.ShapeDtypeStruct((2, 16, 32), jnp.int32)}
    if cfg.encoder is not None:
        batch["extras"] = {"frames": jax.ShapeDtypeStruct(
            (2, 16, cfg.encoder.n_frames, cfg.d_model), jnp.bfloat16)}
    if cfg.n_img_tokens:
        batch["extras"] = {"img": jax.ShapeDtypeStruct(
            (2, 16, cfg.n_img_tokens, cfg.d_model), jnp.bfloat16)}
    ref = jrules.batch_pspecs(batch)
    got = trules.batch_pspecs(jax.tree.map(
        lambda a: np.zeros(a.shape, np.int8), batch))
    assert jax.tree.map(tuple, got, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.map(tuple, ref, is_leaf=lambda x: isinstance(x, tuple))


def test_int8_cache_rules_match_reference():
    """The int8 KV cache's scales (``kscale``/``vscale``) too."""
    import dataclasses
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    from repro.runtime.sharding import ShardingRules as JaxRules
    cfg = dataclasses.replace(get_config("llama3p2_vision_11b", smoke=True),
                              kv_cache_dtype="int8")
    tcfg = dataclasses.replace(torch_config("llama3p2_vision_11b",
                                            smoke=True),
                               kv_cache_dtype="int8")
    shape, names = MESHES["16x16"]
    cache = JaxModel(cfg).init_cache(16, 64, abstract=True)
    cmarked, cflat = _marked(cache)
    tcache = convert.model_cache(cmarked, cfg)
    ref = _ref_specs(JaxRules(cfg, FakeMesh(shape, names)).cache_pspecs(
        cache), cflat)
    got = ShardingRules(tcfg, FakeMesh(shape, names)).cache_pspecs(tcache)
    keys = set()
    for layer, specs_n in zip(tcache, got):
        for key, t in layer.items():
            i = int(t.reshape(-1)[0])
            assert tuple(specs_n[key]) == _want(ref[i], cflat[i][0]), key
            keys.add(key)
    assert {"kscale", "vscale"} <= keys


# -- the int8 error-feedback all-reduce ------------------------------------------

_REF_COMPRESS = """
import jax, jax.numpy as jnp, numpy as np, json
from functools import partial
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.optim.grad_compression import make_compressed_allreduce
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
reduce_tree = make_compressed_allreduce(mesh, "data")
g_local = jnp.asarray(np.random.default_rng(0).standard_normal((4, 64)),
                      jnp.float32)
err = jnp.zeros((4, 64), jnp.float32)

@partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
         out_specs=(P("data"), P("data")))
def reduce_once(g, e):
    out, e2 = reduce_tree({"g": g}, {"g": e})
    return out["g"], e2["g"]

for _ in range(11):
    g_hat, err = reduce_once(g_local, err)
    print(json.dumps([np.asarray(g_hat).view(np.int32).tolist(),
                      np.asarray(err).view(np.int32).tolist()]))
"""

_PORT_COMPRESS = """
import json
import numpy as np
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import init_error_state, make_compressed_allreduce
mesh = make_mesh((4,), ("data",), device="cpu")
reduce_tree = make_compressed_allreduce(mesh, "data")
g_all = np.random.default_rng(0).standard_normal((4, 64))
g = torch.tensor(g_all[RANK:RANK + 1], dtype=torch.float32)
err = init_error_state({"g": g})
for _ in range(11):
    out, err = reduce_tree({"g": g}, err)
    assert out["g"].dtype == torch.float32
    print(json.dumps([out["g"].view(torch.int32).tolist(),
                      err["g"].view(torch.int32).tolist()]))
"""


def test_compressed_allreduce_matches_reference_bit_for_bit():
    ref = [json.loads(line) for line in run_subprocess(
        _REF_COMPRESS, devices=4, timeout=120).strip().splitlines()]
    outs = run_ranks(_PORT_COMPRESS, 4, timeout=120)
    assert len(ref) == 11
    for rank, out in enumerate(outs):
        rounds = [json.loads(line) for line in out.strip().splitlines()]
        assert len(rounds) == 11
        for i, (g_hat, err) in enumerate(rounds):
            assert g_hat[0] == ref[i][0][rank], (rank, i, "g_hat")
            assert err[0] == ref[i][1][rank], (rank, i, "err")
    # error feedback converges as the reference's test asserts
    exact = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32).mean(axis=0)
    hats = [np.array(r[0][0], np.int32).view(np.float32) for r in ref]
    first = float(np.abs(hats[0] - exact).max())
    drift = float(np.abs(np.mean(hats, axis=0) - exact).max())
    assert first < 0.05 and drift < first


# -- elastic restore -------------------------------------------------------------

_STATE = """
import json
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import reshard_state, state_shardings
from repro_torch.runtime.sharding import shard_view, tree_map
from repro_torch.train import init_train_state
cfg = get_config("chatglm3_6b", smoke=True)

def fresh():
    model = Model(cfg)
    state = init_train_state(model, AdamW(),
                             torch.Generator().manual_seed(1))
    # moments and counters that are not all zeros
    g = torch.Generator().manual_seed(2)
    for part in ("m", "v"):
        for t in state["opt"][part].values():
            t.copy_(torch.randn(t.shape, generator=g))
    state["opt"]["count"] = torch.tensor(7, dtype=torch.int32)
    state["step"] = torch.tensor(7, dtype=torch.int32)
    return tree_map(lambda t: t.detach().clone(), state)

def check(restored, want, shardings):
    bad, n = [], 0
    def one(got, w, s):
        nonlocal n
        n += 1
        full = got.full_tensor()
        if not (full.dtype == w.dtype and torch.equal(full, w)):
            bad.append("value")
        local = shard_view(w, s.mesh, s.placements)
        if tuple(got.to_local().shape) != tuple(local.shape) or \\
                not torch.equal(got.to_local(), local):
            bad.append("shard")
    tree_map(one, restored, want, shardings)
    return n, bad
"""


def test_elastic_restore_onto_other_meshes(tmp_path):
    ck = str(tmp_path / "ck")
    save = _STATE + f"""
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
state = fresh()
sh = state_shardings(cfg, mesh, state)
laid = reshard_state(state, sh)
assert isinstance(laid["params"]["embed"], DTensor)
n, bad = check(laid, state, sh)
CheckpointManager({ck!r}).save(laid, 1)
print(json.dumps({{"n": n, "bad": bad}}))
"""
    outs = run_ranks(save, 4, timeout=120)
    assert all(json.loads(o)["bad"] == [] for o in outs)
    leaves = 2 + 3 * len(_names_of_chatglm())     # params, m, v, 2 counters
    for shape, world in (((4, 2), 8), ((1, 1), 1)):
        restore = _STATE + f"""
mesh = make_mesh({shape!r}, ("data", "model"), device="cpu")
want = fresh()
sh = state_shardings(cfg, mesh, want)
restored, step = CheckpointManager({ck!r}).restore(like=want, shardings=sh)
n, bad = check(restored, want, sh)
# restore(like=) of a laid-out state keeps its layout
again, _ = CheckpointManager({ck!r}).restore(like=restored)
n2, bad2 = check(again, want, sh)
sharded = sum(any(p.is_shard() for p in x.placements) for x in
              restored["params"].values())
print(json.dumps({{"n": n, "bad": bad + bad2, "step": step,
                  "sharded": sharded}}))
"""
        outs = run_ranks(restore, world, timeout=120)
        recs = [json.loads(o) for o in outs]
        assert all(r["bad"] == [] and r["step"] == 1 for r in recs), recs
        assert recs[0]["n"] == leaves
        if world > 1:
            assert recs[0]["sharded"] > 0


def _names_of_chatglm():
    from repro_torch.models import Model
    m = Model(torch_config("chatglm3_6b", smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    return [k for k, _ in m.named_parameters()]


# -- the mini dry run --------------------------------------------------------------

_MINI_DRYRUN = """
import json
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_cell, start_fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ShapeSpec
start_fake_world(16)
mesh = make_mesh((4, 4), ("data", "model"), device="cpu")
cfg = get_config("gemma2_9b", smoke=True)
out = {}
for shape, accum in ((ShapeSpec("t", 32, 16, "train"), 2),
                     (ShapeSpec("p", 32, 8, "prefill"), 1),
                     (ShapeSpec("d", 64, 8, "decode"), 1)):
    rec = run_cell(cfg, shape, mesh, accum=accum, kv_chunk=16)
    out[shape.kind] = {k: rec[k] for k in (
        "flops_per_device", "bytes_accessed_per_device", "collectives",
        "collectives_by_axis", "memory", "compute_s", "memory_s",
        "collective_s", "bottleneck")}
one = make_mesh((1, 1), ("data", "model"), device="cpu")
out["train_1x1"] = run_cell(cfg, ShapeSpec("t", 32, 16, "train"), one,
                            accum=2, kv_chunk=16)["flops_per_device"]
for shape in (ShapeSpec("p", 32, 8, "prefill"),
              ShapeSpec("d", 64, 8, "decode")):
    out[shape.kind + "_1x1"] = run_cell(cfg, shape, one, accum=1,
                                        kv_chunk=16)["flops_per_device"]
print(json.dumps(out))
"""


def test_mini_dryrun_4x4_fake_mesh():
    import subprocess
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", _MINI_DRYRUN], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    for kind in ("train", "prefill", "decode"):
        rec = out[kind]
        assert rec["flops_per_device"] > 0, kind
        assert rec["bytes_accessed_per_device"] > 0, kind
        assert rec["memory"]["peak_estimate_bytes"] >= \
            rec["memory"]["state_bytes"] > 0
        assert rec["compute_s"] == rec["flops_per_device"] / 989e12
    train = out["train"]["collectives"]
    # the split K/V heads' gathers, the reductions
    assert train["all-gather"]["count"] > 0
    assert train["all-reduce"]["count"] > 0
    # partitioned: a 16th of the work a rank, at most an 8th counted
    assert out["train"]["flops_per_device"] <= out["train_1x1"] / 8
    # over "model": each microbatch's row-parallel sums (wo and w2 of 4
    # layers, forward and remat recompute) and vocab all-reduces (the
    # lookup; the CE's max, sum and label logit), 2 microbatches
    by_axis = out["train"]["collectives_by_axis"]
    assert by_axis["model"]["all-reduce"]["count"] >= 2 * (4 * 2 * 2 + 4)
    assert by_axis["data"]["all-reduce"]["count"] > 0   # the gradients
    # the serve cells partitioned too: a 16th of the work a rank (the
    # reference's XLA count falls 9.8x on its decode cell), their
    # row-parallel sums and vocab lookups over "model" (gemma2 smoke's 2
    # K/V heads at tp 4: the decode cache holds head_dim chunks, so its
    # partial scores are summed too)
    for kind in ("prefill", "decode"):
        assert out[kind]["flops_per_device"] <= out[kind + "_1x1"] / 8, kind
        model = out[kind]["collectives_by_axis"]["model"]
        assert model["all-reduce"]["count"] >= 2 * 4 + 1, kind
    # every cell releases the model's own tensors (its step reads the
    # state's shards only)
    for kind in ("train", "prefill", "decode"):
        assert out[kind]["memory"]["model_bytes"] == 0, kind
    # a decode cell's cache is one device's shard, a 16th at 4x4: whole,
    # 2 local (32 slots) and 2 full (64) layers' K and V of 8 rows, 2
    # heads of 16 bf16 dims
    cache = out["decode"]["memory"]["cache_bytes"]
    assert cache * 16 == 2 * (32 + 64) * 8 * 2 * 16 * 2 * 2, cache


_ALL_TRAIN_CELLS = """
import json
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.dryrun import run_cell, start_fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ShapeSpec
start_fake_world(16)
mesh = make_mesh((4, 4), ("data", "model"), device="cpu")
for arch in ARCH_IDS:
    try:
        rec = run_cell(get_config(arch, smoke=True),
                       ShapeSpec("t", 32, 16, "train"), mesh, accum=2,
                       kv_chunk=16)
        rec = {"status": "ok", "flops_per_device": rec["flops_per_device"],
               "collectives": rec["collectives"]}
    except Exception as e:      # the record says which arch failed how
        rec = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
    print(json.dumps({"arch": arch, **rec}), flush=True)
"""


@pytest.fixture(scope="module")
def all_train_cells():
    import subprocess
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", _ALL_TRAIN_CELLS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return {r["arch"]: r for r in map(json.loads,
                                      run.stdout.strip().splitlines())}


@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_train_cell_traces_for_every_arch(all_train_cells,
                                                      arch):
    """Each arch's smoke train cell, partitioned on a fake 4x4 mesh (its
    profile's rules), traces to an ``ok`` record with collectives."""
    rec = all_train_cells[arch]
    assert rec["status"] == "ok", rec
    assert rec["flops_per_device"] > 0 and rec["collectives"]


_ALL_SERVE_CELLS = """
import json
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.dryrun import run_cell, start_fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ShapeSpec
start_fake_world(16)
meshes = {n: make_mesh(m, ("data", "model"), device="cpu")
          for n, m in (("4x4", (4, 4)), ("1x1", (1, 1)))}
for arch in ARCH_IDS:
    out = {"arch": arch}
    for shape in (ShapeSpec("p", 32, 8, "prefill"),
                  ShapeSpec("d", 64, 8, "decode")):
        for name, mesh in meshes.items():
            try:
                rec = run_cell(get_config(arch, smoke=True), shape, mesh,
                               accum=1, kv_chunk=16)
                rec = {"status": "ok", "flops": rec["flops_per_device"],
                       "model": rec["collectives_by_axis"].get("model", {}),
                       "model_bytes": rec["memory"]["model_bytes"]}
            except Exception as e:      # the record says which cell failed
                rec = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
            out[f"{shape.kind}_{name}"] = rec
    print(json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def all_serve_cells():
    import subprocess
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", _ALL_SERVE_CELLS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return {r["arch"]: r for r in map(json.loads,
                                      run.stdout.strip().splitlines())}


@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_serve_cells_trace_for_every_arch(all_serve_cells,
                                                      arch):
    """Each arch's smoke prefill and decode cells, partitioned on a fake
    4x4 mesh (``tp`` rules: a head_dim-split cache wherever the K/V heads
    do not divide 4), trace to ``ok`` records with all-reduces over
    "model", the model's own tensors released, and at most an 8th of the
    1x1 cell's FLOPs a device (a 16th but for what the rules leave whole:
    the MoE router)."""
    rec = all_serve_cells[arch]
    for kind in ("prefill", "decode"):
        got, one = rec[f"{kind}_4x4"], rec[f"{kind}_1x1"]
        assert got["status"] == one["status"] == "ok", (kind, got, one)
        assert got["model"]["all-reduce"]["count"] > 0, kind
        assert got["model_bytes"] == one["model_bytes"] == 0, kind
        assert 0 < got["flops"] <= one["flops"] / 8, (kind, got, one)


def test_dryrun_cli_writes_an_ok_record(tmp_path):
    """A full gemma2-9b cell on the 16x16 production mesh (decode: one
    step traced, so it stays quick)."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-9b", "--shape", "decode_32k", "--out-dir", str(tmp_path),
         "--tag", "t"], env=env, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads((tmp_path / "gemma2_9b__decode_32k__16x16__t.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["flops_per_device"] > 0 and rec["bottleneck"] in (
        "compute", "memory", "collective")
    assert rec["memory_s"] == rec["bytes_accessed_per_device"] / 3.35e12
    assert "data-sheet" in rec["estimate"]
    assert "[OK]   gemma2_9b__decode_32k__16x16__t" in run.stdout


# -- the roofline's arithmetic -------------------------------------------------------

def test_roofline_arithmetic_matches_reference(monkeypatch):
    from repro.configs import get_config
    from repro.launch import roofline as jroof
    from repro.models import shapes_for
    from repro_torch.models import shapes_for as tshapes
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", jroof.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW", jroof.ICI_BW)
    for arch in ARCHS:
        cfg, tcfg = get_config(arch), torch_config(arch)
        assert [s.name for s in shapes_for(cfg)] == \
            [s.name for s in tshapes(tcfg)]
        for s, ts in zip(shapes_for(cfg), tshapes(tcfg)):
            for devices in (256, 512):
                assert roofline.model_flops(tcfg, ts, devices) == \
                    jroof.model_flops(cfg, s, devices), (arch, s.name)
    for args in ((1e15, 1e12, 1e9), (1.0, 5e13, 0.0), (0.0, 0.0, 7e10)):
        assert roofline.roofline_terms(*args) == jroof.roofline_terms(*args)
    # the ring factors, against the reference's parse of HLO lines
    for op, kind in (("all-reduce", "all-reduce"),
                     ("all-gather", "all-gather"),
                     ("reduce-scatter", "reduce-scatter"),
                     ("all-to-all", "all-to-all"),
                     ("collective-permute", "collective-permute")):
        for k in (2, 16):
            line = (f"%x = bf16[64,128]{{1,0}} {op}(bf16[64,128] %y), "
                    f"replica_groups=[4,{k}]<=[64]")
            want = jroof.parse_collectives(line)[kind]
            assert want["bytes"] == 64 * 128 * 2
            assert roofline.ring_wire_bytes(kind, want["bytes"], k) == \
                want["wire_bytes"], (op, k)
