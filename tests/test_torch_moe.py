"""The MoE dispatch: the port's ``moe_forward`` and ``_positions_in_expert``
against the JAX package's, on the same seeded inputs.

Cases: top-1 with sigmoid weights and the shared expert (llama4's form),
top-2 with softmax weights (mixtral's), two dispatch groups, a router
skewed towards one expert at capacity factor 1.25 (tokens must drop, and
the test asserts that they do), planted exact ties among the router
logits, and the Switch aux loss; gradients against ``jax.grad``.

Tolerances, in units of the reference's own scale:

* ``_positions_in_expert``: equal (integer ranks from one stable sort);
* f32 outputs: within ``1e-5 * max|out|`` (the same f32 products summed in
  another order); the aux loss within ``1e-6`` relative;
* bf16 outputs: within ``2^-6 * max|out|``, four bf16 steps at the largest
  value (the expert products round at other places in the two
  frameworks); the aux loss within ``1e-5`` relative (f32 softmax of the
  same bf16-rounded logits);
* the planted ties: the logits are exact sums of small dyadic products,
  so both frameworks see the same ties and must break them alike (the
  lower expert index first, as ``jax.lax.top_k`` does): within ``1e-6 *
  max|out|``;
* f32 gradients of ``sum(out * g) + aux`` with respect to the input, the
  router, the experts and the shared expert: within ``1e-4 * max|grad|``
  a tensor.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.models import components as jc
from repro.models.config import MoeSpec as JMoe
from repro_torch.models import components as tc
from repro_torch.models.config import MoeSpec as TMoe

B, S, D, F = 2, 12, 32, 48


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed: int, E: int, shared: bool, skew: float = 0.0):
    """x, router, w1, w3, w2 (and s1, s3, s2) as f32 numpy arrays with the
    reference's init scales; ``skew`` is added to expert 0's router column
    against the mean input, so most tokens pick it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * 0.3).astype(np.float32)
    router[:, 0] += skew * np.sign(x.mean(axis=(0, 1)))
    w1, w3 = ((rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
              for _ in range(2))
    w2 = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    out = [x, router, w1, w3, w2]
    if shared:
        out += [(rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32),
                (rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32),
                (rng.standard_normal((F, D)) / np.sqrt(F)).astype(np.float32)]
    return out


def _run_both(arrays, moe: dict, groups: int, dtype: str):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    J = [jnp.asarray(a, jdt) for a in arrays]
    T = [torch.from_numpy(a).to(tdt) for a in arrays]
    jshared = tuple(J[5:]) if len(J) > 5 else None
    tshared = tuple(T[5:]) if len(T) > 5 else None
    want, waux = jc.moe_forward(*J[:5], JMoe(**moe), jshared, groups=groups)
    got, gaux = tc.moe_forward(*T[:5], TMoe(**moe), tshared, groups=groups)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    assert gaux.dtype == torch.float32 and gaux.dim() == 0
    return _np(want), float(waux), _np(got), float(gaux)


def _dropped(arrays, moe: dict, groups: int, dtype: str) -> int:
    """Routed (token, k) pairs over capacity, by the reference's own
    routing and ranks."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x, router = (jnp.asarray(a, jdt) for a in arrays[:2])
    E, k = moe["num_experts"], moe["top_k"]
    logits = (x.reshape(B * S, D) @ router).astype(jnp.float32)
    _, idx = jax.lax.top_k(logits, k)
    G = groups if (B * S) % groups == 0 else 1
    Tg = B * S // G
    cap = max(8, (int(np.ceil(moe.get("capacity_factor", 1.25) * Tg * k / E))
                  + 7) // 8 * 8)
    pos = jax.vmap(lambda fe: jc._positions_in_expert(fe, E))(
        idx.reshape(G, Tg * k))
    return int((np.asarray(pos) >= cap).sum())


CASES = {
    # name: (moe spec, groups, shared expert, router skew)
    "top1 shared": (dict(num_experts=8, top_k=1, shared_expert=True), 1,
                    True, 0.0),
    "top2": (dict(num_experts=4, top_k=2), 1, False, 0.0),
    "top2 groups 2": (dict(num_experts=4, top_k=2), 2, False, 0.0),
    "top2 skewed drops": (dict(num_experts=4, top_k=2, capacity_factor=1.25),
                          1, False, 2.0),
    "top1 skewed drops groups 2": (dict(num_experts=8, top_k=1,
                                        capacity_factor=1.25), 2, False, 2.0),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_forward_matches_reference(name, dtype):
    moe, groups, shared, skew = CASES[name]
    arrays = _inputs(len(name), moe["num_experts"], shared, skew)
    want, waux, got, gaux = _run_both(arrays, moe, groups, dtype)
    scale = float(np.abs(want).max())
    tol = (1e-5 if dtype == "f32" else 2.0 ** -6) * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)
    assert abs(gaux - waux) <= (1e-6 if dtype == "f32" else 1e-5) * abs(waux)
    if skew:
        assert _dropped(arrays, moe, groups, dtype) > 0, \
            "the skewed router dropped no token"


def test_skewed_router_drops_in_the_port_too():
    """The port's own ranks drop the tokens the reference's drop."""
    moe, groups, _, skew = CASES["top2 skewed drops"]
    x, router = _inputs(len("top2 skewed drops"), 4, False, skew)[:2]
    logits = torch.from_numpy(x.reshape(B * S, D)) @ torch.from_numpy(router)
    _, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    pos = tc._positions_in_expert(idx[:, :2].reshape(1, -1), 4)
    cap = max(8, (int(np.ceil(1.25 * B * S * 2 / 4)) + 7) // 8 * 8)
    assert int((pos >= cap).sum()) == _dropped(
        [x, router], moe, groups, "f32") > 0


def test_planted_ties_break_to_the_lower_expert():
    """Router columns 1, 2 and 3 equal (and 5 = 6), every value a small
    multiple of 1/8, so every logit is exact: ties everywhere, broken by
    index alike in both packages, top-1 and top-2."""
    rng = np.random.default_rng(3)
    E = 8
    x = (rng.integers(-4, 5, (B, S, D)) / 8).astype(np.float32)
    router = (rng.integers(-4, 5, (D, E)) / 8).astype(np.float32)
    router[:, 2] = router[:, 3] = router[:, 1]
    router[:, 6] = router[:, 5]
    arrays = _inputs(9, E, True)
    arrays[0], arrays[1] = x, router
    logits = x.reshape(-1, D) @ router
    top = np.sort(logits, axis=-1)[:, ::-1]
    assert (top[:, 0] == top[:, 1]).sum() > 0, "no tie at the top"
    for k in (1, 2):
        moe = dict(num_experts=E, top_k=k, shared_expert=k == 1)
        for dtype in ("f32", "bf16"):
            want, waux, got, gaux = _run_both(
                arrays if k == 1 else arrays[:5], moe, 1, dtype)
            scale = float(np.abs(want).max())
            tol = (1e-6 if dtype == "f32" else 2.0 ** -6) * scale
            assert float(np.abs(got - want).max()) <= tol, (k, dtype)
    # the port's routing itself: the lower index of a tie first
    t_logits = torch.from_numpy(logits)
    _, idx = torch.sort(t_logits, dim=-1, descending=True, stable=True)
    _, jidx = jax.lax.top_k(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(idx[:, :2].numpy(), np.asarray(jidx))


@pytest.mark.parametrize("E,n,groups", [(5, 37, 1), (8, 64, 4), (3, 1, 1)])
def test_positions_in_expert_match_reference(E, n, groups):
    rng = np.random.default_rng(E * n)
    flat = rng.integers(0, E, (groups, n)).astype(np.int32)
    want = np.stack([np.asarray(jc._positions_in_expert(jnp.asarray(f), E))
                     for f in flat])
    got = tc._positions_in_expert(torch.from_numpy(flat).long(), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    one = tc._positions_in_expert(torch.from_numpy(flat[0]).long(), E)
    np.testing.assert_array_equal(one.numpy(), want[0])


@pytest.mark.parametrize("name", ["top1 shared", "top2 groups 2",
                                  "top2 skewed drops"])
def test_moe_gradients_match_jax_grad(name):
    moe, groups, shared, skew = CASES[name]
    arrays = _inputs(len(name) + 100, moe["num_experts"], shared, skew)
    rng = np.random.default_rng(5)
    g = rng.standard_normal((B, S, D)).astype(np.float32)

    def jloss(*a):
        sh = tuple(a[5:]) if len(a) > 5 else None
        out, aux = jc.moe_forward(*a[:5], JMoe(**moe), sh, groups=groups)
        return jnp.sum(out * g) + aux
    want = jax.grad(jloss, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    sh = tuple(leaves[5:]) if len(leaves) > 5 else None
    out, aux = tc.moe_forward(*leaves[:5], TMoe(**moe), sh, groups=groups)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum() + aux,
                              leaves)
    for i, (gt, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        tol = 1e-4 * float(np.abs(w).max()) + 1e-12
        err = float(np.abs(_np(gt) - w).max())
        assert err <= tol, (i, err, tol)


def test_capacity_follows_shapes_only(monkeypatch):
    """cap = max(8, roundup8(ceil(cf * Tg * k / E))) whatever the routing:
    the dispatch buffer's size does not depend on the data (so a CUDA
    graph can capture it)."""
    moe = TMoe(num_experts=4, top_k=2, capacity_factor=1.25)
    bufs = []
    real = torch.Tensor.index_add

    def spy(self, dim, index, source, **kw):
        bufs.append(tuple(self.shape))
        return real(self, dim, index, source, **kw)
    monkeypatch.setattr(torch.Tensor, "index_add", spy)
    for seed, skew in ((0, 0.0), (1, 5.0)):
        tc.moe_forward(*(torch.from_numpy(a) for a in
                         _inputs(seed, 4, False, skew)), moe)
    cap = max(8, (int(np.ceil(1.25 * B * S * 2 / 4)) + 7) // 8 * 8)
    assert bufs == [(4 * cap, D)] * 2


_MOE_SERVE = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models import components
from repro_torch.runtime.partition import Partition
from repro_torch.runtime.sharding import lay_out_params
from repro_torch.serve import make_prefill
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
out = {}
for groups, B, P in ((4, 4, 16), (1, 32, 4)):
    cfg = dataclasses.replace(get_config("mixtral_8x22b", smoke=True),
                              moe_groups=groups)
    model = Model(cfg, kv_chunk=8).init(torch.Generator().manual_seed(2),
                                        "cpu")
    for p in model.parameters():
        p.data = p.data.float()
    tokens = torch.arange(B * P).reshape(B, P) % cfg.vocab
    tok = torch.arange(B).reshape(B, 1) % cfg.vocab
    want0, cache = make_prefill(model, P + 1)(tokens)
    want1, _ = model.decode_step(cache, tok, P)
    params, placements = lay_out_params(cfg, mesh,
                                        dict(model.named_parameters()))
    model.release_params()
    part = Partition(mesh, placements)
    rows = slice(part.dp_rank * B // 2, (part.dp_rank + 1) * B // 2)
    bufs = []
    real = torch.Tensor.index_add

    def spy(self, dim, index, source, **kw):
        bufs.append(list(self.shape))
        return real(self, dim, index, source, **kw)
    torch.Tensor.index_add = spy
    got0, cache = make_prefill(model, P + 1, params, part)(tokens)
    got1, _ = model.decode_step(cache, tok[rows], P, params, part)
    torch.Tensor.index_add = real
    got1 = part.gather(got1)
    out[groups] = {
        "prefill": [float((got0 - want0[rows]).abs().max()),
                    float(want0.abs().max())],
        "decode": [float((got1 - want1[rows]).abs().max()),
                   float(want1.abs().max())],
        "bufs": bufs, "T": [B * P, B], "E": cfg.moe.num_experts,
        "layers": sum(spec.ffn == "moe" for spec in cfg.layers),
        "k": cfg.moe.top_k, "cf": cfg.moe.capacity_factor, "D": cfg.d_model}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def moe_serving():
    """mixtral smoke (f32) served on a 2x2 mesh of 4 gloo ranks, against
    the unsharded steps: 4 dispatch groups (each data rank's rows whole
    groups) and 1 (the routing of both data ranks' rows in one group);
    the dispatch buffers' shapes of the partitioned prefill and step."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from torch_dist import run_ranks
    return [json.loads(out.strip().splitlines()[-1])
            for out in run_ranks(_MOE_SERVE, 4, timeout=120)]


def test_partitioned_capacity_follows_the_global_batch(moe_serving):
    """Over a mesh the capacity comes from the global token count of a
    group, as the reference's (a rank holds a part of it): one group over
    2 data ranks of 16 rows, so cap 80 in the prefill (128 tokens) and 24
    in the step (32), where the rank's own tokens would give 40 and 16."""
    for out in moe_serving:
        rec = out["1"]
        E, k, cf, D = rec["E"], rec["k"], rec["cf"], rec["D"]
        caps = [max(8, (int(np.ceil(cf * T * k / E)) + 7) // 8 * 8)
                for T in rec["T"]]
        assert caps == [80, 24]
        assert rec["bufs"] == [[E * cap, D] for cap in caps
                               for _ in range(rec["layers"])]


def test_moe_pspec_lays_the_dispatch_buffer_out_on_a_mesh(moe_serving):
    """mixtral smoke with 4 dispatch groups served on a 2x2 mesh of 4 gloo
    ranks: the partitioned dispatch lays the groups out over "data" (each
    rank's rows are whole groups; the reference's ``moe_pspec`` asks the
    same of its buffer) and the experts over "model"; the partitioned
    prefill's and step's logits agree with the unsharded ones in f32 to
    their sums' order (``tests/test_torch_serve_partition.py``'s bounds:
    2^-14 of the largest logit, 2^-10 once a step reads the bf16 cache),
    and each rank's buffer holds its own 2 groups."""
    for out in moe_serving:
        for groups, rec in out.items():
            err, scale = rec["prefill"]
            assert err <= 2.0 ** -14 * scale, (groups, err, scale)
            err, scale = rec["decode"]
            assert err <= 2.0 ** -10 * scale, (groups, err, scale)
        rec = out["4"]
        E, k, cf, D = rec["E"], rec["k"], rec["cf"], rec["D"]
        cap = max(8, (int(np.ceil(cf * rec["T"][0] // 4 * k / E)) + 7)
                  // 8 * 8)
        assert rec["bufs"][0] == [2 * E * cap, D]
