"""The model zoo's recurrent serving path: the port against the JAX package.

For the recurrentgemma-9b and rwkv6-1.6b smoke configs, the reference
``Model(cfg).init`` parameters go into the port's ``Model`` through
``convert.model_state_dict``; the same tokens and the same bf16 inputs,
made from a seed, go through both packages, one layer at a time and as a
whole. gemma2-9b and chatglm3-6b smoke (full and local attention, softcaps,
sandwich norms, partial rotary, qkv biases) are held to the reference as
a whole too.

Tolerances, all stated in units of the reference's own scale:

* one layer: the bf16 output within ``2^-6 * max|out|`` (four bf16 steps at
  the largest value: the two frameworks round bf16 matmuls and
  elementwise ops at other places), f32 states within ``1e-3 * max|s|``
  relative to their largest entry;
* a whole model (forward logits, prefill caches, teacher-forced decode
  logits over B = 2, S = 24, P = 20): the reference's decode-consistency
  bound ``0.05 * scale + 0.05`` (``tests/models/test_decode_consistency.py``),
  scale the largest |logit| (or |cache entry|): per-layer rounding
  differences compound over depth;
* the port against itself (prefill + decode vs one forward, the ring
  cache wrapping over 3 windows): the same bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.models import Model
from repro_torch.models import transformer as tt
from repro_torch.serve import make_prefill, make_serve_step

KEY = jax.random.PRNGKey(3)
B, S, P = 2, 24, 20
RECURRENT = ["recurrentgemma_9b", "rwkv6_1p6b"]
DENSE = ["gemma2_9b", "chatglm3_6b"]


def _bound(scale: float) -> float:
    return 0.05 * scale + 0.05


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


class Pair:
    """The reference model with its parameters and the port's model with
    the same parameters, on the CPU, plus one seeded token batch."""

    def __init__(self, arch: str):
        self.cfg = get_config(arch, smoke=True)
        self.ref = JaxModel(self.cfg, kv_chunk=8)
        self.params = self.ref.init(KEY)
        self.pnp = jax.tree.map(np.asarray, self.params)
        self.port = Model(torch_config(arch, smoke=True), kv_chunk=8).init(
            torch.Generator().manual_seed(0), device="cpu")
        self.port.load_state_dict(convert.model_state_dict(self.pnp,
                                                           self.cfg))
        self.tokens = np.array(jax.random.randint(
            jax.random.fold_in(KEY, 1), (B, S), 0, self.cfg.vocab))
        self._full = None

    def ref_layer(self, n: int):
        """Layer n's reference parameters, cut from the stacks directly."""
        period = len(self.cfg.pattern)
        i, j = divmod(n, period)
        if i < self.cfg.n_super:
            return jax.tree.map(lambda a: a[i], self.params["scan"][j])
        return self.params[f"tail{n - self.cfg.n_super * period}"]

    def full(self):
        """Both packages' forward logits over the whole token batch."""
        if self._full is None:
            want, _, _ = self.ref.forward(self.params,
                                          jnp.asarray(self.tokens))
            got, _, _ = self.port(torch.from_numpy(self.tokens))
            self._full = (_np(want), _np(got))
        return self._full


_PAIRS = {}


def _pair(arch: str) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


@pytest.fixture(params=RECURRENT)
def pair(request):
    return _pair(request.param)


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _close_bf16(got, want, what: str) -> None:
    got, want = _np(got), _np(want)
    tol = 2.0 ** -6 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} > {tol}"


def _close_state(got, want, what: str) -> None:
    got, want = _np(got), _np(want)
    tol = 1e-3 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} > {tol}"


def _close_blob(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for key in want:
        check = _close_state if want[key].dtype == jnp.float32 \
            else _close_bf16
        check(got[key], want[key], f"{what} {key}")


def _component_cases():
    """name -> (reference call, port call, dtype of the inputs), each on
    seeded inputs: the building blocks of ``models/components.py``."""
    import repro.models.components as jc
    import repro_torch.models.components as tc
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    w = (rng.standard_normal(16) * 0.1).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    pos = np.arange(3, 15)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 2, 12, 2, 16)).astype(np.float32)  # GQA
    kv_pos = np.arange(12)
    kv_pos[[2, 7]] = -1                      # invalid cache slots
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    m1, m3 = (rng.standard_normal((16, 24)).astype(np.float32) * 0.25
              for _ in range(2))
    m2 = rng.standard_normal((24, 16)).astype(np.float32) * 0.2
    b1, b2 = rng.standard_normal(24) * 0.1, rng.standard_normal(16) * 0.1
    conv_w = rng.standard_normal((4, 16)).astype(np.float32) * 0.3
    state = rng.standard_normal((2, 3, 16)).astype(np.float32)
    gates = {"w_a": rng.standard_normal((16, 16)) * 0.25,
             "w_x": rng.standard_normal((16, 16)) * 0.25,
             "b_a": rng.standard_normal(16) * 0.1,
             "b_x": rng.standard_normal(16) * 0.1,
             "lam": np.full(16, -4.35)}
    J = lambda a, dt=jnp.float32: jnp.asarray(a, dt)          # noqa: E731
    T = lambda a, dt=torch.float32: torch.from_numpy(         # noqa: E731
        np.asarray(a, np.float32)).to(dt) if np.asarray(a).dtype.kind == \
        "f" else torch.from_numpy(np.asarray(a))
    bf_j, bf_t = jnp.bfloat16, torch.bfloat16

    def attn(mod, conv, kv_chunk, **kw):
        return lambda: mod.attention(
            conv(q), conv(kv[0]), conv(kv[1]), q_pos=conv(kv_pos + 2),
            kv_pos=conv(kv_pos), kv_chunk=kv_chunk, **kw)
    return {
        "rms_norm": (lambda: jc.rms_norm(J(x, bf_j), J(w)),
                     lambda: tc.rms_norm(T(x, bf_t), T(w)), "bf16"),
        "layer_norm": (lambda: jc.layer_norm(J(x), J(w), J(b)),
                       lambda: tc.layer_norm(T(x), T(w), T(b)), "f32"),
        "softcap": (lambda: jc.softcap(J(x * 40), 30.0),
                    lambda: tc.softcap(T(x * 40), 30.0), "f32"),
        "rope": (lambda: jc.rope(J(x), J(pos), 10000.0),
                 lambda: tc.rope(T(x), T(pos), 10000.0), "f32"),
        "rope half": (lambda: jc.rope(J(x), J(pos), 500.0, 0.5),
                      lambda: tc.rope(T(x), T(pos), 500.0, 0.5), "f32"),
        "attention direct": (attn(jc, J, 1024), attn(tc, T, 1024), "f32"),
        "attention chunked window softcap": (
            attn(jc, J, 4, window=5, logit_softcap=2.0),
            attn(tc, T, 4, window=5, logit_softcap=2.0), "f32"),
        "attention bidir": (attn(jc, J, 6, causal=False),
                            attn(tc, T, 6, causal=False), "f32"),
        "swiglu": (lambda: jc.swiglu(J(h, bf_j), J(m1, bf_j), J(m3, bf_j),
                                     J(m2, bf_j)),
                   lambda: tc.swiglu(T(h, bf_t), T(m1, bf_t), T(m3, bf_t),
                                     T(m2, bf_t)), "bf16"),
        "gelu_mlp": (lambda: jc.gelu_mlp(J(h), J(m1), J(b1), J(m2), J(b2)),
                     lambda: tc.gelu_mlp(T(h), T(m1), T(b1), T(m2), T(b2)),
                     "f32"),
        "gelu_ffn": (lambda: jc.gelu_ffn(J(h), J(m1), J(m2)),
                     lambda: tc.gelu_ffn(T(h), T(m1), T(m2)), "f32"),
        "causal_conv1d": (lambda: jc.causal_conv1d(J(h, bf_j),
                                                   J(conv_w, bf_j)),
                          lambda: tc.causal_conv1d(T(h, bf_t),
                                                   T(conv_w, bf_t)), "bf16"),
        "causal_conv1d state": (
            lambda: jc.causal_conv1d(J(h, bf_j), J(conv_w, bf_j),
                                     J(state, bf_j)),
            lambda: tc.causal_conv1d(T(h, bf_t), T(conv_w, bf_t),
                                     T(state, bf_t)), "bf16"),
        "_rglru_gates": (
            lambda: jc._rglru_gates(J(h, bf_j), {k: J(v) for k, v in
                                                  gates.items()}),
            lambda: tc._rglru_gates(T(h, bf_t), {k: T(v) for k, v in
                                                  gates.items()}), "f32"),
    }


@pytest.mark.parametrize("name", [
    "rms_norm", "layer_norm", "softcap", "rope", "rope half",
    "attention direct", "attention chunked window softcap",
    "attention bidir", "swiglu", "gelu_mlp", "gelu_ffn", "causal_conv1d",
    "causal_conv1d state", "_rglru_gates"])
def test_components_match_reference(name):
    """Each building block on the same seeded inputs: f32 blocks within
    ``rtol=atol=1e-5`` (the same f32 math in another order; gelu is the
    tanh form in both), bf16 blocks within ``2^-6 * max|out|``."""
    want_fn, got_fn, kind = _component_cases()[name]
    want, got = want_fn(), got_fn()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        if kind == "bf16":
            assert g.dtype == torch.bfloat16
            _close_bf16(g, w, name)
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", RECURRENT + DENSE)
def test_init_matches_converted_reference(arch):
    """The port's own init gives the reference's names, shapes and dtypes,
    and its scale rules (means and spreads of each parameter)."""
    p = _pair(arch)
    want = convert.model_state_dict(p.pnp, p.cfg)
    drawn = Model(torch_config(arch, smoke=True)).init(
        torch.Generator().manual_seed(5), device="cpu").state_dict()
    assert sorted(drawn) == sorted(want)
    for key, w in want.items():
        g = drawn[key]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        gf, wf = g.double(), w.double()
        if wf.std() == 0:
            assert torch.equal(gf, wf), key       # constants: zeros, -4.35
        else:
            assert abs(gf.std() / wf.std() - 1) < 0.35, key


def test_convert_maps_scan_rows_and_tail_to_layers():
    """params["scan"][j] row i is layer i * period + j; tail t is layer
    n_super * period + t (recurrentgemma: 5 = 1 * 3 + 2)."""
    p = _pair("recurrentgemma_9b")
    sd = convert.model_state_dict(p.pnp, p.cfg)
    for n in range(p.cfg.n_layers):
        lp = jax.tree.map(np.asarray, p.ref_layer(n))
        key = "rglru" if "rglru" in lp else "attn"
        name = "w_a" if key == "rglru" else "wq"
        want = np.asarray(lp[key][name], np.float32)
        assert np.array_equal(sd[f"layers.{n}.{key}.{name}"].float().numpy(),
                              want), n


def test_layers_in_sequence_mode_match_reference(pair):
    cfg = pair.cfg
    rng = np.random.default_rng(7)
    positions = np.arange(S)
    for n, spec in enumerate(cfg.layers):
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        xj, xt = _bf16(x)
        want, _, wblob = jt.apply_layer_seq(
            cfg, spec, pair.ref_layer(n), xj, jnp.asarray(positions),
            kv_chunk=8, want_cache=True)
        got, _, gblob = tt.apply_layer_seq(
            pair.port.cfg, spec, pair.port.layers[n], xt,
            torch.from_numpy(positions), kv_chunk=8, want_cache=True)
        assert got.dtype == torch.bfloat16
        _close_bf16(got, want, f"layer {n} ({spec.mix})")
        _close_blob(gblob, wblob, f"layer {n} ({spec.mix}) blob")


def _random_cache(cfg, spec, rng, cache_len):
    """A reference cache blob with seeded contents of the right dtypes."""
    blob = jt.init_layer_cache(cfg, spec, B, cache_len)
    out = {}
    for key, a in blob.items():
        val = rng.standard_normal(a.shape).astype(np.float32)
        if key == "s":
            val *= 0.3
        out[key] = jnp.asarray(val, a.dtype)
    return out


@pytest.mark.parametrize("pos", [5, 37])
def test_layers_in_step_mode_match_reference(pair, pos):
    """One decode token per layer from the same cache; at pos 37 the
    recurrentgemma smoke model's 16-slot ring has wrapped twice."""
    cfg = pair.cfg
    rng = np.random.default_rng(pos)
    for n, spec in enumerate(cfg.layers):
        cache = _random_cache(cfg, spec, rng, cache_len=48)
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        xj, xt = _bf16(x)
        want, wcache = jt.apply_layer_step(cfg, spec, pair.ref_layer(n),
                                           cache, xj, jnp.int32(pos))
        tcache = {k: convert._tensor(np.asarray(v)) for k, v in cache.items()}
        keep = {k: v.clone() for k, v in tcache.items()}
        got, gcache = tt.apply_layer_step(pair.port.cfg, spec,
                                          pair.port.layers[n], tcache, xt,
                                          pos)
        _close_bf16(got, want, f"layer {n} ({spec.mix}) step")
        _close_blob(gcache, wcache, f"layer {n} ({spec.mix}) step cache")
        assert all(torch.equal(keep[k], tcache[k]) for k in keep), \
            "the step changed its input cache"


def test_forward_logits_match_reference(pair):
    want, got = pair.full()
    assert got.shape == (B, S, pair.cfg.vocab)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) < _bound(scale)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_logits_match_reference(arch):
    want, got = _pair(arch).full()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) < _bound(scale)


def test_prefill_cache_matches_reference(pair):
    cfg = pair.cfg
    lj, cj = pair.ref.prefill(pair.params, jnp.asarray(pair.tokens[:, :P]),
                              cache_len=S)
    lt, ct = pair.port.prefill(torch.from_numpy(pair.tokens[:, :P]), S)
    scale = float(np.abs(_np(lj)).max())
    assert float(np.abs(_np(lt) - _np(lj)).max()) < _bound(scale)
    want = convert.model_cache(jax.tree.map(np.asarray, cj), cfg)
    assert len(ct) == len(want) == cfg.n_layers
    for n, (g, w) in enumerate(zip(ct, want)):
        assert sorted(g) == sorted(w), n
        for key in w:
            assert (g[key].shape, g[key].dtype) == (w[key].shape,
                                                    w[key].dtype)
            scale = float(w[key].float().abs().max())
            err = float((g[key].float() - w[key].float()).abs().max())
            assert err < _bound(scale), (n, key, err, scale)


def test_teacher_forced_decode_matches_reference(pair):
    """Prefill P tokens, then decode the rest of the batch's tokens one at a
    time in both packages, through the serving steps."""
    toks = pair.tokens
    prefill = make_prefill(pair.port, cache_len=S)
    step = make_serve_step(pair.port)
    lj, cj = pair.ref.prefill(pair.params, jnp.asarray(toks[:, :P]),
                              cache_len=S)
    lt, ct = prefill(torch.from_numpy(toks[:, :P]))
    pairs = [(_np(lj[:, -1]), _np(lt))]
    for t in range(P, S):
        lgj, cj = pair.ref.decode_step(pair.params, cj,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.int32(t))
        lgt, ct = pair.port.decode_step(ct, torch.from_numpy(
            toks[:, t:t + 1]), t)
        nxt, _ = step(ct, torch.from_numpy(toks[:, t:t + 1]), t)
        assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
        pairs.append((_np(lgj[:, 0]), _np(lgt[:, 0])))
    scale = max(float(np.abs(w).max()) for w, _ in pairs)
    err = max(float(np.abs(g - w).max()) for w, g in pairs)
    assert err < _bound(scale), (err, scale)


def test_port_decode_matches_its_forward(pair):
    """The reference's decode-consistency test, on the port alone."""
    _, full = pair.full()
    toks = torch.from_numpy(pair.tokens)
    logits, cache = pair.port.prefill(toks[:, :P], cache_len=S)
    scale = float(np.abs(full).max()) + 1e-6
    errs = [float(np.abs(_np(logits[:, -1]) - full[:, P - 1]).max())]
    for t in range(P, S):
        lg, cache = pair.port.decode_step(cache, toks[:, t:t + 1], t)
        errs.append(float(np.abs(_np(lg[:, 0]) - full[:, t]).max()))
    assert max(errs) < _bound(scale), errs


def test_ring_cache_wraps_correctly():
    """Decode far past the local window (recurrentgemma smoke: 16 slots):
    prefill 3 windows less one token, decode the last one, and every token
    after a prompt of one window, against one forward."""
    p = _pair("recurrentgemma_9b")
    window = p.cfg.window
    toks = torch.from_numpy(np.array(jax.random.randint(
        KEY, (1, 3 * window), 0, p.cfg.vocab)))
    n = toks.shape[1]
    full, _, _ = p.port(toks)
    full = _np(full)
    scale = float(np.abs(full).max())
    _, cache = p.port.prefill(toks[:, :n - 1], cache_len=window)
    lg, _ = p.port.decode_step(cache, toks[:, n - 1:], n - 1)
    assert float(np.abs(_np(lg[:, 0]) - full[:, -1]).max()) < _bound(scale)
    _, cache = p.port.prefill(toks[:, :window], cache_len=window)
    for t in range(window, n):
        lg, cache = p.port.decode_step(cache, toks[:, t:t + 1], t)
        err = float(np.abs(_np(lg[:, 0]) - full[:, t]).max())
        assert err < _bound(scale), (t, err)


def test_model_without_parameters_raises():
    """A model holds no parameters until ``init`` draws them."""
    with pytest.raises(RuntimeError):
        Model(torch_config("rwkv6_1p6b", smoke=True)).init_cache(1, 8)
