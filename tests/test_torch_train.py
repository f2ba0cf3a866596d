"""The training path: the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch``:

* ``rglru_scan``'s gradient: the port's plain backward
  (``ref.rglru_bwd_ref``, the semantics of the CUDA gradient kernel) against
  ``torch.autograd`` through the plain forward (``rtol=atol=1e-5``: the
  same f32 recurrence, differentiated by another order of operations) and
  against ``jax.grad`` of the reference model's ``associative_scan``
  (``rtol=1e-4, atol=1e-5``: products taken in a tree there);
* ``Model.loss`` and every parameter's gradient against
  ``jax.value_and_grad(repro Model.loss)``, through ``convert``. With f32
  copies of the weights the two agree to ``1e-4 * max|grad|`` a
  parameter (the algorithm). With the reference's dtypes (bf16 weights and
  activations) the losses agree to ``1e-4`` relative and each gradient
  keeps its parameter's dtype and lies, in relative L2, within four times
  the reference's own bf16 rounding of it (its distance from the
  reference's f32 run) plus ``0.02``. That rounding is large in rwkv6 (it
  moves ``u``'s gradient in the last layer by 0.38 of its norm, and the
  port's bf16 gradient is 0.59 from the reference's there), so the f32
  comparison is the one that holds the algorithm;
* ``AdamW.update`` on identical parameters, bf16 gradients and moments,
  with the stacked-layer weight decay rule: bf16 parameters equal bit for
  bit but for at most ``2**-10`` of their elements, those by one bf16
  step, each within 8 f32 ulps of the rounding boundary between the two
  values (the port's f32 value before the cast, from the same update on
  f32 copies of the parameters, which it must round to the port's bf16
  bit for bit: an f32 ulp more or less in ``m`` and ``v`` moves a
  rounding); f32 ones within ``2**-20`` of their largest update; ``m``
  and ``v`` within two f32 ulps of the larger of their two terms
  (XLA:CPU fuses ``b1·m + (1-b1)·g`` into one fused multiply-add, the
  port rounds the product first, as the reference's expression reads);
* ``cosine_warmup`` at counts 0-60 within two f32 ulps (``cos`` from two
  libraries);
* one ``make_train_step`` at ``accum`` 2 from one converted train state:
  metrics within ``1e-4`` relative; the parameters as the update test
  allows, except where a gradient's sign differs between the frameworks
  (Adam's first step moves every element by ``lr`` times the sign of its
  gradient): at most 2% of the elements differ, none by more than
  ``2 lr`` plus one bf16 step.

Tests marked ``cuda`` hold the gradient kernel bit for bit to
``rglru_bwd_ref`` on the card and skip where there is none.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels.rglru_scan import kernel as tk
from repro_torch.kernels.rglru_scan import ops as tops
from repro_torch.kernels.rglru_scan import ref as tref
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_warmup
from repro_torch.train import init_train_state, make_train_step

ARCHS = ["recurrentgemma_9b", "rwkv6_1p6b", "chatglm3_6b", "mixtral_8x22b",
         "llama4_maverick_400b_a17b", "llama3p2_vision_11b",
         "whisper_large_v3"]
MOE = ("mixtral_8x22b", "llama4_maverick_400b_a17b")
B, S = 2, 24
BWD_SHAPE = (2, 37, 24)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rglru_scan gradient kernel runs "
                    "only there")
    return torch.device("cuda")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bwd_inputs(seed, shape):
    """log_a = -0.2 |N(0, 1)| (the reference sweep's), b, h0 and the
    upstream gradient gh standard normal."""
    rng = np.random.default_rng(seed)
    Bb, Ss, R = shape
    la = (-np.abs(rng.standard_normal(shape)) * 0.2).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((Bb, R)).astype(np.float32)
    gh = rng.standard_normal(shape).astype(np.float32)
    return la, b, h0, gh


# -- rglru_scan's gradient ------------------------------------------------------


@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_bwd_ref_matches_autograd_and_jax_grad(with_h0):
    import jax
    import jax.numpy as jnp
    from repro.models.components import rglru_scan as jax_scan
    la, b, h0, gh = _bwd_inputs(7 + with_h0, BWD_SHAPE)
    tla, tb, th0, tgh = (torch.from_numpy(a) for a in (la, b, h0, gh))
    zeros = torch.zeros_like(th0)
    h = tref.rglru_ref(tla, tb, th0 if with_h0 else zeros)
    got = tref.rglru_bwd_ref(tla, h, tgh, th0 if with_h0 else zeros)
    assert got[0].shape == got[1].shape == BWD_SHAPE
    assert got[2].shape == h0.shape

    # autograd through the plain forward
    a_la, a_b, a_h0 = (t.clone().requires_grad_() for t in (tla, tb, th0))
    out = tref.rglru_ref(a_la, a_b, a_h0 if with_h0 else zeros)
    want_t = torch.autograd.grad((out * tgh).sum(),
                                 (a_la, a_b, a_h0) if with_h0
                                 else (a_la, a_b))
    for g, w in zip(got, want_t):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)

    # jax.grad of the reference model's associative scan
    def f(la_, b_, h0_):
        hh = jax_scan(la_, b_, h0_ if with_h0 else None)
        return jnp.sum(hh * jnp.asarray(gh))
    want_j = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(la), jnp.asarray(b), jnp.asarray(h0))
    for g, w in zip(got if with_h0 else got[:2], want_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_autograd_function_routes_to_plain_pair_on_cpu(monkeypatch):
    la, b, h0, gh = (torch.from_numpy(a) for a in _bwd_inputs(3, BWD_SHAPE))
    calls = []
    real_fwd, real_bwd = tops.rglru_ref, tops.rglru_bwd_ref

    def fwd(*a):
        calls.append("fwd")
        return real_fwd(*a)

    def bwd(*a):
        calls.append("bwd")
        return real_bwd(*a)
    monkeypatch.setattr(tops, "rglru_ref", fwd)
    monkeypatch.setattr(tops, "rglru_bwd_ref", bwd)
    before = (tk.rglru_scan_launches, tk.rglru_scan_bwd_launches)
    x = [t.clone().requires_grad_() for t in (la, b, h0)]
    h = tops.rglru_scan(*x)
    assert isinstance(h.grad_fn.__class__, type) and \
        h.grad_fn.__class__.__name__ == "RGLRUScanBackward"
    grads = torch.autograd.grad((h * gh).sum(), x)
    assert calls == ["fwd", "bwd"]
    want = real_bwd(la, real_fwd(la, b, h0), gh, h0)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    # no h0: its gradient is not asked for, the plain backward runs from 0
    x2 = [t.clone().requires_grad_() for t in (la, b)]
    g2 = torch.autograd.grad((tops.rglru_scan(*x2) * gh).sum(), x2)
    want2 = real_bwd(la, real_fwd(la, b, torch.zeros_like(h0)), gh,
                     torch.zeros_like(h0))
    assert all(torch.equal(g, w) for g, w in zip(g2, want2))
    # without autograd the op calls the forward alone, with no graph
    with torch.no_grad():
        assert tops.rglru_scan(*x).grad_fn is None
    assert tops.rglru_scan(la, b, h0).grad_fn is None
    with pytest.raises(ValueError):
        tops.rglru_scan(*x, use_kernel=True)
    with pytest.raises(ValueError):
        tk.rglru_scan_bwd_cuda(la, la, gh, h0)
    assert (tk.rglru_scan_launches, tk.rglru_scan_bwd_launches) == before


# -- the model's loss and gradients --------------------------------------------


class Pair:
    """The reference model and the port's with the same parameters (the
    reference's dtypes, or f32 copies of them; cross-attention gates at
    0.5, as ``zoo_pairs`` sets them) and one seeded batch, with
    ``extras`` (bf16, or f32 with f32 weights) where the model reads
    them."""

    def __init__(self, arch: str, f32: bool):
        import jax
        import jax.numpy as jnp
        from repro.configs import get_config
        from repro.models import Model as JaxModel
        from zoo_pairs import GATE, extras_np, with_gates
        self.cfg = get_config(arch, smoke=True)
        self.ref = JaxModel(self.cfg, kv_chunk=8)
        params = with_gates(self.ref.init(jax.random.PRNGKey(3)), GATE)
        if f32:
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        self.params = params
        self.port = Model(torch_config(arch, smoke=True), kv_chunk=8).init(
            torch.Generator().manual_seed(0), device="cpu")
        sd = convert.model_state_dict(jax.tree.map(np.asarray, params),
                                      self.cfg)
        own = dict(self.port.named_parameters())
        with torch.no_grad():
            for k, v in sd.items():         # keeps f32 copies f32
                own[k].data = v.clone()
        rng = np.random.default_rng(5)
        toks = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
        labels[0, 3] = -100                 # an ignored label mid-row
        self.batch = {"tokens": toks, "labels": labels}
        self.extras = extras_np(self.cfg)
        self.f32 = f32

    def reference(self):
        import jax
        import jax.numpy as jnp
        batch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        if self.extras is not None:
            dt = jnp.float32 if self.f32 else jnp.bfloat16
            batch["extras"] = {k: jnp.asarray(v, dt)
                               for k, v in self.extras.items()}
        (loss, m), g = jax.jit(jax.value_and_grad(
            self.ref.loss, has_aux=True))(self.params, batch)
        grads = convert.model_state_dict(jax.tree.map(np.asarray, g),
                                         self.cfg)
        return float(loss), {k: float(v) for k, v in m.items()}, grads

    def port_grads(self):
        params = self.port.train_params()
        names = list(params)
        batch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        if self.extras is not None:
            dt = torch.float32 if self.f32 else torch.bfloat16
            batch["extras"] = {k: torch.from_numpy(v).to(dt)
                               for k, v in self.extras.items()}
        loss, m = self.port.loss(batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return (float(loss.detach()), {k: float(v.detach())
                                       for k, v in m.items()},
                dict(zip(names, grads)))


_RUNS = {}


def _run(arch: str, f32: bool):
    """(reference loss, metrics, grads), (port's), shared across tests."""
    if (arch, f32) not in _RUNS:
        p = Pair(arch, f32)
        _RUNS[(arch, f32)] = (p.reference(), p.port_grads())
    return _RUNS[(arch, f32)]


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference_in_f32(arch):
    (rl, rm, rg), (tl, tm, tg) = _run(arch, True)
    assert abs(tl - rl) <= 1e-5 * abs(rl)
    assert tm["tokens"] == rm["tokens"] == B * (S - 1) - 1
    if arch in MOE:         # the Switch aux loss, f32 softmax statistics
        assert rm["aux"] > 0 and abs(tm["aux"] - rm["aux"]) <= 1e-5 * rm[
            "aux"]
    else:
        assert tm["aux"] == rm["aux"] == 0.0
    assert set(tg) == set(rg)
    for k, g in tg.items():
        assert g.dtype == torch.float32 and g.shape == rg[k].shape, k
        tol = 1e-4 * float(np.abs(_np(rg[k])).max()) + 1e-12
        err = float(np.abs(_np(g) - _np(rg[k])).max())
        assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference_in_bf16(arch):
    (rl, rm, rg), (tl, tm, tg) = _run(arch, False)
    _, _, rg32 = _run(arch, True)[0]
    assert abs(tl - rl) <= 1e-4 * abs(rl)
    assert abs(tm["ce"] - rm["ce"]) <= 1e-4 * abs(rm["ce"])
    for k, g in tg.items():
        assert g.dtype == rg[k].dtype, (k, g.dtype, rg[k].dtype)
        rounding = _rel_l2(rg[k], rg32[k])   # the reference's own
        err = _rel_l2(g, rg[k])
        assert err <= 4 * rounding + 0.02, (k, err, rounding)


# -- the optimizer and the schedule ----------------------------------------------


def _bf16_steps(got: torch.Tensor, want: torch.Tensor) -> np.ndarray:
    """|bit distance| of two bf16 tensors of one sign pattern: 1 = one
    bf16 step."""
    a = got.view(torch.int16).numpy().astype(np.int64)
    b = want.view(torch.int16).numpy().astype(np.int64)
    return np.abs(a - b)


def _check_params_close(got: dict, want: dict, old: dict, frac: float,
                        pre_round: dict = None) -> None:
    """bf16 parameters: at most ``frac`` of their elements differ, each by
    one bf16 step; with ``pre_round`` (the port's f32 value of each bf16
    parameter before its cast) the port's parameter is that value rounded,
    bit for bit, and every element that differs from the reference lies
    within 8 f32 ulps of the rounding boundary between the two bf16
    values: the two updates agree in f32 but for the ulps of a fused
    multiply-add, and the cast rounds them apart. f32 parameters: within
    ``2**-20`` of the largest update of the tensor (the update's own ulps,
    which XLA's contractions move on some elements and not on others, so
    they are not counted against ``frac``)."""
    total = diff = 0
    for k, w in want.items():
        g = got[k].detach()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == torch.bfloat16:
            total += w.numel()
            steps = _bf16_steps(g, w)
            assert steps.max() <= 1, (k, steps.max())
            diff += int((steps > 0).sum())
            if pre_round is not None:
                x = pre_round[k]
                assert torch.equal(x.to(torch.bfloat16), g), k
                bad = _unexplained_flips(g, w, x, old[k])
                assert bad == 0, (k, bad)
        else:
            moved = float((w - old[k]).abs().max())
            err = float((g - w).abs().max())
            assert err <= 2.0 ** -20 * moved, (k, err, moved)
    assert diff <= frac * total, (diff, total)


def _unexplained_flips(got, want, x, old) -> int:
    """Elements where the two bf16 values differ and the f32 value ``x``
    is not within 8 f32 ulps (of the largest of the old value, ``x`` and
    the step between them) of the boundary that separates them."""
    a = got.float().numpy().astype(np.float64)
    b = want.float().numpy().astype(np.float64)
    xf = x.numpy()
    flip = a != b
    if not flip.any():
        return 0
    mid = (a + b) / 2
    scale = np.maximum.reduce([np.abs(old.float().numpy()), np.abs(xf),
                               np.abs(old.float().numpy() - xf)])
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    return int((flip & (np.abs(xf.astype(np.float64) - mid) > 8 * ulp))
               .sum())


def _random_like_tree(rng, tree, scale, dtype=None, positive=False):
    import jax
    import jax.numpy as jnp

    def one(a):
        x = rng.standard_normal(a.shape).astype(np.float32) * scale
        x = np.abs(x) if positive else x
        return jnp.asarray(x, dtype or a.dtype)
    return jax.tree.map(one, tree)


def test_adamw_update_matches_reference_with_stacked_decay():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    from repro.optim import AdamW as JaxAdamW
    from repro.optim import cosine_warmup as jax_cosine
    cfg = get_config("recurrentgemma_9b", smoke=True)
    params = JaxModel(cfg).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(11)
    grads = _random_like_tree(rng, params, 0.05, jnp.bfloat16)
    state = {"m": _random_like_tree(rng, params, 0.01, jnp.float32),
             "v": _random_like_tree(rng, params, 1e-3, jnp.float32,
                                    positive=True),
             "count": jnp.asarray(4, jnp.int32)}
    kw = dict(weight_decay=0.1, grad_clip=1.0)
    want_p, want_s = jax.jit(JaxAdamW(lr=jax_cosine(3e-3, 7, 60), **kw)
                             .update)(grads, state, params)

    def port(tree):
        return convert.model_state_dict(jax.tree.map(np.asarray, tree), cfg)
    model = Model(torch_config("recurrentgemma_9b", smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    decays = model.decay_names()
    # the stacked rule: every parameter of the superblock (layers 0-2),
    # 2-D ones of the tail, never the final norm
    assert "layers.0.ln1.w" in decays and "layers.2.ffn.w1" in decays
    assert "layers.1.rglru.lam" in decays
    assert "layers.3.ln1.w" not in decays and "layers.4.rglru.b_a" not in \
        decays and "layers.3.rglru.w_a" in decays
    assert "final.w" not in decays and "embed" in decays
    opt = AdamW(lr=cosine_warmup(3e-3, 7, 60), **kw)

    def step(decay_set):
        st = {"m": port(state["m"]), "v": port(state["v"]),
              "count": torch.tensor(4, dtype=torch.int32)}
        return opt.update(port(grads), st, port(params), decays=decay_set)
    got_p, got_s = step(decays)
    assert int(got_s["count"]) == int(want_s["count"]) == 5
    # the port's f32 value of each bf16 parameter before the cast: the
    # same update on f32 copies of the parameters
    ups = {k: t.float() if t.dtype == torch.bfloat16 else t
           for k, t in port(params).items()}
    st = {"m": port(state["m"]), "v": port(state["v"]),
          "count": torch.tensor(4, dtype=torch.int32)}
    f32_p, _ = opt.update(port(grads), st, ups, decays=decays)
    _check_params_close(got_p, port(want_p), port(params), 2.0 ** -10,
                        pre_round={k: f32_p[k] for k, t in got_p.items()
                                   if t.dtype == torch.bfloat16})
    # m and v: within two f32 ulps of the larger of their two terms (the
    # product XLA:CPU keeps unrounded inside its fused multiply-add)
    g32 = {k: t.float() for k, t in port(grads).items()}
    m0, v0 = port(state["m"]), port(state["v"])
    for key, terms in (("m", lambda k: 0.9 * m0[k].abs() + 0.1 * g32[k].abs()),
                       ("v", lambda k: 0.95 * v0[k] + 0.05 * g32[k] ** 2)):
        for k, w in port(want_s[key]).items():
            err = (got_s[key][k] - w).abs()
            assert bool((err <= 2.0 ** -22 * terms(k)).all()), (key, k)
    # the port's own ndim rule would not decay the superblock's 1-D
    # weights (lam starts at -4.35; the norm weights at 0 decay by 0)
    plain_p, _ = step(None)
    assert not torch.allclose(plain_p["layers.0.rglru.lam"],
                              port(want_p)["layers.0.rglru.lam"],
                              rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "rwkv6_1p6b",
                                  "gemma2_9b", "mixtral_8x22b",
                                  "llama4_maverick_400b_a17b",
                                  "llama3p2_vision_11b", "whisper_large_v3"])
def test_decay_names_follow_the_reference_leaf_ndim(arch):
    """``Model.decay_names`` is the set the reference's AdamW decays
    (``ndim >= 2`` of its leaf), leaf for leaf through ``convert``: a
    superblock's or an encoder layer's parameter counts the stacking
    axis, so a 0-d cross-attention gate there is 1-D and does not decay,
    and the encoder layers' 1-D norm weights do."""
    import jax
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    cfg = get_config(arch, smoke=True)
    specs = JaxModel(cfg).param_specs()
    marks = convert.model_state_dict(jax.tree.map(
        lambda a: np.full(a.shape, len(a.shape) >= 2), specs), cfg)
    want = {k for k, v in marks.items() if bool(v.all())}
    model = Model(torch_config(arch, smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert set(marks) == set(dict(model.named_parameters()))
    assert model.decay_names() == want
    names = dict(model.named_parameters())
    gates = [k for k in names if k.endswith("xattn.gate")]
    assert all(names[k].dim() == 0 and k not in want for k in gates)
    if arch == "whisper_large_v3":
        assert "encoder.layers.1.ln1.w" in want and "encoder.pos" in want
        assert "encoder.final.w" not in want and "pos_embed" in want


def test_release_params_keeps_names_and_shapes_and_binds_back():
    """``Model.release_params`` drops the module's tensors to ``meta``
    (names, shapes, dtypes and ``decay_names`` kept); the module's own
    forward then raises, and ``bind_params`` takes the values in again:
    the same losses as before the release."""
    model = Model(torch_config("whisper_large_v3", smoke=True),
                  kv_chunk=8).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    before = {k: (p.shape, p.dtype) for k, p in model.named_parameters()}
    values = {k: p.detach().clone() for k, p in model.named_parameters()}
    decay = model.decay_names()
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 8)))
    batch = {"tokens": toks, "labels": toks, "extras": {
        "frames": torch.from_numpy(rng.standard_normal(
            (2, model.cfg.encoder.n_frames, model.cfg.d_model))
        ).to(torch.bfloat16)}}
    with torch.no_grad():
        want = model.loss(batch)[0]
    model.release_params()
    assert {k: (p.shape, p.dtype) for k, p in
            model.named_parameters()} == before
    assert all(p.is_meta for p in model.parameters())
    assert model.decay_names() == decay
    with pytest.raises(RuntimeError):
        model.loss(batch)
    own = model.bind_params(values)
    assert all(torch.equal(own[k], v) for k, v in values.items())
    with torch.no_grad():
        assert torch.equal(model.loss(batch)[0], want)


def test_adamw_update_matches_reference_on_vision_gates():
    """llama3.2-vision smoke in f32 (so a decay of a gate would show: at
    0.5 one step moves it by far less than a bf16 step): the reference's
    AdamW update and the port's with ``decay_names`` agree on every
    parameter, the gate included, as the stacked-decay test allows; with
    every superblock parameter decayed (the rule before the gates) the
    gate would move."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    from repro.optim import AdamW as JaxAdamW
    from zoo_pairs import GATE, with_gates
    cfg = get_config("llama3p2_vision_11b", smoke=True)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), with_gates(
        JaxModel(cfg).init(jax.random.PRNGKey(1)), GATE))
    rng = np.random.default_rng(12)
    grads = _random_like_tree(rng, params, 0.05)
    state = {"m": _random_like_tree(rng, params, 0.01),
             "v": _random_like_tree(rng, params, 1e-3, positive=True),
             "count": jnp.asarray(4, jnp.int32)}
    kw = dict(lr=3e-3, weight_decay=0.1, grad_clip=1.0)
    want_p, _ = jax.jit(JaxAdamW(**kw).update)(grads, state, params)

    def port(tree):
        return convert.model_state_dict(jax.tree.map(np.asarray, tree), cfg)
    model = Model(torch_config("llama3p2_vision_11b", smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(**kw)

    def step(decays):
        st = {"m": port(state["m"]), "v": port(state["v"]),
              "count": torch.tensor(4, dtype=torch.int32)}
        return opt.update(port(grads), st, port(params), decays=decays)[0]
    decays = model.decay_names()
    gate = "layers.4.xattn.gate"
    assert gate not in decays and "layers.4.lnx.w" in decays
    got = step(decays)
    # all f32: each element within 2**-20 of its tensor's largest update
    # (any may differ by the fused multiply-add's ulp)
    _check_params_close(got, port(want_p), port(params), 1.0)
    every = decays | {k for k in got if k.startswith("layers.")}
    assert not torch.equal(step(every)[gate], port(want_p)[gate])


def test_cosine_warmup_matches_reference():
    import jax
    import jax.numpy as jnp
    from repro.optim import cosine_warmup as jax_cosine
    for peak, warm, total in ((3e-3, 10, 60), (3e-4, 1, 8), (1e-3, 0, 5)):
        counts = np.arange(61, dtype=np.int32)
        want = np.asarray(jax.vmap(jax_cosine(peak, warm, total))(
            jnp.asarray(counts)))
        sched = cosine_warmup(peak, warm, total)
        got = np.array([sched(torch.tensor(int(c), dtype=torch.int32)).item()
                        for c in counts], np.float32)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=0)
        assert sched(torch.tensor(3, dtype=torch.int32)).dtype == \
            torch.float32


# -- one microbatched train step --------------------------------------------------


def _one_step(arch: str):
    """One reference train step (``arch`` smoke, accum 2, its gates at
    0.5 and seeded bf16 ``extras`` where it reads them) and the port's
    from the same converted state and batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.data import DataPipeline
    from repro.models import Model as JaxModel
    from repro.optim import AdamW as JaxAdamW
    from repro.optim import cosine_warmup as jax_cosine
    from repro.train import init_train_state as jax_init
    from repro.train import make_train_step as jax_step
    from zoo_pairs import GATE, extras_np, with_gates
    cfg = get_config(arch, smoke=True)
    jm = JaxModel(cfg, kv_chunk=8)
    jopt = JaxAdamW(lr=jax_cosine(3e-3, 3, 20), weight_decay=0.01)
    state = jax_init(jm, jopt, jax.random.PRNGKey(4))
    state["params"] = with_gates(state["params"], GATE)
    b = DataPipeline(vocab=cfg.vocab, seq_len=S, global_batch=4,
                     seed=2).batch_for(0)
    batch = {k: v.reshape(2, 2, S) for k, v in b.items()}
    extras = {k: np.stack([v, v[::-1]]) for k, v in
              (extras_np(cfg) or {}).items()}   # (accum, B, ...): two draws
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if extras:
        jbatch["extras"] = {k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in extras.items()}
        tbatch["extras"] = {k: torch.from_numpy(v).to(torch.bfloat16)
                            for k, v in extras.items()}
    state_np = jax.tree.map(np.asarray, state)
    new, metrics = jax.jit(jax_step(jm, jopt))(state, jbatch)
    want = jax.tree.map(np.asarray, new)
    ported = convert.train_state(state_np, cfg)
    model = Model(torch_config(arch, smoke=True),
                  kv_chunk=8).init(torch.Generator().manual_seed(9),
                                   device="cpu")
    opt = AdamW(lr=cosine_warmup(3e-3, 3, 20), weight_decay=0.01)
    got, got_m = make_train_step(model, opt)(ported, tbatch)
    return dict(cfg=cfg, state_np=state_np, ported=ported, want=want,
                want_m={k: float(v) for k, v in metrics.items()}, got=got,
                got_m={k: float(v) for k, v in got_m.items()}, model=model)


@pytest.fixture(scope="module")
def step_pair():
    return _one_step("recurrentgemma_9b")


def test_convert_train_state_maps_the_reference_state(step_pair):
    cfg, ported, ref = step_pair["cfg"], step_pair["ported"], \
        step_pair["state_np"]
    model = step_pair["model"]
    names = dict(model.named_parameters())
    assert set(ported) == {"params", "opt", "step"}
    for key in ("params",):
        assert set(ported[key]) == set(names)
    for part in ("m", "v"):
        assert set(ported["opt"][part]) == set(names)
        assert all(t.dtype == torch.float32
                   for t in ported["opt"][part].values())
    assert ported["opt"]["count"].dtype == torch.int32
    assert ported["step"].dtype == torch.int32 and ported["step"].dim() == 0
    flat = convert.model_state_dict(ref["params"], cfg)
    for k, t in flat.items():
        assert names[k].dtype == t.dtype and names[k].shape == t.shape, k


def test_train_step_matches_reference(step_pair):
    _check_one_step(step_pair)


def test_train_step_with_extras_matches_reference():
    """whisper smoke: each microbatch's ``extras["frames"]`` reach its
    loss (the reference scans every leaf of the batch)."""
    _check_one_step(_one_step("whisper_large_v3"))


def _check_one_step(step_pair):
    got, want = step_pair["got"], step_pair["want"]
    gm, wm = step_pair["got_m"], step_pair["want_m"]
    cfg = step_pair["cfg"]
    for k in ("loss", "ce"):
        assert abs(gm[k] - wm[k]) <= 1e-4 * abs(wm[k]), (k, gm, wm)
    assert gm["aux"] == wm["aux"] == 0.0
    assert int(got["step"]) == int(want["step"]) == 1
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 1
    # the step's params are the model's own, updated in place
    own = dict(step_pair["model"].named_parameters())
    assert all(got["params"][k] is own[k] for k in own)
    want_p = convert.model_state_dict(want["params"], cfg)
    lr = 3e-3 / 3          # cosine_warmup(3e-3, 3, 20) at count 1
    total = diff = 0
    for k, w in want_p.items():
        g = got["params"][k].detach()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        d = (g.float() - w.float()).abs()
        step = torch.finfo(torch.bfloat16).eps * torch.maximum(
            g.float().abs(), w.float().abs())
        assert bool((d <= 2 * lr * 1.01 + step).all()), (k, float(d.max()))
        total += w.numel()
        diff += int((g != w).sum())
    assert diff <= 0.02 * total, (diff, total)


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [BWD_SHAPE, (3, 1, 64), (1, 300, 4096),
                                   (2, 9, 100), (2, 0, 8)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_cuda_gradient_kernel_matches_plain_backward(cuda_device, shape,
                                                     with_h0):
    la, b, h0, gh = (torch.from_numpy(a).to(cuda_device)
                     for a in _bwd_inputs(sum(shape), shape))
    h = tk.rglru_scan_cuda(la, b, h0 if with_h0 else None)
    h0_arg = h0 if with_h0 else None
    before = tk.rglru_scan_bwd_launches
    got = tk.rglru_scan_bwd_cuda(la, h, gh, h0_arg)
    again = tk.rglru_scan_bwd_cuda(la, h, gh, h0_arg)
    torch.cuda.synchronize()
    assert tk.rglru_scan_bwd_launches == before + (2 if la.numel() else 0)
    want = tref.rglru_bwd_ref(la, h, gh, h0 if with_h0
                              else torch.zeros_like(h0))
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_op_gradient_launches_the_kernel_or_raises(cuda_device):
    la, b, h0, gh = (torch.from_numpy(a).to(cuda_device)
                     for a in _bwd_inputs(5, BWD_SHAPE))
    x = [t.clone().requires_grad_() for t in (la, b, h0)]
    tk.reset_counters()
    h = tops.rglru_scan(*x)
    grads = torch.autograd.grad((h * gh).sum(), x)
    torch.cuda.synchronize()
    assert (tk.rglru_scan_launches, tk.rglru_scan_bwd_launches) == (1, 1)
    want = tref.rglru_bwd_ref(la, h.detach(), gh, h0)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    with pytest.raises(ValueError):
        tops.rglru_scan(*x, use_kernel=False)
    with pytest.raises(TypeError):
        tk.rglru_scan_bwd_cuda(la.double(), h.detach(), gh, h0)
    with pytest.raises(ValueError):
        tk.rglru_scan_bwd_cuda(la, h.detach()[:, :3].contiguous(), gh, h0)


@pytest.mark.cuda
def test_cuda_train_step_launches_forward_and_gradient_kernels(cuda_device):
    """recurrentgemma smoke (4 recurrent layers), accum 2: each microbatch
    runs the forward kernel once a recurrent layer and again in the
    remat recompute, the gradient kernel once."""
    model = Model(torch_config("recurrentgemma_9b", smoke=True), kv_chunk=8)
    opt = AdamW(lr=3e-3, weight_decay=0.01)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    state = init_train_state(model, opt, gen)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 2, S))).to(cuda_device)
    batch = {"tokens": toks, "labels": toks}
    tk.reset_counters()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    n_rec = 4
    assert (tk.rglru_scan_launches, tk.rglru_scan_bwd_launches) == (
        n_rec * 2 * 2, n_rec * 2)
    assert bool(torch.isfinite(metrics["loss"]))


# -- over a mesh (gloo ranks on the CPU) -----------------------------------------

_MESH_STEPS = """
import json
import sys
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_warmup
from repro_torch.runtime.elastic import reshard_state, state_shardings
from repro_torch.runtime.sharding import (ShardingRules, shard_view,
                                          to_placements)
from repro_torch.train import init_train_state, make_train_step
sys.path.insert(0, TESTS)
from torch_dist import accumulators
cfg = get_config("recurrentgemma_9b", smoke=True)

def run(mesh_shape, specs):
    model = Model(cfg, kv_chunk=8)
    opt = AdamW(lr=cosine_warmup(3e-3, 2, 10), weight_decay=0.01)
    state = init_train_state(model, opt, torch.Generator().manual_seed(3))
    old = {k: p.detach().clone() for k, p in state["params"].items()}
    grad_pspecs = None
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
        state = reshard_state(state, state_shardings(cfg, mesh, state))
        model.release_params()
        if specs:
            grad_pspecs = ShardingRules(cfg, mesh).opt_state_pspecs(
                state["params"])
    step = make_train_step(model, opt, grad_pspecs=grad_pspecs)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    losses = []
    for i in range(3):
        b = pipe.batch_for(i)
        state, m = step(state, {k: torch.from_numpy(v).reshape(2, 2, 16)
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    whole = {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach()
             for k, v in state["params"].items()}
    return losses, whole, old

def f32_accum(mesh_shape):
    # one f32 step (the bf16 parameters cast): this rank's f32 gradient
    # accumulators, the mesh and their specs on it
    model = Model(cfg, kv_chunk=8)
    opt = AdamW(lr=cosine_warmup(3e-3, 2, 10), weight_decay=0.01)
    init_train_state(model, opt, torch.Generator().manual_seed(3))
    for p in model.parameters():
        p.data = p.data.float()
    params = model.train_params()
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    specs = None
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
        state = reshard_state(state, state_shardings(cfg, mesh, state))
        model.release_params()
        specs = ShardingRules(cfg, mesh).opt_state_pspecs(state["params"])
    step = make_train_step(model, opt, grad_pspecs=specs)
    b = DataPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4,
                     seed=1).batch_for(0)
    with accumulators() as accs:
        step(state, {k: torch.from_numpy(v).reshape(2, 2, 16)
                     for k, v in b.items()})
    return accs[0], (mesh if specs is not None else None), specs

base, p0, old = run(None, False)
out = {"base": base}
for name, shape, specs in CASES:
    losses, p, _ = run(shape, specs)
    out[name] = losses
    if RANK == 0:
        torch.save({"got": p, "want": p0, "old": old}, f"{DIR}/{name}.pt")
    if WORLD > 1:
        got, mesh, gspecs = f32_accum(shape)
        whole = f32_accum(None)[0]
        want = {k: shard_view(w, mesh, to_placements(gspecs[k], mesh))
                for k, w in whole.items()}
        torch.save({"got": got, "want": want}, f"{DIR}/{name}.accum{RANK}.pt")
print(json.dumps(out))
"""


def test_make_train_step_grad_pspecs_over_a_mesh(tmp_path):
    """recurrentgemma smoke, accum 2, 3 steps from one seeded state. On a
    1x1 mesh (one rank) the state laid out by ``state_shardings`` and the
    accumulator by ``grad_pspecs`` give the unsharded step's losses and
    parameters bit for bit, with and without ``grad_pspecs``. On a 2x2
    mesh (4 gloo ranks, ZeRO-1 moments) the step is partitioned (each
    rank's rows over its shards, the model released), so its sums run in
    another order: losses and parameters within the partition tests'
    bounds (``torch_dist.PARTITION_LOSS`` relative, ``within_adam_reach``;
    ``tests/test_torch_partition.py``), and one f32 step's gradient
    accumulators (the bf16 parameters cast to f32) on every rank within
    ``torch_dist.F32_ACCUM`` of its shard of the unsharded step's: the
    check on the gradients' values, which AdamW's scale-blind update
    hides from the parameters."""
    import sys
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_dist import (F32_ACCUM_FLOOR, PARTITION_LOSS, accum_close,
                            run_ranks, within_adam_reach)
    for world, cases in ((1, [("one", (1, 1), True),
                              ("one_none", (1, 1), False)]),
                         (4, [("four", (2, 2), True)])):
        code = (f"CASES = {cases!r}; DIR = {str(tmp_path)!r}; "
                f"TESTS = {str(Path(__file__).parent)!r}\n" + _MESH_STEPS)
        out = json.loads(run_ranks(code, world, timeout=150)[0])
        for name, _, _ in cases:
            saved = torch.load(tmp_path / f"{name}.pt")
            if world == 1:
                assert out[name] == out["base"], name
                for k, w in saved["want"].items():
                    assert torch.equal(saved["got"][k], w), (name, k)
            else:
                for a, b in zip(out[name], out["base"]):
                    assert abs(a - b) <= PARTITION_LOSS * abs(b), (
                        out[name], out["base"])
                within_adam_reach(saved["got"], saved["want"],
                                  cosine_warmup(3e-3, 2, 10), 3)
                for r in range(world):
                    acc = torch.load(tmp_path / f"{name}.accum{r}.pt")
                    floor = F32_ACCUM_FLOOR * max(
                        float(t.norm()) for t in acc["want"].values())
                    accum_close(acc["got"], acc["want"], floor, (name, r))
    model = Model(torch_config("recurrentgemma_9b", smoke=True))
    state = init_train_state(model, AdamW(), torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamW(), grad_pspecs={
        k: () for k in state["params"]})
    with pytest.raises(ValueError):          # no mesh to lay them out on
        step(state, {"tokens": torch.zeros((1, 1, 4), dtype=torch.int64),
                     "labels": torch.zeros((1, 1, 4), dtype=torch.int64)})


_LAUNCH = """
import json
from repro_torch.launch import train as launch_train
out = launch_train.run(launch_train.parse_args(ARGV))
if RANK == 0:
    print(json.dumps(out["history"]))
"""


def test_launch_train_mesh_2x2_matches_1x1(tmp_path):
    """``launch/train --mesh 2x2`` on 4 gloo ranks (recurrentgemma smoke,
    accum 2, a checkpoint mid-run; each rank's step takes its rows of the
    batch, its model released) gives the ``--mesh 1x1`` run's losses
    within the partition tests' bound
    (``torch_dist.PARTITION_LOSS`` relative: the partitioned step's sums
    run in another order)."""
    import sys
    sys.path.insert(0, str(Path(__file__).parent))
    from repro_torch.launch import train as launch_train
    from torch_dist import PARTITION_LOSS, run_ranks
    argv = ["--arch", "recurrentgemma-9b", "--smoke", "--steps", "4",
            "--batch", "4", "--seq", "16", "--accum", "2", "--device",
            "cpu", "--ckpt-interval", "2"]
    one = launch_train.run(launch_train.parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "one")]))["history"]
    code = f"ARGV = {argv + ['--mesh', '2x2', '--ckpt-dir', str(tmp_path / 'four')]!r}\n" + _LAUNCH
    four = json.loads(run_ranks(code, 4, timeout=150)[0].splitlines()[-1])
    assert len(four) == len(one) == 4
    for a, b in zip(four, one):
        assert abs(a - b) <= PARTITION_LOSS * abs(b), (four, one)
    with pytest.raises(ValueError):
        launch_train.mesh_dims("2x2x2x2")
