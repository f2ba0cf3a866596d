"""Kimi-K2's block on the port (latent attention over a latent cache,
sigmoid-routed experts of which the model holds a share) against the
plain float32 reference of ``tests/mla_moe_reference.py``, at the smoke
sizes on the CPU.

Tolerances, in units of the reference's largest logit (``scale``):

* the port cast to f32, prefill then decode steps through the cache
  (its bf16 latents replaced by the prefill's f32 ones), against the
  reference's one forward, and the absorbed decode against the expanded
  prefill of the same positions:
  ``2e-5 * scale`` (the same f32 arithmetic grouped otherwise: the
  absorbed products sum the latent's 16 dims where the expanded ones sum
  the head's; measured 1e-6 to 3e-6 over 10 seeds);
* the bf16 port over the served bf16 cache, the same path: a position's
  largest error within ``0.03 * scale`` at the median position (bf16
  products round a few steps a layer and compound; measured 0.010-0.016
  over 10 seeds) and ``0.06 * scale`` on average over the positions
  (0.013-0.038): the smoke layer picks 4 of 16 experts by margins that
  bf16 rounding can reverse, and a reversed pick moves the positions
  after it by up to 0.43 of the scale (1 seed of 10), so no bound is put
  on the largest (the f32 cases hold every position);
* the held-experts share in f32: the shares of one layer summed, the
  shared expert once, within ``1e-5 * max|out|`` of the uncut layer (the
  same f32 products summed in another order).
"""
import dataclasses

import pytest
import torch

import mla_moe_reference as ref
from repro_torch.configs.kimi_k2 import CONFIG, SMOKE
from repro_torch.models import Model
from repro_torch.models import components as comp
from repro_torch.models.config import MoeSpec

SEEDS = [0, 1, 2]
# 4 of the smoke layer's 16 experts held, from expert 4: the chip is rank 1
HELD = dataclasses.replace(SMOKE, moe=dataclasses.replace(
    SMOKE.moe, held=4, held_first=4))


def _model(seed, cfg=HELD, dtype=torch.bfloat16):
    """The port's model with its norms and selection biases drawn too
    (init leaves them 0), in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    m = Model(cfg).init(g, "cpu")
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith((".w", "_norm")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
            elif name.endswith("router_bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return m.to(dtype)


def _params(m):
    return {k: v.detach() for k, v in m.named_parameters()}


def _served(m, tokens, P):
    """Logits at positions P-1 .. T-1: the prefill's last, then the
    decode steps fed the true tokens (``decode_step_`` over one cache, as
    the graphed step runs it). The served latent cache is bf16; a model in
    another dtype gets the prefill's latents in its own, so the exact cases
    round nothing."""
    T = tokens.shape[1]
    logits, cache = m.prefill(tokens[:, :P], T)
    dtype = next(m.parameters()).dtype
    if dtype != torch.bfloat16:
        with torch.no_grad():
            _, _, blobs = m.forward(tokens[:, :P], want_cache=True)
        for cb, blob in zip(cache, blobs):
            cb["latent"] = cb["latent"].to(dtype)
            cb["latent"][:, :P] = blob["latent"]
    out = [logits[:, -1]]
    for t in range(P, T):
        pos = torch.full((), t, dtype=torch.int64)
        out.append(m.decode_step_(cache, tokens[:, t:t + 1], pos)[:, -1])
    return torch.stack(out, dim=1).float()


def _tokens(seed, N=2, T=20):
    return torch.randint(0, HELD.vocab, (N, T),
                         generator=torch.Generator().manual_seed(100 + seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_f32_prefill_and_decode_against_the_reference(seed):
    m = _model(seed, dtype=torch.float32)
    tokens, P = _tokens(seed), 12
    want = ref.logits(HELD, _params(m), tokens)[:, P - 1:]
    got = _served(m, tokens, P)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 2e-5 * scale


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_prefill_and_decode_against_the_reference(seed):
    m = _model(seed)
    tokens, P = _tokens(seed), 12
    want = ref.logits(HELD, _params(m), tokens)[:, P - 1:]
    got = _served(m, tokens, P)
    scale = float(want.abs().max())
    worst = (got - want).abs().amax(dim=-1)          # a position's largest
    assert float(worst.median()) < 0.03 * scale
    assert float(worst.mean()) < 0.06 * scale


@pytest.mark.parametrize("seed", SEEDS)
def test_absorbed_decode_against_the_expanded_prefill(seed):
    m = _model(seed, dtype=torch.float32)
    tokens, P = _tokens(seed), 8
    with torch.no_grad():
        full, _, _ = m.forward(tokens)
    want = full[:, P - 1:].float()
    got = _served(m, tokens, P)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 2e-5 * scale


def test_the_latent_cache_holds_576_a_position_at_kimi_widths():
    from repro_torch.models.transformer import init_layer_cache
    blob = init_layer_cache(CONFIG, CONFIG.layers[0], 2, 10,
                            torch.device("meta"))
    assert list(blob) == ["latent"]
    assert blob["latent"].shape == (2, 10, 576)
    assert blob["latent"].dtype == torch.bfloat16     # 1,152 B a position
    assert CONFIG.layers[0].ffn == "dense" and all(
        s.ffn == "moe" for s in CONFIG.layers[1:])
    assert len(CONFIG.layers) == 61


def test_yarn_frequencies_and_scale_against_the_formula():
    inv = comp.yarn_inv_freq(64, 50000.0, CONFIG.yarn)
    want, scale = ref.yarn_tables(CONFIG)
    assert torch.allclose(inv, want, rtol=1e-6, atol=0)
    # beta_fast = beta_slow = 1 over 4,096 positions: the correction
    # dimension 64 ln(4096 / 2 pi) / (2 ln 50000) = 19.16, so the first 20
    # frequencies keep theta's and the last 12 are divided by 32
    base = 50000.0 ** (-torch.arange(32, dtype=torch.float32) / 32)
    assert torch.allclose(inv[:20], base[:20], rtol=1e-6)
    assert torch.allclose(inv[20:], base[20:] / 32, rtol=1e-6)
    assert scale == pytest.approx(192 ** -0.5 * 1.8133, rel=1e-4)
    assert comp.yarn_mscale(32.0, 1.0) ** 2 == pytest.approx(1.8133,
                                                              abs=1e-4)
    assert comp.yarn_mscale(1.0, 1.0) == 1.0


def _layer(seed, E=16, k=4, T=24, D=32, F=16):
    g = torch.Generator().manual_seed(seed)
    w = {"router": torch.randn(D, E, generator=g) * 0.3,
         "router_bias": torch.randn(E, generator=g) * 0.05,
         "w1": torch.randn(E, D, F, generator=g) / D ** 0.5,
         "w3": torch.randn(E, D, F, generator=g) / D ** 0.5,
         "w2": torch.randn(E, F, D, generator=g) / F ** 0.5,
         "s1": torch.randn(D, F, generator=g) / D ** 0.5,
         "s3": torch.randn(D, F, generator=g) / D ** 0.5,
         "s2": torch.randn(F, D, generator=g) / F ** 0.5}
    x = torch.randn(2, T // 2, D, generator=g)
    return w, x


def _held(w, x, first, n, E=16, k=4):
    """The port's layer holding experts first .. first + n - 1."""
    spec = MoeSpec(num_experts=E, top_k=k, shared_expert=True,
                   scoring="sigmoid", routed_scale=2.827, held=n,
                   held_first=first)
    sl = slice(first, first + n)
    return comp.moe_held_forward(
        x, w["router"], w["router_bias"], w["w1"][sl], w["w3"][sl],
        w["w2"][sl], spec, (w["s1"], w["s3"], w["s2"]))[0]


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("held", [2, 4, 8])
def test_shares_sum_to_the_whole_layer(held, decode):
    """Every share of the layer's 16 experts (16 / held chips), each the
    port's held layer, summed with the shared expert counted once, is the
    uncut reference's whole layer; ``decode``: one position a sequence
    (the graphed step's static slots) instead of the grouped dispatch."""
    w, x = _layer(held)
    if decode:
        x = x.reshape(-1, 1, x.shape[-1])
    shared = ref.swiglu(x.reshape(-1, x.shape[-1]), w["s1"], w["s3"],
                        w["s2"])
    parts = sum(_held(w, x, first, held).reshape(-1, x.shape[-1])
                for first in range(0, 16, held))
    cfg = _moe_cfg(16, 4, 2.827)
    whole = ref.moe(cfg, {f"f.{k}": v for k, v in w.items()}, "f",
                    x.reshape(-1, x.shape[-1]), 0, 16)
    total = parts - (16 // held - 1) * shared
    assert torch.allclose(total, whole, atol=1e-5 * float(whole.abs().max()),
                          rtol=0)


@dataclasses.dataclass
class _Moe:
    num_experts: int
    top_k: int
    routed_scale: float

    @property
    def n_held(self):
        return self.num_experts


def _moe_cfg(E, k, scale):
    """A config namespace holding only what ``ref.moe`` reads."""
    return type("Cfg", (), {"moe": _Moe(E, k, scale)})()


@pytest.mark.parametrize("decode", [False, True])
def test_every_token_on_one_held_expert_drops_nothing(decode):
    """A router that sends every token to held expert 5 (the chip holds 4
    of 16 from 4): the layer computes each token's row, none dropped, as
    the reference does; the capacity dispatch at this load would keep
    8 of 24."""
    w, x = _layer(7)
    w["router_bias"] = w["router_bias"].clone()
    w["router_bias"][5] = 10.0
    if decode:
        x = x.reshape(-1, 1, x.shape[-1])
    xt = x.reshape(-1, x.shape[-1])
    scores = torch.sigmoid(xt @ w["router"])
    top = torch.topk(scores + w["router_bias"], 4).indices
    assert bool((top == 5).any(dim=-1).all())
    got = _held(w, x, 4, 4).reshape(xt.shape)
    cfg = _moe_cfg(16, 4, 2.827)
    mine = {f"f.{k}": v[4:8] if k in ("w1", "w3", "w2") else v
            for k, v in w.items()}
    want = ref.moe(cfg, mine, "f", xt, 4, 4)
    assert torch.allclose(got, want, atol=1e-5 * float(want.abs().max()),
                          rtol=0)
    # without expert 5's rows the layer would differ
    w["w2"][5].zero_()
    assert not torch.allclose(_held(w, x, 4, 4).reshape(xt.shape), want,
                              atol=1e-3 * float(want.abs().max()), rtol=0)


def test_param_counts_follow_the_share():
    cut = dataclasses.replace(CONFIG, n_layers=13, moe=dataclasses.replace(
        CONFIG.moe, held=8))
    assert cut.param_count() == 8_849_354_240
    m = Model(HELD).init(torch.Generator().manual_seed(0), "cpu")
    assert HELD.param_count() == sum(p.numel() for p in m.parameters())
    # a token's routed experts here: k * held / E = 4 * 4 / 16 of 4 held
    routed = 3 * HELD.d_model * HELD.expert_width
    assert HELD.param_count() - HELD.active_param_count() == \
        (HELD.n_layers - 1) * 3 * routed


def test_spans_and_counters_of_the_block():
    """Under a trace with a timeline (the host clock on the CPU): each
    decode step's latent-attention layers open ``decode.mix`` > ``.q``,
    ``.kv_write``, ``.attend``, ``.out`` and the held-expert layers
    ``decode.ffn`` > ``.route``, ``.experts``, ``.shared``, ``.combine``;
    the prefill ``prefill.mix``; the counters read the rows computed for
    held experts (``moe_tokens_kept``) and the rows given them
    (``moe_slots``: the kept rows in the prefill's grouped dispatch, held
    x batch in a step); the tokens are those of an untraced run."""
    from repro_torch.core.telemetry import MetricRegistry
    from repro_torch.runtime import spans
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    m = _model(4)
    tokens, P, steps = _tokens(4), 12, 3
    B = tokens.shape[0]

    def serve(after=lambda: None):
        logits, cache = make_prefill(m, P + steps)(tokens[:, :P])
        after()
        nxt, out = logits.argmax(-1).to(torch.int32)[:, None], []
        step = make_serve_step(m)
        for i in range(steps):
            nxt, cache = step(cache, nxt, P + i)
            out.append(nxt)
            after()
        return torch.cat(out, dim=1)

    plain = serve()
    reg, reads = MetricRegistry(), []
    with reg.trace("root"), spans.Timeline("cpu") as tl:
        traced = serve(lambda: reads.append(tl.read()))
    assert torch.equal(plain, traced)
    n = HELD.n_layers
    assert [r[0] for r in reads[0]].count("prefill.mix") == n
    for step in reads[1:]:
        names = [r[0] for r in step]
        for child in (".q", ".kv_write", ".attend", ".out"):
            assert names.count("decode.mix" + child) == n
        for child in (".route", ".experts", ".shared", ".combine"):
            assert names.count("decode.ffn" + child) == n - 1
    # the prefill's rows, counted apart, then 4 held experts x B slots a
    # MoE layer a step, of which the step keeps the routed ones
    got, pre = reg.counter_values(), _prefill_kept(m, tokens[:, :P])
    assert got["moe_slots"] == pre + (n - 1) * steps * 4 * B
    assert pre < got["moe_tokens_kept"] < got["moe_slots"]


def _prefill_kept(m, tokens):
    """Rows the prefill's grouped dispatch computes, counted apart under
    a timeline of its own."""
    from repro_torch.core.telemetry import MetricRegistry
    from repro_torch.runtime import spans
    reg = MetricRegistry()
    with reg.trace("root"), spans.Timeline("cpu"):
        m.prefill(tokens, tokens.shape[1] + 1)
    got = reg.counter_values()
    assert got["moe_tokens_kept"] == got["moe_slots"]       # nothing held back
    return got["moe_tokens_kept"]
