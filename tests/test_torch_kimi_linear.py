"""Kimi-Linear-48B-A3B on the port (Kimi Delta Attention beside latent
attention without RoPE, sigmoid-routed experts of which the model holds a
share) against the benchmark's plain float32 reference
(``portbench/reference/kimi_linear.py``), at the smoke sizes on the CPU,
with the weights the benchmark draws from a seed.

Tolerances, in units of the reference's largest logit (``scale``):

* the port cast to f32, its forward and its prefill then decode steps
  through the cache (the served bf16 latents and convolution inputs
  replaced by the prefill's f32 ones), against the reference's one
  forward: ``2e-5 * scale`` (the same f32 arithmetic grouped otherwise:
  the chunked recurrence's solve and products, the absorbed attention;
  measured 1.3e-6 to 3.8e-6 over 10 seeds);
* the bf16 port over the served bf16 cache, the same path, with the held
  experts' down products zeroed in both (so a routing pick that bf16
  rounding reverses changes nothing): a position's largest error within
  ``0.04 * scale`` at the median position and ``0.12 * scale`` at the
  worst (bf16 products round a few steps a layer and compound; measured
  0.014-0.024 and 0.028-0.073 over 10 seeds);
* the bf16 port with its experts: ``0.1 * scale`` at the median position
  and ``0.15 * scale`` on average (measured 0.021-0.078 and 0.021-0.104
  over 10 seeds): 4 of the smoke layer's 16 experts are picked by margins
  that bf16 rounding reverses, and a reversed pick of a held expert moves
  the positions after it by up to half the scale, so no bound is put on
  the largest (the f32 and expert-free cases hold every position);
* the chunked recurrence against the token-by-token one (f32, unit-norm
  keys): ``2e-5`` absolute on outputs and state of order 1 (measured
  below 3e-6);
* the held-experts share in f32: the shares of one layer summed, the
  shared expert once, within ``1e-5 * max|out|`` of the uncut layer.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights  # noqa: E402
from portbench.harness import load_config  # noqa: E402
from portbench.models import kimi_linear as fam  # noqa: E402
from portbench.reference import kimi_linear as ref  # noqa: E402
from portbench.reference import mla_moe as ref_moe  # noqa: E402
from repro_torch.configs.kimi_linear_48b import (CONFIG, SMOKE,  # noqa: E402
                                                 published_layers)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import components as comp  # noqa: E402
from repro_torch.models import kda  # noqa: E402
from repro_torch.models.config import (ATTN_MLA, MIX_KDA,  # noqa: E402
                                       MoeSpec)

NAME = "kimi-linear-48b-ep8"
SEEDS = [0, 1, 2]


def _model(seed, dtype=torch.bfloat16):
    """The port's model at the configuration's smoke sizes (4 of 16
    experts held), the benchmark's weights for ``seed`` bound into it, in
    ``dtype``; with the reference's weights getter."""
    cfg = load_config(NAME, smoke=True)
    m = Model(fam.port_config(cfg)).init(torch.Generator().manual_seed(0),
                                          "cpu")
    groups = fam.layout(cfg)
    weights.bind(m, groups, seed)
    get = weights.reference_weights(groups, seed, torch.device("cpu"))
    return cfg, m.to(dtype), get


def _tokens(seed, N=2, T=20):
    return torch.randint(0, 512, (N, T),
                         generator=torch.Generator().manual_seed(100 + seed))


def _served(m, tokens, P):
    """Logits at positions P-1 .. T-1: the prefill's last, then the decode
    steps fed the true tokens (``decode_step_`` over one cache, as the
    graphed step runs it). The served latents and convolution inputs are
    bf16; a model in another dtype gets the prefill's in its own, so the
    exact cases round nothing."""
    T = tokens.shape[1]
    logits, cache = m.prefill(tokens[:, :P], T)
    dtype = next(m.parameters()).dtype
    if dtype != torch.bfloat16:
        with torch.no_grad():
            _, _, blobs = m.forward(tokens[:, :P], want_cache=True)
        for cb, blob in zip(cache, blobs):
            if "latent" in cb:
                cb["latent"] = cb["latent"].to(dtype)
                cb["latent"][:, :P] = blob["latent"]
            if "conv" in cb:
                cb["conv"] = blob["conv"].clone()
    out = [logits[:, -1]]
    for t in range(P, T):
        pos = torch.full((), t, dtype=torch.int64)
        out.append(m.decode_step_(cache, tokens[:, t:t + 1], pos)[:, -1])
    return torch.stack(out, dim=1).float()


@pytest.mark.parametrize("seed", SEEDS)
def test_f32_forward_against_the_reference(seed):
    cfg, m, get = _model(seed, torch.float32)
    tokens = _tokens(seed, N=3, T=40)
    with torch.no_grad():
        port, _, _ = m.forward(tokens)
    want = ref.logits(cfg, get, tokens, 0)
    scale = float(want.abs().max())
    assert float((port - want).abs().max()) < 2e-5 * scale


@pytest.mark.parametrize("seed", SEEDS)
def test_f32_prefill_and_decode_against_the_reference(seed):
    cfg, m, get = _model(seed, torch.float32)
    tokens, P = _tokens(seed), 12
    want = ref.logits(cfg, get, tokens, P - 1)
    got = _served(m, tokens, P)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 2e-5 * scale


def _without_routed_experts(seed):
    """``_model`` in bf16 with every held expert's down product zeroed, in
    the port and in the reference's weights alike."""
    cfg, m, get = _model(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("ffn.w2") and p.dim() == 3:
                p.zero_()

    def get0(g):
        return {k: torch.zeros_like(v) if k.endswith("mlp.experts.down_proj")
                else v for k, v in get(g).items()}
    return cfg, m, get0


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_prefill_and_decode_against_the_reference(seed):
    cfg, m, get = _without_routed_experts(seed)
    tokens, P = _tokens(seed), 12
    want = ref.logits(cfg, get, tokens, P - 1)
    got = _served(m, tokens, P)
    scale = float(want.abs().max())
    worst = (got - want).abs().amax(dim=-1)          # a position's largest
    assert float(worst.median()) < 0.04 * scale
    assert float(worst.max()) < 0.12 * scale


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_with_experts_against_the_reference(seed):
    cfg, m, get = _model(seed)
    tokens, P = _tokens(seed), 12
    want = ref.logits(cfg, get, tokens, P - 1)
    got = _served(m, tokens, P)
    scale = float(want.abs().max())
    worst = (got - want).abs().amax(dim=-1)
    assert float(worst.median()) < 0.1 * scale
    assert float(worst.mean()) < 0.15 * scale


def _inputs(seed, B=2, S=37, H=3, K=8, V=6, decay=0.05):
    """Unit-norm q and k, values, decays ``-decay * U(0, 1)`` a channel
    and token, beta in (0, 1), all f32."""
    g = torch.Generator().manual_seed(seed)
    q = F.normalize(torch.randn(B, S, H, K, generator=g), dim=-1)
    k = F.normalize(torch.randn(B, S, H, K, generator=g), dim=-1)
    v = torch.randn(B, S, H, V, generator=g)
    gate = -decay * torch.rand(B, S, H, K, generator=g)
    beta = torch.rand(B, S, H, generator=g)
    return q, k, v, gate, beta


def _recurrence_state(q, k, v, g, beta, state):
    """The port's own decode step over every token: (o, final state)."""
    s = state.clone()
    o = [kda.kda_step_(s, q[:, t], k[:, t], v[:, t], g[:, t], beta[:, t])
         for t in range(k.shape[1])]
    return torch.stack(o, dim=1), s


@pytest.mark.parametrize("chunk", [4, 8, 64])
@pytest.mark.parametrize("decay", [0.05, 6.0])
def test_chunked_against_the_recurrence(chunk, decay):
    """37 positions (not a whole number of chunks; 9, 4 and 0 whole chunks
    of 4, 8, 64): the chunked form against the reference's token-by-token
    definition and the port's own step. A decay of up to 6 a token sums
    to -220 over 64 positions: exp(+220) would overflow f32."""
    q, k, v, g, beta = _inputs(1, decay=decay)
    want = ref.kda_recurrence(q, k, v, g, beta)
    o, s = kda.kda_chunked(q, k, v, g, beta, chunk=chunk)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    assert torch.allclose(o, want, atol=2e-5, rtol=0)
    o_step, s_step = _recurrence_state(q, k, v, g, beta,
                                       torch.zeros_like(s))
    assert torch.allclose(o_step, want, atol=2e-5, rtol=0)
    assert torch.allclose(s, s_step, atol=2e-5, rtol=0)


def test_chunked_evaluates_no_positive_exponent(monkeypatch):
    """Every ``torch.exp`` the chunked form calls has arguments <= 0,
    under decays strong enough to overflow a naive exponent."""
    seen = []
    real = torch.exp

    def exp(x, *a, **kw):
        seen.append(float(x.max()))
        return real(x, *a, **kw)
    monkeypatch.setattr(torch, "exp", exp)
    q, k, v, g, beta = _inputs(3, decay=6.0)
    kda.kda_chunked(q, k, v, g, beta, chunk=16)
    assert seen and max(seen) <= 0.0


_TRANSFORMERS = """
import sys, torch
from transformers.models.qwen3_next.modeling_qwen3_next import (
    torch_recurrent_gated_delta_rule)
q, k, v, g, beta = torch.load(sys.argv[1])
o, s = torch_recurrent_gated_delta_rule(q, k, v, g, beta, None, True,
                                        use_qk_l2norm_in_kernel=True)
torch.save((o, s), sys.argv[2])
"""


def test_equal_decay_against_transformers_delta_rule(tmp_path):
    """With one decay for every key channel of a head, Kimi Delta
    Attention is the gated delta rule of Qwen3-Next as ``transformers``
    writes it (``torch_recurrent_gated_delta_rule``, its q and k
    L2-normalised with eps 1e-6 and q scaled by K^-0.5 as here). It runs
    in a process of its own (``transformers`` pulls in more frameworks
    than the port's tests need)."""
    pytest.importorskip("transformers")
    g = torch.Generator().manual_seed(4)
    B, S, H, K, V = 2, 21, 3, 8, 8
    q, k = (torch.randn(B, S, H, K, generator=g) for _ in range(2))
    v = torch.randn(B, S, H, V, generator=g)
    g_head = -torch.rand(B, S, H, generator=g)
    beta = torch.rand(B, S, H, generator=g)
    torch.save((q, k, v, g_head, beta), tmp_path / "in.pt")
    env = dict(os.environ, USE_TF="0", USE_FLAX="0", USE_TORCH="1")
    out = subprocess.run([sys.executable, "-c", _TRANSFORMERS,
                          str(tmp_path / "in.pt"), str(tmp_path / "out.pt")],
                         capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    want_o, want_s = torch.load(tmp_path / "out.pt")
    qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-6) * K ** -0.5
    kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-6)
    gk = g_head[..., None].expand(B, S, H, K)
    o, s = kda.kda_chunked(qn, kn, v, gk, beta, chunk=8)
    assert torch.allclose(o, want_o, atol=2e-5, rtol=0)
    assert torch.allclose(s, want_s, atol=2e-5, rtol=0)


def test_published_layer_lists_map_to_kinds():
    cfg = load_config(NAME)
    la = cfg["linear_attn_config"]
    kinds = [s.mix for s in CONFIG.layers]
    assert len(kinds) == 27 == CONFIG.n_layers
    assert [n + 1 for n, m in enumerate(kinds) if m == MIX_KDA] == \
        la["kda_layers"]
    assert [n + 1 for n, m in enumerate(kinds) if m == ATTN_MLA] == \
        la["full_attn_layers"] == [4, 8, 12, 16, 20, 24, 27]
    assert [s.ffn for s in CONFIG.layers] == ["dense"] + ["moe"] * 26
    assert fam.port_config(cfg).layers == CONFIG.layers
    # the port's smoke twin is the benchmark's smoke sizes, every expert held
    smoke = fam.port_config(load_config(NAME, smoke=True))
    assert dataclasses.replace(smoke, name=SMOKE.name, moe=SMOKE.moe) == SMOKE
    assert CONFIG.n_super == 0 and CONFIG.tail_specs == ()
    with pytest.raises(ValueError):
        published_layers([1, 2], [2, 3], 1)             # layer 2 twice
    with pytest.raises(ValueError):
        published_layers([1, 2], [4], 1)                # layer 3 missing


def test_the_cache_holds_the_state_and_the_latents():
    """At Kimi Linear's widths: a KDA layer keeps a (B, 32, 128, 128) f32
    state and its convolution's last 3 inputs of q, k and v; a latent
    attention layer its 576-wide bf16 latents."""
    from repro_torch.models.transformer import init_layer_cache
    meta = torch.device("meta")
    blob = init_layer_cache(CONFIG, CONFIG.layers[0], 2, 10, meta)
    assert {k: (tuple(t.shape), t.dtype) for k, t in blob.items()} == {
        "s": ((2, 32, 128, 128), torch.float32),
        "conv": ((2, 3, 3 * 4096), torch.bfloat16)}
    blob = init_layer_cache(CONFIG, CONFIG.layers[3], 2, 10, meta)
    assert {k: (tuple(t.shape), t.dtype) for k, t in blob.items()} == {
        "latent": ((2, 10, 576), torch.bfloat16)}


def test_decode_writes_the_state_in_place():
    """A decode step writes each KDA layer's state and convolution inputs
    into the tensors the cache already holds (what a captured graph
    replays); ``decode_step`` leaves the old cache as it was."""
    _, m, _ = _model(5)
    tokens = _tokens(5)
    _, cache = m.prefill(tokens[:, :8], 12)
    kda_layers = [cb for cb in cache if "s" in cb]
    ptrs = [(cb["s"].data_ptr(), cb["conv"].data_ptr()) for cb in kda_layers]
    before = [cb["s"].clone() for cb in kda_layers]
    _, new = m.decode_step(cache, tokens[:, 8:9], 8)
    assert all(torch.equal(cb["s"], b) for cb, b in zip(kda_layers, before))
    m.decode_step_(cache, tokens[:, 8:9], torch.tensor(8))
    assert [(cb["s"].data_ptr(), cb["conv"].data_ptr())
            for cb in kda_layers] == ptrs
    for cb, b, n in zip(kda_layers, before,
                        [c for c in new if "s" in c]):
        assert not torch.equal(cb["s"], b)
        assert torch.equal(cb["s"], n["s"])


def test_kda_runs_on_one_rank_only():
    from repro_torch.models.transformer import apply_layer_step_
    _, m, _ = _model(6)
    cache = m.init_cache(2, 4)
    x = torch.zeros((2, 1, m.cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Kimi Delta Attention"):
        apply_layer_step_(m.cfg, m.cfg.layers[0], m.layers[0], cache[0], x,
                          torch.tensor(0), SimpleNamespace(trivial=False))


def _layer(seed, E=16, T=24, D=32, F_=16):
    g = torch.Generator().manual_seed(seed)
    w = {"gate.weight": torch.randn(D, E, generator=g) * 0.3,
         "gate.e_score_correction_bias": torch.randn(E, generator=g) * 0.05,
         "experts.gate_proj": torch.randn(E, D, F_, generator=g) / D ** 0.5,
         "experts.up_proj": torch.randn(E, D, F_, generator=g) / D ** 0.5,
         "experts.down_proj": torch.randn(E, F_, D, generator=g) / F_ ** 0.5,
         "shared_experts.gate_proj": torch.randn(D, F_, generator=g)
         / D ** 0.5,
         "shared_experts.up_proj": torch.randn(D, F_, generator=g) / D ** 0.5,
         "shared_experts.down_proj": torch.randn(F_, D, generator=g)
         / F_ ** 0.5}
    return {f"mlp.{k}": v for k, v in w.items()}, torch.randn(
        2, T // 2, D, generator=g)


def _held(w, x, first, n, E=16, k=4):
    """The port's held layer (Kimi Linear's router: top k by sigmoid
    scores and the bias, renormalised, times 2.446), experts first ..
    first + n - 1."""
    spec = MoeSpec(num_experts=E, top_k=k, shared_expert=True,
                   scoring="sigmoid", routed_scale=2.446, held=n,
                   held_first=first)
    sl = slice(first, first + n)
    return comp.moe_held_forward(
        x, w["mlp.gate.weight"], w["mlp.gate.e_score_correction_bias"],
        w["mlp.experts.gate_proj"][sl], w["mlp.experts.up_proj"][sl],
        w["mlp.experts.down_proj"][sl], spec,
        (w["mlp.shared_experts.gate_proj"], w["mlp.shared_experts.up_proj"],
         w["mlp.shared_experts.down_proj"]))[0]


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("held", [2, 4, 8])
def test_shares_sum_to_the_whole_layer(held, decode):
    """Every share of the layer's 16 experts (16 / held chips), each the
    port's held layer, summed with the shared expert counted once, is the
    reference's uncut layer (every expert held); ``decode``: one position
    a sequence (the graphed step's static slots)."""
    w, x = _layer(held)
    if decode:
        x = x.reshape(-1, 1, x.shape[-1])
    xt = x.reshape(-1, x.shape[-1])
    shared = ref_moe._swiglu(xt, w["mlp.shared_experts.gate_proj"],
                             w["mlp.shared_experts.up_proj"],
                             w["mlp.shared_experts.down_proj"], "f32")
    parts = sum(_held(w, x, first, held).reshape(xt.shape)
                for first in range(0, 16, held))
    uncut = ref._moe_keys({"num_experts_per_token": 4,
                           "routed_scaling_factor": 2.446, "num_experts": 16,
                           "held_first": 0})
    whole = ref_moe._moe(uncut, w, "mlp", x, "f32", None).reshape(xt.shape)
    total = parts - (16 // held - 1) * shared
    assert torch.allclose(total, whole, atol=1e-5 * float(whole.abs().max()),
                          rtol=0)


def test_param_counts_follow_the_share():
    from portbench.count import kimi_linear as count
    cut = dataclasses.replace(CONFIG, moe=dataclasses.replace(
        CONFIG.moe, held=32))
    assert cut.param_count() == 7_901_062_016 == count.parameters(
        load_config(NAME))
    cfg = load_config(NAME, smoke=True)
    _, m, _ = _model(0)
    assert fam.port_config(cfg).param_count() == sum(
        p.numel() for p in m.parameters()) == count.parameters(cfg)
    # each held expert layer is 3 D Fe a held expert more
    whole = dataclasses.replace(CONFIG, moe=dataclasses.replace(
        CONFIG.moe, held=0))
    assert whole.param_count() - cut.param_count() == \
        26 * (256 - 32) * 3 * 2304 * 1024


def test_spans_and_counters_of_the_block():
    """Under a trace with a timeline (the host clock on the CPU): each
    decode step's KDA layers open ``decode.mix`` > ``.kda_in``,
    ``.kda_state``, ``.kda_out``, its latent attention layers ``.q``,
    ``.kv_write``, ``.attend``, ``.out``, its held-expert layers
    ``decode.ffn`` > ``.route``, ``.experts``, ``.shared``, ``.combine``;
    the prefill ``prefill.mix`` > ``.kda_chunk`` a KDA layer; the counters
    read the held experts' rows; the tokens are those of an untraced
    run."""
    from repro_torch.core.telemetry import MetricRegistry
    from repro_torch.runtime import spans
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    _, m, _ = _model(7)
    tokens, P, steps = _tokens(7), 12, 3
    B = tokens.shape[0]
    n_kda = sum(s.mix == MIX_KDA for s in m.cfg.layers)
    n_mla = m.cfg.n_layers - n_kda
    n_moe = sum(s.ffn == "moe" for s in m.cfg.layers)

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
    pre = [r[0] for r in reads[0]]
    assert pre.count("prefill.mix") == m.cfg.n_layers
    assert pre.count("prefill.mix.kda_chunk") == n_kda
    for step in reads[1:]:
        names = [r[0] for r in step]
        for child in (".kda_in", ".kda_state", ".kda_out"):
            assert names.count("decode.mix" + child) == n_kda
        for child in (".q", ".kv_write", ".attend", ".out"):
            assert names.count("decode.mix" + child) == n_mla
        for child in (".route", ".experts", ".shared", ".combine"):
            assert names.count("decode.ffn" + child) == n_moe
    got = reg.counter_values()
    assert got["moe_slots"] > n_moe * steps * 4 * B
    assert 0 < got["moe_tokens_kept"] <= got["moe_slots"]


def test_configuration_file_holds_the_published_numbers():
    """Every number of the published config.json is in the file under its
    own key, the held experts' count (``num_experts``, in ``reduced``)
    aside."""
    cfg = load_config(NAME)
    published = {
        "first_k_dense_replace": 1, "head_dim": 72, "hidden_size": 2304,
        "intermediate_size": 9216, "kv_lora_rank": 512,
        "model_max_length": 1048576, "moe_intermediate_size": 1024,
        "moe_layer_freq": 1, "num_attention_heads": 32,
        "num_expert_group": 1, "num_experts_per_token": 8,
        "num_hidden_layers": 27, "num_key_value_heads": 32,
        "num_nextn_predict_layers": 0, "num_shared_experts": 1,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
        "rms_norm_eps": 1e-5, "rope_theta": 10000,
        "routed_scaling_factor": 2.446, "topk_group": 1, "v_head_dim": 128,
        "vocab_size": 163840, "q_lora_rank": None, "rope_scaling": None,
        "mla_use_nope": True}
    assert {k: cfg[k] for k in published} == published
    assert cfg["linear_attn_config"] == {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                       21, 22, 23, 25, 26],
        "num_heads": 32, "short_conv_kernel_size": 4}
    assert cfg["reduced"] == ["num_experts"]
    assert (cfg["num_experts"], cfg["published_num_experts"]) == (32, 256)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == NAME)
    assert entry["reduced"] == cfg["reduced"]
    assert entry["source"] == cfg["source"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed step runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_model(seed, device):
    cfg = load_config(NAME, smoke=True)
    m = Model(fam.port_config(cfg)).init(
        torch.Generator(device=device).manual_seed(0), device)
    groups = fam.layout(cfg)
    weights.bind(m, groups, seed)
    return cfg, m, weights.reference_weights(groups, seed, device)


@pytest.mark.cuda
def test_cuda_f32_forward_against_the_reference(cuda_device):
    """The chunked prefill's solve and products on the card, in f32,
    against the reference there (TF32 off): the CPU case's tolerance."""
    cfg, m, get = _cuda_model(8, cuda_device)
    m.float()
    tokens = _tokens(8, N=3, T=40).to(cuda_device)
    with torch.no_grad():
        port, _, _ = m.forward(tokens)
    want = ref.logits(cfg, get, tokens, 0)
    assert float((port - want).abs().max()) < 2e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_cuda_graphed_step_equals_eager(cuda_device):
    """16 greedy steps over a cache holding KDA states and latents side by
    side: the graphed step gives the eager step's tokens, logits and final
    cache bit for bit, and writes the states where the static cache holds
    them."""
    from repro_torch.serve.serve_step import (GraphedServeStep,
                                              make_prefill, make_serve_step)
    _, m, _ = _cuda_model(9, cuda_device)
    prompt = _tokens(9, T=12).to(cuda_device)
    B, P, n = prompt.shape[0], prompt.shape[1], 16
    last, cache0 = make_prefill(m, P + n)(prompt)
    first = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    cache, nxt, toks, logits = cache0, first, [], []
    for i in range(n):
        lg, cache = m.decode_step(cache, nxt, P + i)
        nxt = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        toks.append(nxt)
        logits.append(lg[:, -1])
    step = make_serve_step(m)
    assert isinstance(step, GraphedServeStep)
    step.capture(B, P + n)
    gcache, gnxt = cache0, first
    for i in range(n):
        gnxt, gcache = step(gcache, gnxt, P + i)
        if i == 0:
            ptrs = [cb["s"].data_ptr() for cb in gcache if "s" in cb]
        assert torch.equal(gnxt, toks[i]), i
        assert torch.equal(step.logits, logits[i]), i
    assert [cb["s"].data_ptr() for cb in gcache if "s" in cb] == ptrs
    assert all(torch.equal(g[k], e[k]) for g, e in zip(gcache, cache)
               for k in g)
