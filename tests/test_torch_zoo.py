"""The rest of the model zoo, one layer and one forward at a time: MoE
FFNs (mixtral-8x22b, llama4-maverick), cross-attention (llama3.2-vision)
and the whisper encoder, and the int8 KV cache, the port against the JAX
package (``zoo_pairs.Pair``: the reference's parameters with every
cross-attention gate at 0.5, carried into the port; the same tokens and
bf16 ``extras``, made from a seed with numpy, through both).
``test_torch_zoo_decode.py`` holds the prefill and decode paths.

Tolerances, all in units of the reference's own scale (as
``tests/test_torch_models.py``):

* one layer, in sequence or step mode: the bf16 output within ``2^-6 *
  max|out|``; cache entries as there (an int8 entry within ``2^-6 * 127``,
  one int8 step, f32 scales within ``1e-3`` of their largest), the MoE aux
  loss within ``1e-5`` relative;
* a whole model (forward logits, the encoder's output): the reference's
  decode-consistency bound ``0.05 * scale + 0.05``;
* the int8 quantization and its dequantization: bit for bit, on the same
  input.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.configs import get_config
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.models import Model
from repro_torch.models import transformer as tt
from zoo_pairs import (ARCHS, B, CROSS, GATE, INT8, KEY, S, bound, close_blob,
                       close_bf16, configs, extras_np, get_pair, to_np, tx)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_converted_reference(arch):
    """The port's own init gives the reference's names, shapes and dtypes
    (the 3-D experts, the 0-d gates, the encoder a module a layer,
    ``pos_embed``) and its scale rules."""
    p = get_pair(arch)
    want = convert.model_state_dict(
        jax.tree.map(np.asarray, p.ref.init(KEY)), p.cfg)
    drawn = Model(torch_config(arch, smoke=True)).init(
        torch.Generator().manual_seed(5), device="cpu").state_dict()
    assert sorted(drawn) == sorted(want)
    for key, w in want.items():
        g = drawn[key]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        gf, wf = g.double(), w.double()
        if wf.numel() == 1 or wf.std() == 0:
            assert torch.equal(gf, wf), key       # constants: gates, LN
        else:
            assert abs(gf.std() / wf.std() - 1) < 0.35, key
    if p.cfg.moe is not None:
        n = next(i for i, s in enumerate(p.cfg.layers) if s.ffn == "moe")
        E = p.cfg.moe.num_experts
        assert want[f"layers.{n}.ffn.w1"].shape == (E, p.cfg.d_model,
                                                    p.cfg.d_ff)


def test_quantize_kv_matches_reference_bit_for_bit():
    """Half-way values round to even, values clip at +-127, an all-zero
    row takes the 1e-8 floor as its scale."""
    rng = np.random.default_rng(4)
    t = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    t[0, 0, 0] = 0.0                                 # the scale floor
    t[0, 1, 0, :] = np.arange(16) - 7.5              # half-way quotients
    t[0, 1, 0, 0] = 127.0
    t[1, 2, 1, :] = 1e-30
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
        wq, ws = jt._quantize_kv(jnp.asarray(t, dt_j))
        gq, gs = tt._quantize_kv(torch.from_numpy(t).to(dt_t))
        assert gq.dtype == torch.int8 and gs.dtype == torch.float32
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # the reference's dequantize: both cast to bf16 first
    q, sc = tt._quantize_kv(torch.from_numpy(t))
    want = (jnp.asarray(q.numpy()).astype(jnp.bfloat16)
            * jnp.asarray(sc.numpy()).astype(jnp.bfloat16))
    got = tt._dequantize_kv(q, sc)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got), to_np(want))


# ---------------------------------------------------------------------------
# one layer at a time
# ---------------------------------------------------------------------------

def _src(cfg, rng):
    n = cfg.n_img_tokens or cfg.encoder.n_frames
    return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_in_sequence_mode_match_reference(arch):
    pair = get_pair(arch)
    cfg = pair.cfg
    rng = np.random.default_rng(7)
    positions = np.arange(S)
    for n, spec in enumerate(cfg.layers):
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        src = _src(cfg, rng) if spec.cross_attn else None
        jx = None if src is None else {"src": jnp.asarray(src, jnp.bfloat16)}
        tx = None if src is None else {
            "src": torch.from_numpy(src).to(torch.bfloat16)}
        want, waux, wblob = jt.apply_layer_seq(
            cfg, spec, pair.ref_layer(n), jnp.asarray(x, jnp.bfloat16),
            jnp.asarray(positions), jx, kv_chunk=8, want_cache=True)
        got, gaux, gblob = tt.apply_layer_seq(
            pair.port.cfg, spec, pair.port.layers[n],
            torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(positions), kv_chunk=8, want_cache=True,
            extras=tx)
        assert got.dtype == torch.bfloat16
        close_bf16(got, want, f"layer {n} ({spec.mix}, {spec.ffn})")
        close_blob(gblob, wblob, f"layer {n} blob")
        assert abs(float(gaux) - float(waux)) <= 1e-5 * abs(float(waux)) \
            + 1e-7, (n, float(gaux), float(waux))


def _random_cache(cfg, spec, rng, cache_len):
    """A reference cache blob with seeded contents of the right dtypes
    (int8 values over the whole range, positive scales)."""
    blob = jt.init_layer_cache(cfg, spec, B, cache_len)
    out = {}
    for key, a in blob.items():
        if a.dtype == jnp.int8:
            val = rng.integers(-127, 128, a.shape)
        elif key.endswith("scale"):
            val = np.abs(rng.standard_normal(a.shape)) * 0.02 + 1e-3
        else:
            val = rng.standard_normal(a.shape)
        out[key] = jnp.asarray(val.astype(np.float32) if a.dtype != jnp.int8
                               else val, a.dtype)
    return out


@pytest.mark.parametrize("pos", [5, 37])
@pytest.mark.parametrize("name", ARCHS + INT8)
def test_layers_in_step_mode_match_reference(name, pos):
    """One decode token per layer from the same cache; at pos 37 mixtral
    smoke's 32-slot ring has wrapped, and a full cache of 48 holds it."""
    pair = get_pair(name)
    cfg = pair.cfg
    rng = np.random.default_rng(pos)
    for n, spec in enumerate(cfg.layers):
        cache = _random_cache(cfg, spec, rng, cache_len=48)
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, wcache = jt.apply_layer_step(cfg, spec, pair.ref_layer(n),
                                           cache, jnp.asarray(
                                               x, jnp.bfloat16),
                                           jnp.int32(pos))
        tcache = {k: convert._tensor(np.asarray(v)) for k, v in cache.items()}
        keep = {k: v.clone() for k, v in tcache.items()}
        got, gcache = tt.apply_layer_step(
            pair.port.cfg, spec, pair.port.layers[n], tcache,
            torch.from_numpy(x).to(torch.bfloat16), pos)
        close_bf16(got, want, f"layer {n} ({spec.mix}) step")
        close_blob(gcache, wcache, f"layer {n} ({spec.mix}) step cache")
        assert all(torch.equal(keep[k], tcache[k]) for k in keep), \
            "the step changed its input cache"


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def test_encoder_matches_reference():
    pair = get_pair("whisper_large_v3")
    frames = pair.extras["frames"]
    want = jt.encode(pair.cfg, pair.params["encoder"],
                     jnp.asarray(frames, jnp.bfloat16), kv_chunk=8)
    got = tt.encode(pair.port.cfg, pair.port.encoder,
                    torch.from_numpy(frames).to(torch.bfloat16), kv_chunk=8)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    scale = float(np.abs(to_np(want)).max())
    assert float(np.abs(to_np(got) - to_np(want)).max()) < bound(scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    want, got = get_pair(arch).full()
    assert got.shape == (B, S, get_pair(arch).cfg.vocab)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) < bound(scale)


@pytest.mark.parametrize("arch", CROSS)
def test_logits_change_with_extras(arch):
    """With nonzero gates the cross path reaches the logits: other extras
    change most of them; with the gates at 0 (the reference's init) they
    change none."""
    pair = get_pair(arch)
    toks = torch.from_numpy(pair.tokens)
    base, _, _ = pair.port(toks, tx(pair.extras))
    other, _, _ = pair.port(toks, tx(extras_np(pair.cfg, seed=1)))
    assert float((base != other).float().mean()) > 0.5
    gates = {k: p for k, p in pair.port.named_parameters()
             if k.endswith("xattn.gate")}
    assert gates and all(float(p) == GATE for p in gates.values())
    with torch.no_grad():
        for p in gates.values():
            p.zero_()
        try:
            a, _, _ = pair.port(toks, tx(pair.extras))
            b, _, _ = pair.port(toks, tx(extras_np(pair.cfg, seed=1)))
        finally:
            for p in gates.values():
                p.fill_(GATE)
    assert torch.equal(a, b)        # whisper: nor does the encoder
    with pytest.raises(ValueError, match="extras"):
        pair.port(toks)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "gemma2_9b"])
def test_int8_on_a_local_layer_raises(arch):
    cfg = dataclasses.replace(torch_config(arch, smoke=True),
                              kv_cache_dtype="int8")
    model = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="full caches only"):
        model.init_cache(1, 8)
    jcfg = dataclasses.replace(get_config(arch, smoke=True),
                               kv_cache_dtype="int8")
    local = next(s for s in jcfg.layers if s.mix == "local")
    with pytest.raises(AssertionError):         # the reference's assert
        jt.init_layer_cache(jcfg, local, 1, 8)


def test_int8_cache_holds_fewer_bytes():
    """k: hd int8 values and one f32 scale a (token, head) against hd bf16
    values: 16 + 4 against 32 B at smoke's head_dim 16."""
    cfg8, _ = configs("llama3p2_vision_11b:int8")
    bf = tt.init_layer_cache(torch_config("llama3p2_vision_11b", smoke=True),
                             cfg8.layers[0], 1, 8, torch.device("cpu"))
    q8 = tt.init_layer_cache(configs("llama3p2_vision_11b:int8")[1],
                             cfg8.layers[0], 1, 8, torch.device("cpu"))
    per = lambda c, keys: sum(c[k].numel() * c[k].element_size()   # noqa
                              for k in keys) // (8 * cfg8.n_kv)
    assert per(bf, ["k"]) == 2 * cfg8.head_dim
    assert per(q8, ["k", "kscale"]) == cfg8.head_dim + 4


def test_moe_pspec_and_missing_extras_raise():
    """``cfg.moe_pspec`` (the reference's field) is carried and changes
    nothing: over a mesh the partition splits the MoE dispatch buffer
    (``moe_forward(part=)``); missing extras raise."""
    cfg = torch_config("mixtral_8x22b", smoke=True)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    want, got = (Model(c).init(torch.Generator().manual_seed(0), "cpu")(
        toks)[0] for c in (cfg, dataclasses.replace(cfg,
                                                    moe_pspec=("data",))))
    assert torch.equal(got, want)
    port = get_pair("llama3p2_vision_11b").port
    with pytest.raises(ValueError, match="img"):
        port.loss({"tokens": toks, "labels": toks})
    with pytest.raises(ValueError, match="frames"):
        get_pair("whisper_large_v3").port.prefill(toks, 8)
