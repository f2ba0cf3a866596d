"""The rest of the model zoo's prefill and decode paths, the port against
the JAX package (``zoo_pairs.Pair``; ``test_torch_zoo.py`` holds the layers
and forwards): MoE FFNs (mixtral-8x22b, llama4-maverick), cross-attention
(llama3.2-vision), the whisper encoder, and the int8 KV cache.

Tolerances, all in units of the reference's own scale: prefill logits and
caches (int8 entries dequantized, ``k * kscale``) and teacher-forced
decode logits over B = 2, S = 24, P = 20, and the port against itself
(prefill + decode against one forward, dropless MoE capacity; mixtral's
ring wrapping over 3 windows), within the reference's decode-consistency
bound ``0.05 * scale + 0.05``; the int8 prefill cache bit for bit against
the reference's ``_quantize_kv`` of the port's own prompt K/V, and a cross
layer's source K/V bit for bit against its own projections of the source.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.models import Model
from repro_torch.models import transformer as tt
from repro_torch.serve import make_prefill, make_serve_step
from zoo_pairs import (ARCHS, B, INT8, KEY, P, S, bound, dequantized, jx,
                       get_pair, to_np, tx)


@pytest.mark.parametrize("name", ARCHS + INT8)
def test_prefill_cache_matches_reference(name):
    pair = get_pair(name)
    cfg = pair.cfg
    toks = pair.tokens[:, :P]
    lj, cj = pair.ref.prefill(pair.params, jnp.asarray(toks), cache_len=S,
                              extras=jx(pair.extras))
    lt, ct = pair.port.prefill(torch.from_numpy(toks), S, tx(pair.extras))
    scale = float(np.abs(to_np(lj)).max())
    assert float(np.abs(to_np(lt) - to_np(lj)).max()) < bound(scale)
    want = convert.model_cache(jax.tree.map(np.asarray, cj), cfg)
    assert len(ct) == len(want) == cfg.n_layers
    for n, (g, w) in enumerate(zip(ct, want)):
        assert sorted(g) == sorted(w), n
        for key in w:
            assert (g[key].shape, g[key].dtype) == (w[key].shape,
                                                    w[key].dtype), (n, key)
        g, w = dequantized(g), dequantized(w)
        for key in w:
            scale = float(w[key].abs().max())
            err = float((g[key] - w[key]).abs().max())
            assert err < bound(scale), (n, key, err, scale)
    if cfg.kv_cache_dtype == "int8":
        # bit for bit: the reference's quantization of the port's own K/V
        with torch.no_grad():
            _, _, blobs = pair.port(torch.from_numpy(toks), tx(pair.extras),
                                    want_cache=True)
        for n, (blob, slot) in enumerate(zip(blobs, ct)):
            for key in ("k", "v"):
                q, sc = jt._quantize_kv(jnp.asarray(
                    to_np(blob[key])).astype(jnp.bfloat16))
                np.testing.assert_array_equal(slot[key][:, :P].numpy(),
                                              np.asarray(q))
                np.testing.assert_array_equal(
                    slot[key + "scale"][:, :P].numpy(), np.asarray(sc))
                assert not slot[key][:, P:].any()
    # a cross layer's source K/V: its own projections of the source, bit
    # for bit (the encoder's output for whisper, the image tokens as given)
    with torch.no_grad():
        for n, spec in enumerate(cfg.layers):
            if spec.cross_attn:
                src = pair.port._extras(tx(pair.extras))["src"]
                xk, xv = tt._source_kv(pair.port.cfg,
                                       pair.port.layers[n]["xattn"], src)
                assert torch.equal(ct[n]["xk"], xk)
                assert torch.equal(ct[n]["xv"], xv)


@pytest.mark.parametrize("name", ARCHS + INT8)
def test_teacher_forced_decode_matches_reference(name):
    """Prefill P tokens, then decode the rest of the batch's tokens one at a
    time in both packages, through the serving steps."""
    pair = get_pair(name)
    toks = pair.tokens
    prefill = make_prefill(pair.port, cache_len=S)
    step = make_serve_step(pair.port)
    lj, cj = pair.ref.prefill(pair.params, jnp.asarray(toks[:, :P]),
                              cache_len=S, extras=jx(pair.extras))
    lt, ct = prefill(torch.from_numpy(toks[:, :P]), tx(pair.extras))
    pairs = [(to_np(lj[:, -1]), to_np(lt))]
    for t in range(P, S):
        lgj, cj = pair.ref.decode_step(pair.params, cj,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.int32(t))
        lgt, ct2 = pair.port.decode_step(ct, torch.from_numpy(
            toks[:, t:t + 1]), t)
        nxt, ct = step(ct, torch.from_numpy(toks[:, t:t + 1]), t)
        assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
        assert all(torch.equal(a[k], b[k]) for a, b in zip(ct, ct2)
                   for k in a)
        pairs.append((to_np(lgj[:, 0]), to_np(lgt[:, 0])))
    scale = max(float(np.abs(w).max()) for w, _ in pairs)
    err = max(float(np.abs(g - w).max()) for w, g in pairs)
    assert err < bound(scale), (err, scale)


@pytest.mark.parametrize("name", ARCHS + INT8)
def test_port_decode_matches_its_forward(name):
    """The reference's decode-consistency test on the port alone, MoE
    capacity dropless (a full-sequence dispatch drops other tokens than a
    one-token step otherwise)."""
    pair = get_pair(name, dropless=True)
    extras = tx(pair.extras)
    toks = torch.from_numpy(pair.tokens)
    full = to_np(pair.port(toks, extras)[0])
    logits, cache = pair.port.prefill(toks[:, :P], S, extras)
    scale = float(np.abs(full).max()) + 1e-6
    errs = [float(np.abs(to_np(logits[:, -1]) - full[:, P - 1]).max())]
    for t in range(P, S):
        lg, cache = pair.port.decode_step(cache, toks[:, t:t + 1], t)
        errs.append(float(np.abs(to_np(lg[:, 0]) - full[:, t]).max()))
    assert max(errs) < bound(scale), errs


def test_ring_cache_wraps_correctly():
    """mixtral smoke (window 32) far past the window, capacity 2.0 (the
    reference's test's): prefill 3 windows less one token and decode the
    last, then decode every token after a prompt of one window."""
    cfg = dataclasses.replace(torch_config("mixtral_8x22b", smoke=True),
                              moe=dataclasses.replace(
                                  torch_config("mixtral_8x22b",
                                               smoke=True).moe,
                                  capacity_factor=2.0))
    port = Model(cfg, kv_chunk=8).init(torch.Generator().manual_seed(0),
                                       device="cpu")
    port.load_state_dict(get_pair("mixtral_8x22b").port.state_dict())
    window = cfg.window
    toks = torch.from_numpy(np.array(jax.random.randint(
        KEY, (1, 3 * window), 0, cfg.vocab)))
    n = toks.shape[1]
    full = to_np(port(toks)[0])
    scale = float(np.abs(full).max())
    _, cache = port.prefill(toks[:, :n - 1], cache_len=window)
    lg, _ = port.decode_step(cache, toks[:, n - 1:], n - 1)
    assert float(np.abs(to_np(lg[:, 0]) - full[:, -1]).max()) < bound(scale)
    _, cache = port.prefill(toks[:, :window], cache_len=window)
    for t in range(window, n):
        lg, cache = port.decode_step(cache, toks[:, t:t + 1], t)
        err = float(np.abs(to_np(lg[:, 0]) - full[:, t]).max())
        assert err < bound(scale), (t, err)
