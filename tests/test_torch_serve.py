"""Paged serving: the port's ``ServingEngine`` against the JAX package's.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, so ``convert.paged_lm_state_dict`` carries them into the port's
``PagedLM``. Both engines then serve the same requests at
``tests/test_system.py``'s configuration on the CPU, each with its caches
rebuilt on counter clocks (1, 2, 3, ...) so that which pages the policy
releases never rests on clock ties. The generated tokens and the tier
reports must be identical, and every step's logits agree within
``rtol=1e-4, atol=1e-5 * max|logit|`` (f32 products summed in another
order; the smallest top-2 logit margin at this size is about 6e-5, so
equal tokens are a fair test).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import paged_lm_state_dict
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kvcache import PagePool, TieredKvCache
from repro_torch.serve import PagedLMConfig, Request, ServingEngine

CFG = dict(n_pages=12, page_size=4, n_layers=2, high_wm=70.0, low_wm=40.0)


def _requests(cls, vocab):
    return [cls(req_id=i, prompt=[(7 * i + j) % vocab for j in range(6)],
                max_new=8) for i in range(4)]


def _counter():
    c = itertools.count(1)
    return lambda: float(next(c))


def test_paged_serving_with_tiering_end_to_end():
    """``tests/test_system.py``'s serving test, on the port (CPU)."""
    cfg = PagedLMConfig(**CFG)
    eng = ServingEngine(cfg, seed=1, device="cpu")
    done = eng.run(_requests(Request, cfg.vocab))
    assert all(r.done and len(r.generated) == 8 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.generated)
    # greedy decoding is deterministic: same prompts -> same outputs
    eng2 = ServingEngine(cfg, seed=1, device="cpu")
    done2 = eng2.run(_requests(Request, cfg.vocab))
    assert [r.generated for r in done] == [r.generated for r in done2]
    reports = eng.tier_report()
    assert all(r["hot_pages"] == 0 for r in reports)  # all freed at finish
    assert all(r["restores"] > 0 for r in reports)


class _Recorder:
    """Stands in for ``jnp`` inside the reference engine module: records
    the logits each ``argmax`` sees, delegates everything else."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.logits = []

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def argmax(self, x, *a, **kw):
        self.logits.append(np.asarray(x))
        return self._jnp.argmax(x, *a, **kw)


@pytest.fixture(scope="module")
def reference_run():
    """The JAX engine's run at the test_system config: its weights, tokens,
    tier report and the logits of every step."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kvcache import PagePool as RefPool
    from repro.kvcache import TieredKvCache as RefCache
    from repro.serve import engine as ref_engine
    cfg = ref_engine.PagedLMConfig(**CFG)
    eng = ref_engine.ServingEngine(cfg, seed=1)
    eng.caches = [RefCache(RefPool(cfg.n_pages, cfg.page_size, cfg.n_kv,
                                   cfg.head_dim), cfg.high_wm, cfg.low_wm,
                           clock=_counter()) for _ in range(cfg.n_layers)]
    rec = _Recorder(jnp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine, "jnp", rec)
        done = eng.run(_requests(ref_engine.Request, cfg.vocab))
    weights = (np.asarray(eng.embed), np.asarray(eng.head),
               [{k: np.asarray(v) for k, v in layer.items()}
                for layer in eng.layers])
    return dict(weights=weights, tokens=[r.generated for r in done],
                report=eng.tier_report(), logits=np.stack(rec.logits))


@pytest.fixture(scope="module")
def port_run(reference_run):
    cfg = PagedLMConfig(**CFG)
    eng = ServingEngine(cfg, seed=1, device="cpu")
    eng.model.load_state_dict(paged_lm_state_dict(*reference_run["weights"]))
    eng.caches = [TieredKvCache(PagePool(cfg.n_pages, cfg.page_size,
                                         cfg.n_kv, cfg.head_dim,
                                         device="cpu"),
                                cfg.high_wm, cfg.low_wm, clock=_counter())
                  for _ in range(cfg.n_layers)]
    logits = []
    step = eng._logits

    def recording(req, token):
        out = step(req, token)
        logits.append(out.numpy().copy())
        return out
    eng._logits = recording
    before = pa_kernel.paged_attention_launches
    done = eng.run(_requests(Request, cfg.vocab))
    assert pa_kernel.paged_attention_launches == before  # plain version
    return dict(tokens=[r.generated for r in done],
                report=eng.tier_report(), logits=np.stack(logits))


def test_tokens_match_reference(reference_run, port_run):
    assert port_run["tokens"] == reference_run["tokens"]
    assert len(port_run["tokens"]) == 4


def test_tier_report_matches_reference(reference_run, port_run):
    assert port_run["report"] == reference_run["report"]
    assert all(r["restores"] > 0 and r["hot_pages"] == 0
               for r in port_run["report"])


def test_logits_match_reference(reference_run, port_run):
    got, want = port_run["logits"], reference_run["logits"]
    assert got.shape == want.shape == (4 * (6 + 7), 512)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def test_state_dict_carries_every_weight(reference_run):
    sd = paged_lm_state_dict(*reference_run["weights"])
    cfg = PagedLMConfig(**CFG)
    eng = ServingEngine(cfg, seed=5, device="cpu")
    assert set(sd) == set(eng.model.state_dict())
    eng.model.load_state_dict(sd)
    np.testing.assert_array_equal(eng.model.layers[1].w2.numpy(),
                                  reference_run["weights"][2][1]["w2"])
    bad = [dict(reference_run["weights"][2][0], extra=np.zeros(1))]
    with pytest.raises(ValueError):
        paged_lm_state_dict(*reference_run["weights"][:2], bad)


def test_weights_drawn_from_the_seed_on_the_device():
    cfg = PagedLMConfig(**CFG)
    a = ServingEngine(cfg, seed=3, device="cpu").model.state_dict()
    b = ServingEngine(cfg, seed=3, device="cpu").model.state_dict()
    c = ServingEngine(cfg, seed=4, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in a.values())
    assert abs(float(a["embed"].std()) - 0.05) < 0.005
    w2 = a["layers.0.w2"]
    assert w2.shape == (cfg.d_ff, cfg.d_model)
    assert abs(float(w2.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.1
