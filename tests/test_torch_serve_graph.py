"""The decode step with a device-side position and an in-place cache, and
the graphed serving step built on it: the port against the JAX package.

``Model.decode_step_`` (and ``transformer.apply_layer_step_`` under it)
takes the position as a 0-d tensor and writes the cache in place, as the
reference's jitted step does with a traced ``pos`` and a donated cache, so
a CUDA graph can capture it. Here, on the CPU:

* teacher-forced from the same prefill, it follows the reference's
  ``decode_step`` within the reference's decode-consistency bound
  ``0.05 * scale + 0.05`` (the bf16 roundings of two frameworks compound
  over depth), for the recurrent models, the dense ones with full and
  local attention, the MoE ones and the cross-attention ones (their
  ``extras`` through prefill, the gates at 0.5 as ``zoo_pairs`` sets
  them);
* the eager ``Model.decode_step`` (one copy of the cache, then the same
  body) equals it bit for bit and leaves its input cache bit for bit as it
  was;
* the local-attention ring wraps correctly with a tensor position;
* ``make_serve_step`` on a CPU model is the eager step and makes no
  ``torch.cuda`` call; the launch tally adds a captured call once a
  replay.

Tests marked ``cuda`` hold the graphed step (``GraphedServeStep``) to the
eager one on the card and skip where there is none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import _launches
from repro_torch.models import Model
from repro_torch.serve import make_prefill, make_serve_step
from repro_torch.serve.serve_step import GraphedServeStep

B, S, P = 2, 24, 20
ARCHS = ["recurrentgemma_9b", "rwkv6_1p6b", "gemma2_9b", "chatglm3_6b",
         "mixtral_8x22b", "llama4_maverick_400b_a17b", "llama3p2_vision_11b",
         "whisper_large_v3"]
RECURRENT = ["recurrentgemma_9b", "rwkv6_1p6b"]


def _bound(scale: float) -> float:
    return 0.05 * scale + 0.05


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _clone(cache):
    return [{k: t.clone() for k, t in cb.items()} for cb in cache]


def _caches_equal(a, b) -> bool:
    return all(sorted(x) == sorted(y) and all(torch.equal(x[k], y[k])
                                              for k in x)
               for x, y in zip(a, b)) and len(a) == len(b)


class Pair:
    """The reference model with its parameters and the port's model with
    the same parameters, on the CPU, plus one seeded token batch."""

    def __init__(self, arch: str):
        import jax
        from repro.configs import get_config
        from repro.models import Model as JaxModel
        from zoo_pairs import GATE, extras_np, with_gates
        key = jax.random.PRNGKey(3)
        self.cfg = get_config(arch, smoke=True)
        self.ref = JaxModel(self.cfg, kv_chunk=8)
        self.params = with_gates(self.ref.init(key), GATE)
        self.extras = extras_np(self.cfg)
        self.port = Model(torch_config(arch, smoke=True), kv_chunk=8).init(
            torch.Generator().manual_seed(0), device="cpu")
        self.port.load_state_dict(convert.model_state_dict(
            jax.tree.map(np.asarray, self.params), self.cfg))
        self.tokens = np.array(jax.random.randint(
            jax.random.fold_in(key, 1), (B, S), 0, self.cfg.vocab))


_PAIRS = {}


def _pair(arch: str) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed step runs only there")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# CPU: the in-place body against the reference and the eager step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_inplace_step_follows_reference_decode(arch):
    """Prefill P tokens in both packages, then decode the rest of the batch
    teacher-forced: the reference's step with a traced int32 position,
    the port's in-place body with a 0-d int64 tensor."""
    from zoo_pairs import jx, tx
    import jax.numpy as jnp
    pair = _pair(arch)
    toks = pair.tokens
    lj, cj = pair.ref.prefill(pair.params, jnp.asarray(toks[:, :P]),
                              cache_len=S, extras=jx(pair.extras))
    lt, ct = pair.port.prefill(torch.from_numpy(toks[:, :P]), S,
                               tx(pair.extras))
    pairs = [(_np(lj[:, -1]), _np(lt[:, -1]))]
    for t in range(P, S):
        lgj, cj = pair.ref.decode_step(pair.params, cj,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.int32(t))
        lgt = pair.port.decode_step_(ct, torch.from_numpy(toks[:, t:t + 1]),
                                     torch.tensor(t))
        assert lgt.shape == (B, 1, pair.cfg.vocab)
        pairs.append((_np(lgj[:, 0]), _np(lgt[:, 0])))
    scale = max(float(np.abs(w).max()) for w, _ in pairs)
    err = max(float(np.abs(g - w).max()) for w, g in pairs)
    assert err < _bound(scale), (err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_eager_decode_equals_inplace_body(arch):
    """``decode_step`` (an int position) gives the in-place body's logits
    and cache bit for bit, and leaves the cache it was given as it was."""
    from zoo_pairs import tx
    port = _pair(arch).port
    toks = torch.from_numpy(_pair(arch).tokens)
    _, cache = port.prefill(toks[:, :P], S, tx(_pair(arch).extras))
    keep = _clone(cache)
    inplace = _clone(cache)
    for t in range(P, S):
        tok = toks[:, t:t + 1]
        lg_eager, new = port.decode_step(cache, tok, t)
        assert _caches_equal(cache, keep), f"decode_step changed its input " \
                                           f"cache at step {t}"
        lg_body = port.decode_step_(inplace, tok, torch.tensor(t))
        assert torch.equal(lg_eager, lg_body), t
        assert _caches_equal(new, inplace), t
        cache, keep = new, _clone(new)


def test_ring_wraps_with_tensor_position():
    """recurrentgemma smoke's 16-slot local ring, decoded by the in-place
    body with a tensor position from one window of prompt to three windows,
    against one forward (``test_ring_cache_wraps_correctly`` with a device
    position)."""
    pair = _pair("recurrentgemma_9b")
    port, window = pair.port, pair.cfg.window
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, pair.cfg.vocab,
                                         (1, 3 * window)))
    n = toks.shape[1]
    full = _np(port(toks)[0])
    scale = float(np.abs(full).max())
    _, cache = port.prefill(toks[:, :window], cache_len=window)
    pos = torch.tensor(window)
    for t in range(window, n):
        lg = port.decode_step_(cache, toks[:, t:t + 1], pos)
        err = float(np.abs(_np(lg[:, 0]) - full[:, t]).max())
        assert err < _bound(scale), (t, err)
        pos += 1


def test_cpu_serve_step_is_eager(monkeypatch):
    """On a CPU model ``make_serve_step`` is the eager step: no graph, no
    ``torch.cuda`` call, the input cache left as it was."""
    port = _pair("recurrentgemma_9b").port
    toks = torch.from_numpy(_pair("recurrentgemma_9b").tokens)

    def no_cuda(*a, **kw):
        raise AssertionError("the CPU step called torch.cuda")
    for name in ("CUDAGraph", "graph", "Stream", "current_stream",
                 "current_device", "is_current_stream_capturing"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    step = make_serve_step(port)
    assert not isinstance(step, GraphedServeStep)
    prefill = make_prefill(port, S)
    last, cache = prefill(toks[:, :P])
    keep = _clone(cache)
    nxt, new = step(cache, toks[:, P:P + 1], P)
    assert _caches_equal(cache, keep)
    lg, want = port.decode_step(keep, toks[:, P:P + 1], P)
    assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
    assert torch.equal(nxt[:, 0], torch.argmax(lg[:, -1], dim=-1).int())
    assert _caches_equal(new, want)
    with pytest.raises(ValueError, match="CUDA device"):
        GraphedServeStep(port)


def test_launch_tally_adds_captured_calls_on_replay(monkeypatch):
    """A launch counts +1 on its module when it runs, into the open
    capture's tally while the stream captures, and the tally is added once
    a replay."""
    from repro_torch.kernels.rglru_scan import kernel as rg
    from repro_torch.kernels.rwkv6_step import kernel as rw
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(rg, "rglru_scan_launches", 0)
    monkeypatch.setattr(rw, "rwkv6_step_launches", 0)
    _launches.count(rg.__name__, "rglru_scan_launches")       # ran
    with _launches.capturing() as tally:
        capturing[0] = True
        for _ in range(3):
            _launches.count(rg.__name__, "rglru_scan_launches")
        _launches.count(rw.__name__, "rwkv6_step_launches")
        capturing[0] = False
    assert (rg.rglru_scan_launches, rw.rwkv6_step_launches) == (1, 0)
    assert dict(tally) == {(rg.__name__, "rglru_scan_launches"): 3,
                           (rw.__name__, "rwkv6_step_launches"): 1}
    for _ in range(2):
        _launches.replayed(tally)
    assert (rg.rglru_scan_launches, rw.rwkv6_step_launches) == (7, 2)


# ---------------------------------------------------------------------------
# The card: the graphed step against the eager one
# ---------------------------------------------------------------------------

def _cuda_model(arch: str, device):
    """The smoke model drawn on the card, its cross-attention gates at 0.5,
    and a seeded prompt."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = Model(torch_config(arch, smoke=True), kv_chunk=8).init(gen,
                                                                     device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("xattn.gate"):
                p.fill_(0.5)
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(0, model.cfg.vocab,
                                           (B, P))).to(device)
    return model, prompt


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT + ["mixtral_8x22b",
                                             "whisper_large_v3"])
def test_cuda_graphed_step_equals_eager(arch, cuda_device):
    """2 x 16 greedy steps (the recurrentgemma and mixtral rings wrap; the
    MoE dispatch and whisper's cross-attention and learned positions are
    captured too): the graphed step gives the eager step's tokens, logits
    and final cache bit for bit (the same kernels on the same inputs in
    the same order)."""
    from zoo_pairs import extras_np
    model, prompt = _cuda_model(arch, cuda_device)
    extras = {k: torch.from_numpy(v).to(cuda_device, torch.bfloat16)
              for k, v in (extras_np(model.cfg) or {}).items()} or None
    n = 2 * 16
    cache_len = P + n
    last, cache0 = make_prefill(model, cache_len)(prompt, extras)
    first = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    cache, nxt, eager_toks, eager_lg = cache0, first, [], []
    for i in range(n):
        lg, cache = model.decode_step(cache, nxt, P + i)
        nxt = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        eager_toks.append(nxt)
        eager_lg.append(lg[:, -1])
    step = make_serve_step(model)
    assert isinstance(step, GraphedServeStep)
    step.capture(B, cache_len)
    gcache, gnxt = cache0, first
    for i in range(n):
        gnxt, gcache = step(gcache, gnxt, P + i)
        assert torch.equal(gnxt, eager_toks[i]), i
        assert torch.equal(step.logits, eager_lg[i]), i
    assert _caches_equal(gcache, cache)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_cuda_replays_count_captured_launches(arch, cuda_device):
    from repro_torch.kernels.rglru_scan import kernel as rg
    from repro_torch.kernels.rwkv6_step import kernel as rw
    model, prompt = _cuda_model(arch, cuda_device)
    mix = "rwkv6" if arch == "rwkv6_1p6b" else "rglru"
    n_kind = sum(s.mix == mix for s in model.cfg.layers)
    step = make_serve_step(model)
    step.capture(B, P + 8)
    _, cache = make_prefill(model, P + 8)(prompt)
    rg.reset_counters()
    rw.reset_counters()
    nxt = prompt[:, -1:]
    for i in range(5):
        nxt, cache = step(cache, nxt, P + i)
    torch.cuda.synchronize()
    got = (rg.rglru_scan_launches, rw.rwkv6_step_launches)
    want = (5 * n_kind, 0) if mix == "rglru" else (0, 5 * n_kind)
    assert got == want


@pytest.mark.cuda
def test_cuda_graphed_step_refuses_other_caches(cuda_device):
    model, prompt = _cuda_model("recurrentgemma_9b", cuda_device)
    step = make_serve_step(model)
    _, cache = make_prefill(model, P + 8)(prompt)
    tok = prompt[:, -1:]
    bad = _clone(cache)
    bad[0]["h"] = bad[0]["h"].double()
    with pytest.raises(ValueError, match=r"layer 0 \(rglru\) cache"):
        step(bad, tok, P)
    bad = _clone(cache)
    bad[1]["conv"] = bad[1]["conv"][:, :1]
    with pytest.raises(ValueError, match=r"layer 1 \(rglru\) cache"):
        step(bad, tok, P)
    with pytest.raises(ValueError, match="layer 0"):
        step([{k: t.cpu() for k, t in cb.items()} for cb in cache], tok, P)
    with pytest.raises(ValueError, match="tokens must be"):
        step(cache, tok.cpu(), P)
    with pytest.raises(ValueError, match="list of 5"):
        step(cache[:3], tok, P)


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda_device, monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, and no call falls back to the eager step."""
    model, prompt = _cuda_model("rwkv6_1p6b", cuda_device)
    step = make_serve_step(model)
    body = model.decode_step_

    def syncing(cache, tokens, pos, *rest):
        float(tokens.float().sum().item())
        return body(cache, tokens, pos, *rest)
    monkeypatch.setattr(model, "decode_step_", syncing)
    _, cache = make_prefill(model, P + 8)(prompt)
    with pytest.raises(RuntimeError):
        step(cache, prompt[:, -1:], P)
