"""The ``kimi_linear`` family (Kimi-Linear-48B-A3B at
``kimi-linear-48b-ep8``) and its cell, at the smoke sizes on the CPU: the
plain reference is the port cast to float32, the count's parameters are
the layout's, the published sizes are in the configuration file, and the
cell's check passes the clean path and catches a broken one (whole
batches, as the card's test runs them): a KDA state the decode step
leaves unchanged, a prefill that hands on zeroed states, an altered
served token."""
import pytest
import torch

from portbench import weights
from portbench.count import kimi_linear as count
from portbench.harness import load_config
from portbench.models import kimi_linear
from portbench.reference import kimi_linear as ref

NAME = "kimi-linear-48b-ep8"
CELL = "kimi-linear-decode"


def _model(seed):
    from repro_torch.models import Model
    cfg = load_config(NAME, smoke=True)
    model = Model(kimi_linear.port_config(cfg)).init(
        torch.Generator().manual_seed(0), "cpu")
    groups = kimi_linear.layout(cfg)
    weights.bind(model, groups, seed)
    return cfg, model, groups


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_reference_is_the_port_in_float32(seed):
    cfg, model, groups = _model(seed)
    model.float()
    g = torch.Generator().manual_seed(seed % 1000)
    tokens = torch.randint(0, cfg["vocab"], (3, 40), generator=g)
    with torch.no_grad():
        port, _, _ = model.forward(tokens)
    get = weights.reference_weights(groups, seed, torch.device("cpu"))
    ours = ref.logits(cfg, get, tokens, 0)
    scale = port.abs().max()
    assert torch.allclose(ours, port, atol=2e-5 * scale, rtol=0), \
        (ours - port).abs().max() / scale


def test_layout_and_count_match_the_port():
    cfg, model, groups = _model(1)
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {leaf.port: leaf.shape for g in groups for leaf in g} == port
    assert count.parameters(cfg) == sum(p.numel() for p in
                                        model.parameters())


def test_published_sizes():
    cfg = load_config(NAME)
    assert count.parameters(cfg) == cfg["parameters"] == 7_901_062_016
    assert sum(leaf.numel for g in kimi_linear.layout(cfg) for leaf in g) \
        == cfg["parameters"]
    # a KDA layer's state: 32 heads of 128 x 128 f32, 2 MiB a sequence
    assert count.state_bytes(cfg, 1) == 20 * (32 * 128 * 128 * 4
                                              + 3 * 3 * 4096 * 2)
    assert count.latent_bytes(cfg, 1, 1) == 7 * 1152
    # 128 tokens reach all but ~0.55 of the 32 held experts a step
    reached = 32 * (1 - (1 - 8 / 256) ** 128)
    assert 31.4 < reached < 31.5
    # the least bytes of a step at position 1,279: the state read and
    # written (10.7 GB), 31.45 experts (11.6 GB), weights, latents
    assert 27.0e9 < count.decode_bytes(cfg, 128, 1279) < 27.6e9


def test_decays_hold_slow_channels():
    """The drawn A_log and dt_bias (``assumed``): about a fifth of the
    channels decay slower than 0.99 a token at a zero input."""
    cfg = load_config(NAME)
    leaves = {leaf.name: leaf for leaf in kimi_linear.layout(cfg)[1]}
    a = "model.layers.0.self_attn"
    drawn = weights.draw_group([leaves[f"{a}.A_log"], leaves[f"{a}.dt_bias"]],
                               3, 1, torch.device("cpu"))
    A = torch.exp(drawn[f"{a}.A_log"])[:, None]
    dt = torch.nn.functional.softplus(drawn[f"{a}.dt_bias"].reshape(32, 128))
    slow = float((torch.exp(-A * dt) > 0.99).float().mean())
    assert 0.12 < slow < 0.30


def _run(monkeypatch=None, seed=2**31 + 11):
    """Whole batches of the cell's smoke traffic through the served path,
    as many as hold the requests a run judges, then the check: (judged,
    limits)."""
    from portbench.harness import Session
    s = Session(CELL, torch.device("cpu"), smoke=True)
    s.load_weights(seed)
    s.warm(seed)
    w = s.window(seed, 0.0, batches=s.check_batches)
    return s.judge(seed, w), s.limits


def test_clean_path_is_correct():
    judged, limits = _run()
    assert judged["sequence_gaps"]
    assert all(judged[k] <= limit for k, limit in limits.items()), judged


def _stale_step_(state, q, k, v, g, beta):
    """The step's read of the state with no write: the state stays as
    the prefill left it."""
    s = state * torch.exp(g)[..., None]
    return torch.einsum("bhk,bhkv->bhv", q, s)


@pytest.mark.parametrize("fault", ["state unchanged", "state zeroed",
                                   "token altered"])
def test_broken_path_is_not_correct(fault, monkeypatch):
    from repro_torch.models import kda
    from repro_torch.serve import serve_step
    if fault == "state unchanged":
        monkeypatch.setattr(kda, "kda_step_", _stale_step_)
    elif fault == "state zeroed":
        real = serve_step.make_prefill

        def make_prefill(model, *a, **k):
            prefill = real(model, *a, **k)

            def zeroed(tokens, extras=None):
                logits, cache = prefill(tokens, extras)
                for cb in cache:
                    if "s" in cb:
                        cb["s"].zero_()
                return logits, cache
            return zeroed
        monkeypatch.setattr(serve_step, "make_prefill", make_prefill)
    else:
        real = serve_step.make_serve_step

        def make(model, *a, **k):
            step = real(model, *a, **k)

            def altered(cache, tokens, pos):
                nxt, new = step(cache, tokens, pos)
                return (nxt + 1) % model.cfg.vocab, new
            return altered
        monkeypatch.setattr(serve_step, "make_serve_step", make)
    judged, limits = _run()
    assert any(judged[k] > limit for k, limit in limits.items()), judged
