"""The ``mla_moe`` family (Kimi-K2 at ``kimi-k2-13L-ep48``) and its cell,
at the smoke sizes on the CPU: the plain reference is the port cast to
float32, the count's parameters are the layout's, the YaRN tables agree
with the port's, and the cell's check passes the clean path and catches
a broken step (whole batches, as the card's test runs them)."""
import math

import pytest
import torch

from portbench import weights
from portbench.count import mla_moe as count
from portbench.harness import load_config
from portbench.models import mla_moe
from portbench.reference import mla_moe as ref

NAME = "kimi-k2-13L-ep48"
CELLS = ["kimi-k2-decode"]


def _model(seed):
    from repro_torch.models import Model
    cfg = load_config(NAME, smoke=True)
    model = Model(mla_moe.port_config(cfg)).init(
        torch.Generator().manual_seed(0), "cpu")
    groups = mla_moe.layout(cfg)
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
    assert count.parameters(cfg) == cfg["parameters"] == 8_849_354_240
    assert sum(leaf.numel for g in mla_moe.layout(cfg) for leaf in g) == \
        cfg["parameters"]
    # a cached position of a layer: 512 + 64 bf16 values
    assert count.latent_bytes(cfg, 1, 1) == 13 * 1152
    assert count.experts_reached(cfg, 32) == pytest.approx(
        8 * (1 - (1 - 8 / 384) ** 32))
    assert 0.48 < count.experts_reached(cfg, 32) / 8 < 0.50


def test_yarn_tables_are_the_port_s():
    from repro_torch.models.components import yarn_inv_freq, yarn_mscale
    cfg = load_config(NAME)
    inv, scale, cs = ref.rope_tables(cfg, torch.device("cpu"))
    port = mla_moe.port_config(cfg)
    assert torch.allclose(yarn_inv_freq(64, 50000.0, port.yarn), inv,
                          rtol=1e-6, atol=0)
    assert cs == 1.0
    assert scale == pytest.approx(192 ** -0.5 * yarn_mscale(32.0, 1.0) ** 2)
    assert yarn_mscale(32.0, 1.0) ** 2 == pytest.approx(
        (0.1 * math.log(32) + 1) ** 2) == pytest.approx(1.8133, abs=1e-4)


def _judged(cell, seed=2**31 + 11):
    """Whole batches of the cell's smoke traffic through the served path,
    as many as hold the requests a run judges, then the check: (judged,
    limits)."""
    from portbench.harness import Session
    s = Session(cell, torch.device("cpu"), smoke=True)
    s.load_weights(seed)
    s.warm(seed)
    w = s.window(seed, 0.0, batches=s.check_batches)
    return s.judge(seed, w), s.limits


@pytest.mark.parametrize("cell", CELLS)
def test_clean_path_is_correct(cell):
    judged, limits = _judged(cell)
    assert judged["sequence_gaps"]
    assert all(judged[k] <= limit for k, limit in limits.items()), judged


@pytest.mark.parametrize("cell", CELLS)
def test_altered_step_is_not_correct(cell, monkeypatch):
    from repro_torch.serve import serve_step
    real = serve_step.make_serve_step

    def make(model, *a, **k):
        step = real(model, *a, **k)

        def broken(cache, tokens, pos):
            nxt, new = step(cache, tokens, pos)
            return (nxt + 1) % model.cfg.vocab, new
        return broken
    monkeypatch.setattr(serve_step, "make_serve_step", make)
    judged, limits = _judged(cell)
    assert any(judged[k] > limit for k, limit in limits.items()), judged
