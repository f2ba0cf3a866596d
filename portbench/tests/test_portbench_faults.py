"""The check catches a broken timed path: each run drives a cell on the
CPU at its smoke sizes through ``run.run_cell`` (everything but the look
for a card), with the served path broken underneath, and ``correct``
comes out false. The clean path is run alongside. (The lower-precision
control is held to the limits at the cells' own sizes on the card:
``test_portbench_card.py``.)"""
import json

import pytest
import torch

from portbench import run
from portbench.harness import ROOT

CELLS = ["rwkv6-decode", "mixtral-decode", "rwkv6-prefill"]


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _run(cell, seed=2**31 + 11):
    result, lines = run.run_cell(_bench(), cell, seed, 2.0, False,
                                 torch.device("cpu"), smoke=True)
    assert lines[-1].startswith("checked ")
    return result


def _break_step(monkeypatch, fault):
    from repro_torch.serve import serve_step
    real = serve_step.make_serve_step

    def make(model, *a, **k):
        step = real(model, *a, **k)
        vocab = model.cfg.vocab

        def broken(cache, tokens, pos):
            nxt, new = step(cache, tokens, pos)
            if fault == "state unchanged":
                return nxt, cache
            if fault == "token altered":
                return (nxt + 1) % vocab, new
            half = nxt.shape[0] // 2                 # the rest left out
            return torch.cat([nxt[:half], torch.zeros_like(
                nxt[half:])]), new
        return broken
    monkeypatch.setattr(serve_step, "make_serve_step", make)


@pytest.mark.parametrize("cell", CELLS)
def test_clean_path_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in r["checked"].values())
    assert list(r)[-1] == "checked"


@pytest.mark.parametrize("fault", ["state unchanged", "token altered",
                                   "half the batch left out"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    _break_step(monkeypatch, fault)
    r = _run(cell)
    assert not r["correct"] and r["failed"] > 0, r["checked"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_first_token_is_not_correct(cell, monkeypatch):
    from repro_torch.serve import serve_step
    real = serve_step.make_prefill

    def make(model, *a, **k):
        prefill = real(model, *a, **k)

        def broken(tokens, extras=None):
            logits, cache = prefill(tokens, extras)
            return logits.roll(1, dims=-1), cache
        return broken
    monkeypatch.setattr(serve_step, "make_prefill", make)
    assert not _run(cell)["correct"]
