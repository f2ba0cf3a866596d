"""The reduction of the program's own spans and counters
(``portbench/events.py``): on synthetic intervals, and over a cell's
prefills and eager steps on the CPU at its smoke sizes, where the MoE
slot use equals kept over slots recomputed from the shapes."""
import math

import pytest
import torch

from portbench import events
from portbench.harness import Session
from portbench import traffic as traffic_mod


def _step(t0, graph, mix=(), ffn=()):
    """A step's intervals: ``decode.graph`` from t0 for ``graph`` ms, with
    a decode.mix and decode.ffn span of each given length inside it."""
    out = [("decode.graph", t0, t0 + graph)]
    at = t0
    for m, f in zip(mix, ffn):
        out += [("decode.mix", at, at + m), ("decode.ffn", at + m,
                                             at + m + f)]
        at += m + f
    return out


def test_reduce_reads_the_spans():
    # instrumented and plain graphs in turns: the plain ones give graph_ms
    # and the gap after them, the instrumented ones the sums by kind
    full = [True, False, True, False, True]
    length = [13.0, 10.0, 13.5, 11.0, 13.2]
    after = [0.9, 0.4, 0.8, 0.6, 0.0]
    steps, t = [], 0.0
    for f, g, gap in zip(full, length, after):
        steps.append(_step(t, g, (2.0, 3.0), (1.0, 1.5)) if f
                     else _step(t, g))
        t += g + gap
    prefills = [[("prefill.mix", 0.0, 4.0), ("prefill.ffn", 4.0, 9.0),
                 ("prefill.mix", 9.0, 13.0)]] * 3
    got = events.reduce(steps, full, prefills,
                        {"moe_tokens_kept": 96.0, "moe_slots": 512.0})
    assert got["graph_ms"] == pytest.approx(10.5)
    assert got["step_gap_ms"] == pytest.approx(0.5)
    assert got["mix_ms.decode"] == pytest.approx(5.0)
    assert got["ffn_ms.decode"] == pytest.approx(2.5)
    assert got["mix_ms.prefill"] == 8.0
    assert got["moe_slot_use"] == 18.75
    assert events.reduce([], []) == {}
    bd = events.breakdown(steps, full)
    assert bd["decode.mix"]["median"] == pytest.approx(5.0)
    assert bd["decode.graph"]["median"] == pytest.approx(13.2)


@pytest.mark.parametrize("cell", ["mixtral-decode", "rwkv6-prefill"])
def test_events_over_smoke_prefills_and_steps(cell):
    seed = 2**31 + 17
    s = Session(cell, torch.device("cpu"), smoke=True)
    s.load_weights(seed)
    ev = events.Events(s.device)
    ev.capture(s.step, s.B, s.cache_len)         # an eager step: nothing
    ev.start()
    prompts = traffic_mod.prompts(s.traffic, s.config["vocab"], seed, 0)
    logits, cache = s.prefill(torch.from_numpy(prompts))
    ev.after_prefill()
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    for i in range(3):
        nxt, cache = s.step(cache, nxt, s.P + i)
        ev.after_step()
    ev.stop()
    got = ev.summary()
    # the eager step has no decode.graph: its numbers are left out
    assert "graph_ms" not in got and "step_gap_ms" not in got
    assert got["mix_ms.prefill"] > 0
    layers = s.config["n_layers"]
    assert sum(n == "decode.mix" for n, _, _ in ev.steps[0]) == layers
    if s.config["family"] != "moe_transformer":
        assert "moe_slot_use" not in got
        return
    E, k, cf = s.config["num_experts"], s.config["top_k"], \
        s.config["capacity_factor"]

    def slots(tokens):
        cap = math.ceil(cf * tokens * k / E)
        return E * max(8, (cap + 7) // 8 * 8)
    routed = layers * (s.B * s.P + 3 * s.B) * k
    assert ev.counters["moe_tokens_kept"] == routed      # cf = E / k
    total = layers * (slots(s.B * s.P) + 3 * slots(s.B))
    assert got["moe_slot_use"] == pytest.approx(100.0 * routed / total)
