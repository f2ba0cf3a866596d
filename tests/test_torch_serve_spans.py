"""Spans and counters inside the port's served path
(``repro_torch.runtime.spans``).

On the CPU, eagerly:

* with no ambient trace every helper is the shared null object, and an
  eager prefill and step give, bit for bit, what they give under a trace
  with a timeline open (the spans time the work, they do not change it);
  a warm-up's spans and counts are thrown away, and a paused block sees
  no timeline;
* under a trace the host spans nest as ``serve.prefill`` >
  ``prefill.forward``, ``prefill.cache_fill``, the eager step opens
  ``serve.step``, and the device spans (the host clock on a CPU device)
  nest by layer kind;
* a program span starts and ends within 1 ms of its ``record_function``
  event in a ``torch.profiler`` trace: both are on the epoch clock;
* the MoE counters equal ``keep.sum()`` and G·E·cap computed apart, on
  shapes where tokens drop.

Marked ``cuda`` (skipped without a card): ``GraphedServeStep``'s
instrumented graph in turns with its plain one, over 8 steps: the same
tokens and cache bit for bit as without a trace, the same launch
tallies, the host spans of a call; at published widths
embed + mix + ffn + head within 90-100% of ``decode.graph``; and under
the profiler each ``rwkv6_step`` span within 50 us of the kernel it
encloses.
"""
import math
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core.telemetry import MetricRegistry
from repro_torch.models import Model
from repro_torch.models.components import moe_forward
from repro_torch.models.config import MoeSpec
from repro_torch.runtime import spans
from repro_torch.serve import make_prefill, make_serve_step

B, P, STEPS = 2, 12, 3
ARCHS = ["rwkv6_1p6b", "mixtral_8x22b"]
# the children a layer kind's device spans have in a decode step
CHILDREN = {"rwkv6_1p6b": {"decode.mix": ["decode.mix.rwkv6_step",
                                          "decode.mix.state_copy"],
                           "decode.ffn": []},
            "mixtral_8x22b": {"decode.mix": ["decode.mix.kv_write",
                                             "decode.mix.attend"],
                              "decode.ffn": ["decode.ffn.route",
                                             "decode.ffn.experts",
                                             "decode.ffn.combine"]}}


def _model(arch: str, device="cpu") -> Model:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return Model(get_config(arch, smoke=True), kv_chunk=8).init(gen, device)


def _tokens(model: Model, device="cpu") -> torch.Tensor:
    gen = torch.Generator().manual_seed(5)
    return torch.randint(0, model.cfg.vocab, (B, P), generator=gen).to(device)


def _serve(model: Model, prompt: torch.Tensor, steps: int, read=None):
    """Prefill and ``steps`` greedy steps; ``read()`` after each. Returns
    the prefill's logits, each step's tokens (cloned) and the cache."""
    last, cache = make_prefill(model, P + steps)(prompt)
    if read:
        read()
    step = make_serve_step(model)
    nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    toks = []
    for i in range(steps):
        nxt, cache = step(cache, nxt, P + i)
        toks.append(nxt.clone())
        if read:
            read()
    return last, toks, [{k: t.clone() for k, t in cb.items()}
                        for cb in cache], step


def _same(a, b) -> bool:
    (la, ta, ca, _), (lb, tb, cb, _) = a, b
    return (torch.equal(la, lb) and all(map(torch.equal, ta, tb))
            and all(sorted(x) == sorted(y) and all(torch.equal(x[k], y[k])
                                                   for k in x)
                    for x, y in zip(ca, cb)))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_helpers_are_null_outside_a_trace():
    assert spans.timeline() is None
    assert spans.host_span("serve.step") is spans.NULL
    assert spans.device_span("decode.mix") is spans.NULL
    spans.device_counter("moe_slots", 8)            # no timeline: nothing
    reg = MetricRegistry()
    with reg.trace("root"):
        assert spans.host_span("serve.step") is not spans.NULL
        # a trace alone times the host; the device needs a timeline
        assert spans.device_span("decode.mix") is spans.NULL
        with spans.Timeline("cpu"):
            assert spans.device_span("decode.mix") is not spans.NULL
        assert spans.timeline() is None
    with pytest.raises(RuntimeError, match="ambient trace"):
        with spans.Timeline("cpu"):
            pass


def test_discarded_and_paused_blocks_leave_nothing():
    """A warm-up's spans and counts are thrown away (``discarded``); a plain
    graph's capture sees no timeline (``paused``)."""
    reg = MetricRegistry()
    with reg.trace("root"), spans.Timeline("cpu") as tl:
        with spans.device_span("decode.ffn"):
            with spans.device_span(".route"):
                spans.device_counter("moe_slots", 8)
        with spans.discarded():
            with spans.device_span("decode.mix"):
                spans.device_counter("moe_slots", 100)
        with spans.paused():
            assert spans.timeline() is None
            assert spans.device_span("decode.mix") is spans.NULL
        assert spans.timeline() is tl
        assert [r[0] for r in tl.read()] == ["decode.ffn", "decode.ffn.route"]
    assert reg.counter_values() == {"moe_slots": 8.0}


@pytest.mark.parametrize("arch", ARCHS)
def test_untraced_serving_equals_traced(arch):
    model = _model(arch)
    prompt = _tokens(model)
    plain = _serve(model, prompt, STEPS)
    reg = MetricRegistry()
    with reg.trace("root"), spans.Timeline("cpu") as tl:
        traced = _serve(model, prompt, STEPS, tl.read)
    assert _same(plain, traced)
    assert _same(plain, _serve(model, prompt, STEPS))


def _names(span):
    return [c.name for c in span.children]


def _kind(name: str) -> bool:
    """A layer kind's span (``decode.mix``), not one of its children."""
    return name.count(".") == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_nest(arch):
    model = _model(arch)
    reg = MetricRegistry()
    reads = []
    with reg.trace("root"), spans.Timeline("cpu") as tl:
        _serve(model, _tokens(model), STEPS, lambda: reads.append(tl.read()))
    root = reg.spans("root")[0]
    assert _names(root) == ["serve.prefill"] + ["serve.step"] * STEPS
    assert _names(root.children[0]) == ["prefill.forward",
                                        "prefill.cache_fill"]
    n = model.cfg.n_layers
    prefill, steps = reads[0], reads[1:]
    assert [r[0] for r in prefill if _kind(r[0])] == ["prefill.mix",
                                                      "prefill.ffn"] * n
    for step in steps:
        assert [r[0] for r in step if _kind(r[0])] == (
            ["decode.embed"] + ["decode.mix", "decode.ffn"] * n
            + ["decode.head"])
        for i, (name, s, e) in enumerate(step):
            assert s <= e
            if _kind(name):
                parent = (name, s, e)
                want = CHILDREN[arch].get(name, [])
                assert [r[0] for r in step[i + 1:i + 1 + len(want)]] == want
            else:
                assert name.startswith(parent[0] + ".")
                assert parent[1] <= s and e <= parent[2], name


def test_span_is_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    model = _model("rwkv6_1p6b")
    reg = MetricRegistry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.trace("root"):
            make_prefill(model, P + 1)(_tokens(model))
            time.sleep(0.01)
    sp = reg.spans("root")[0].find("serve.prefill")
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "serve.prefill"]
    assert len(ev) == 1
    start = ev[0].start_ns() / 1e9
    end = start + ev[0].duration_ns() / 1e9
    assert abs(start - sp.start) < 1e-3, (start, sp.start)
    assert abs(end - (sp.start + sp.elapsed)) < 1e-3


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_counters_where_tokens_drop(groups):
    T, D, F_, E, k = 64, 16, 32, 4, 2
    moe = MoeSpec(num_experts=E, top_k=k, capacity_factor=1.0)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, T // 2, D, generator=gen).to(torch.bfloat16)
    router = torch.randn(D, E, generator=gen).to(torch.bfloat16)
    # skewed toward expert 0, so its slots overflow
    router[:, 0] += 0.5
    w1, w3 = (torch.randn(E, D, F_, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    w2 = torch.randn(E, F_, D, generator=gen).to(torch.bfloat16)
    reg = MetricRegistry()
    with reg.trace("root"), spans.Timeline("cpu"):
        out, _ = moe_forward(x, router, w1, w3, w2, moe, groups=groups)
    plain, _ = moe_forward(x, router, w1, w3, w2, moe, groups=groups)
    assert torch.equal(out, plain)
    got = reg.counter_values()
    # apart: each group's tokens a chosen expert, capacity from the shapes
    logits = (x.reshape(T, D) @ router).float()
    top = torch.topk(logits, k, dim=-1).indices.reshape(groups, -1)
    per = torch.stack([torch.bincount(g, minlength=E) for g in top])
    cap = math.ceil(moe.capacity_factor * (T // groups) * k / E)
    cap = max(8, (cap + 7) // 8 * 8)
    kept = int(torch.clamp(per, max=cap).sum())
    assert kept < T * k                               # tokens dropped
    assert got == {"moe_tokens_kept": kept, "moe_slots": groups * E * cap}


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed step runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_instrumented_graph_equals_plain(arch, cuda_device):
    """8 steps without a trace against 8 under a timeline, taking turns
    between the instrumented graph and the plain one (timed as a whole)."""
    model = _model(arch, cuda_device)
    prompt = _tokens(model, cuda_device)
    n = 8
    plain = _serve(model, prompt, n)
    reg = MetricRegistry()
    reads = []

    def read():
        reads.append((tl.layers, tl.read()))
        tl.layers = not tl.layers
    with reg.trace("root"), spans.Timeline(cuda_device) as tl:
        traced = _serve(model, prompt, n, read)
    assert _same(plain, traced)
    (st,) = traced[3]._statics.values()
    (plain_st,) = plain[3]._statics.values()
    assert set(st.graphs) == {True, False} and set(plain_st.graphs) == {
        False}
    assert st.graphs[True].tally == st.graphs[False].tally == \
        plain_st.graphs[False].tally
    root = reg.spans("root")[0]
    calls = [c for c in root.children if c.name == "serve.step"]
    assert len(calls) == n
    assert _names(calls[0]) == ["step.check", "step.capture",
                                "step.cache_copy_in", "step.replay"]
    assert _names(calls[1]) == ["step.check", "step.capture", "step.replay"]
    assert all(_names(c) == ["step.check", "step.replay"]
               for c in calls[2:])
    assert set(reg.counter_values()) <= {"moe_tokens_kept", "moe_slots"}
    n_layers = model.cfg.n_layers
    for layers, step in reads[1:]:                 # [0]: the prefill
        assert step[0][0] == "decode.graph"
        kinds = [r[0] for r in step[1:] if _kind(r[0])]
        assert kinds == ([] if not layers else (
            ["decode.embed"] + ["decode.mix", "decode.ffn"] * n_layers
            + ["decode.head"]))
        assert all(step[0][1] <= s and e <= step[0][2] for _, s, e in step)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers,batch", [("rwkv6_1p6b", 8, 256),
                                               ("mixtral_8x22b", 2, 64)])
def test_cuda_layer_kinds_cover_the_replay(arch, layers, batch,
                                           cuda_device):
    """At published widths (fewer layers): embed + mix + ffn + head are
    90-100% of the instrumented replay's ``decode.graph`` (the rest: the
    argmax, the launch and the events themselves)."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    model = Model(cfg).init(gen, cuda_device)
    prompt = torch.randint(0, cfg.vocab, (batch, P), device=cuda_device,
                           generator=gen)
    last, cache = make_prefill(model, P + 4)(prompt)
    step = make_serve_step(model)
    nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    reg = MetricRegistry()
    with reg.trace("root"), spans.Timeline(cuda_device) as tl:
        tl.read()
        for i in range(4):
            nxt, cache = step(cache, nxt, P + i)
            got = tl.read()
            whole = got[0][2] - got[0][1]
            parts = sum(e - s for name, s, e in got[1:] if _kind(name))
            assert 0.9 * whole <= parts <= whole, (i, parts, whole)


@pytest.mark.cuda
def test_cuda_device_spans_enclose_their_kernels(cuda_device):
    """Under the profiler: each ``decode.mix.rwkv6_step`` span of a replay
    and the ``rwkv6_step`` kernel it encloses start and end within 50 us
    of each other, the device events' clock shifted onto the profiler's by
    the median offset of the layers' starts."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    model = _model("rwkv6_1p6b", cuda_device)
    prompt = _tokens(model, cuda_device)
    last, cache = make_prefill(model, P + 4)(prompt)
    step = make_serve_step(model)
    nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    reg = MetricRegistry()
    with reg.trace("root"), spans.Timeline(cuda_device) as tl:
        nxt, cache = step(cache, nxt, P)                     # captures
        tl.read()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            nxt, cache = step(cache, nxt, P + 1)
            torch.cuda.synchronize()
        got = tl.read()
    ours = sorted((e.start_ns() / 1e6, (e.start_ns() + e.duration_ns())
                   / 1e6) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and "rwkv6_step" in e.name())
    marks = [(s, e) for name, s, e in got if name == "decode.mix.rwkv6_step"]
    assert len(ours) == len(marks) == model.cfg.n_layers
    shift = sorted(k[0] - m[0] for k, m in zip(ours, marks))[len(ours) // 2]
    for (ks, ke), (ms, me) in zip(ours, marks):
        assert abs(ks - ms - shift) < 0.05 and abs(ke - me - shift) < 0.05, (
            ks - ms - shift, ke - me - shift)
