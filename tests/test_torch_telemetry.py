"""``tests/core/test_telemetry.py`` on the port, held against ``repro``.

The telemetry plane: the registry backing every component counter, the
run span tree, the Prometheus round trip, the scrape-boundary reset and
each evaluator downgrade recorded as a ``fallback{stage=,reason=}``
counter. The port's ``core/telemetry.py`` differs from the reference's
only where a span syncs a device (``torch.cuda.synchronize()`` when it
was handed CUDA tensors). Cases that read counters, snapshots or the
exposition text run on both packages (the port's engines on
``device="cpu"``) and must read the same values; span timings are left
out, as they are wall-clock times.
"""
import threading

import pytest

pytest.importorskip("torch")

from torch_pair import both, port


def _fs(P, n_files: int = 30):
    fs = P.LustreSim(n_osts=4)
    proj = fs.mkdir(fs.root_fid(), "proj")
    for i in range(n_files):
        f = fs.create(proj, f"data{i}.bin", owner=f"u{i % 3}")
        fs.write(f, (i + 1) * 100)
    return fs, proj


# -- registry ------------------------------------------------------------------

def _families(P):
    reg = P.MetricRegistry()
    reg.counter("events", kind="a").inc(3)
    reg.counter("events", kind="b").inc()
    reg.gauge("depth").set(7.5)
    h = reg.histogram("lat", edges=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["events"]["series"]["kind=a"] == 3
    assert snap["events"]["series"]["kind=b"] == 1
    assert snap["depth"]["series"][""] == 7.5
    hs = snap["lat"]["series"][""]
    assert hs["count"] == 4 and hs["counts"] == [1, 2, 1, 0]
    assert 0.01 <= hs["p50"] <= 0.1
    return snap


def test_counter_gauge_histogram_families():
    both(_families)


def _bounded(P):
    reg = P.MetricRegistry()
    h = reg.histogram("h", edges=(1.0, 2.0, 4.0))
    for i in range(10_000):
        h.observe(float(i % 5))
    assert len(h.counts) == 4        # fixed buckets, not 10k samples
    assert 1.0 <= h.percentile(0.5) <= 4.0
    return list(h.counts), h.percentile(0.5), h.percentile(0.99)


def test_histogram_memory_is_bounded_and_percentile_sane():
    both(_bounded)


def test_same_name_different_kind_rejected():
    reg = port().MetricRegistry()
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")


def test_disabled_registry_is_noop_but_readable():
    reg = port().MetricRegistry(enabled=False)
    reg.counter("c").inc(5)
    reg.histogram("h").observe(1.0)
    with reg.trace("t"):
        pass
    assert reg.counter("c").value == 0
    assert reg.histogram("h").count == 0
    assert reg.spans() == []


def _prometheus(P):
    reg = P.MetricRegistry()
    reg.counter("ops", help="ops done", stage='we"ird\nname').inc(2)
    reg.gauge("depth", mdt="0").set(3)
    reg.histogram("lat", edges=(0.1, 1.0)).observe(0.5)
    reg.state("why").set("policy_scan->numpy: glob")
    text = reg.render_prometheus()
    parsed = P.parse_prometheus(text)        # raises on malformed lines
    assert any(k.startswith("ops") for k in parsed)
    assert parsed['lat_bucket{le="+Inf"}'] == 1
    assert parsed['lat_count'] == 1
    with pytest.raises(ValueError):
        P.parse_prometheus("not a metric line at all }{")
    return text, parsed


def test_prometheus_roundtrip_and_escaping():
    both(_prometheus)


def test_callback_gauges_read_live_state():
    P = port()
    reg = P.MetricRegistry()
    depth = {"v": 1}
    reg.register_callback("queue_depth",
                          lambda: [({"q": "main"}, depth["v"])])
    assert reg.snapshot()["queue_depth"]["series"]["q=main"] == 1
    depth["v"] = 9
    assert reg.snapshot()["queue_depth"]["series"]["q=main"] == 9
    assert P.parse_prometheus(reg.render_prometheus())[
        'queue_depth{q="main"}'] == 9


def test_trace_nesting_and_threads():
    reg = port().MetricRegistry()
    with reg.trace("outer") as sp:
        with reg.trace("inner"):
            pass
        sp.annotate(tag=1)

    def worker():
        with reg.trace("thread_root"):
            pass

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    names = [s.name for s in reg.spans()]
    assert "outer" in names and "thread_root" in names
    outer = reg.spans("outer")[0]
    assert [c.name for c in outer.children] == ["inner"]
    assert outer.elapsed >= outer.children[0].elapsed
    # every close also feeds span_seconds{span=}
    assert reg.snapshot()["span_seconds"]["series"]["span=inner"]["count"] \
        == 1


def test_ambient_span_is_noop_outside_trace():
    P = port()
    with P.telemetry.span("orphan") as sp:   # no active trace: shared no-op
        sp.annotate(ignored=True)
    reg = P.MetricRegistry()
    with reg.trace("root"):
        with P.telemetry.span("child", idx=1):
            pass
    assert [c.name for c in reg.spans("root")[0].children] == ["child"]


def test_span_block_on_cpu_tensors_needs_no_card():
    """The port's one change to a span: ``block_on`` syncs the card only
    when it was handed CUDA tensors, so CPU tensors close without one."""
    import torch
    P = port()
    reg = P.MetricRegistry()
    with reg.trace("root"):
        with P.telemetry.span("wait") as sp:
            sp.block_on([torch.zeros(3), {"x": torch.ones(2)}])
    assert [c.name for c in reg.spans("root")[0].children] == ["wait"]
    assert not P.telemetry._holds_cuda([torch.zeros(1), {"a": (1, 2)}])


def _slug(P):
    s = P.telemetry.slug("policy_scan_mesh->policy_scan: no device store "
                         * 20)
    assert len(s) <= 60 and s == P.telemetry.slug(s)   # idempotent, bounded
    return s


def test_slug_bounds_label_cardinality():
    both(_slug)


# -- component wiring ----------------------------------------------------------

def _one_registry(P):
    fs, _ = _fs(P)
    cat = P.Catalog()
    stats = P.StatsAggregator(cat.strings)
    cat.add_delta_hook(stats.on_delta)
    P.Scanner(fs, cat).scan()
    rep = P.Reports(cat, stats)
    cat.arrays()
    rep.du("/proj")
    rep.find("size > 1000")
    values = cat.telemetry.counter_values()
    assert values['catalog_arrays_calls{catalog="catalog0"}'] \
        == cat.arrays_calls
    assert values['reports_host_served{reports="reports0"}'] \
        == rep.host_served == 2
    assert values['reports_index_rebuilds{reports="reports0"}'] \
        == rep.index_rebuilds
    return values


def test_one_registry_backs_all_component_counters():
    both(_one_registry)


def _shared(P):
    reg = P.MetricRegistry()
    a, b = P.Catalog(telemetry=reg), P.Catalog(telemetry=reg)
    a.arrays()
    a.arrays()
    b.arrays()
    assert a.arrays_calls == 2 and b.arrays_calls == 1
    vals = reg.counter_values()
    assert vals['catalog_arrays_calls{catalog="catalog0"}'] == 2
    assert vals['catalog_arrays_calls{catalog="catalog1"}'] == 1
    return vals


def test_injected_shared_registry_instance_labels():
    both(_shared)


def _pipeline(P):
    fs = P.LustreSim(n_mdts=1)
    d = fs.mkdir(fs.root_fid(), "dir")
    cat = P.Catalog()
    stream = fs.changelog.stream(0)
    pipe = P.EventPipeline(fs, cat, stream, P.PipelineConfig())
    assert stream.telemetry is cat.telemetry
    for i in range(10):
        f = fs.create(d, f"f{i}", owner="u", uid="u")
        fs.write(f, 100)
    assert stream.backlog() > 0
    pipe.process_once(100000)
    assert stream.backlog() == 0
    assert stream.lag_seconds() == 0.0
    vals = cat.telemetry.counter_values()
    assert vals['changelog_events_emitted{mdt="0"}'] >= 20
    assert vals['pipeline_records_processed{pipeline="pipeline0"}'] \
        == pipe.processed > 0
    series = cat.telemetry.snapshot()["changelog_backlog_mdt0"]["series"]
    assert series and all(v == 0 for v in series.values())
    return vals, series


def test_pipeline_and_stream_telemetry():
    both(_pipeline)


# -- scrape-boundary reset -----------------------------------------------------

def _reset(P):
    fs, _ = _fs(P)
    cat = P.Catalog()
    P.Scanner(fs, cat).scan()
    rep = P.Reports(cat)
    rep.du("/proj")
    rep.find("path == '/proj/*.bin'")      # glob: host fold
    assert rep.host_served == 2 and rep.index_rebuilds > 0
    assert cat.arrays_calls > 0
    # a fallback leaves both the string state and the counter family
    rep.last_fallback_reason = "find: synthetic"
    before = cat.telemetry.counter_values()
    assert any(v for v in before.values())
    rep.reset_counters()
    assert (rep.store_served, rep.host_served, rep.index_rebuilds) \
        == (0, 0, 0)
    assert rep.last_fallback_reason is None
    assert cat.arrays_calls == 0           # same registry, same boundary
    assert all(v == 0 for v in cat.telemetry.counter_values().values())
    hists = [f for f in cat.telemetry.snapshot().values()
             if f["kind"] == "histogram"]
    assert all(s["count"] == 0 for f in hists for s in f["series"].values())
    return before


def test_reset_counters_clears_every_family_together():
    both(_reset)


# -- the fallback chain as telemetry -------------------------------------------

def _engine(P, fs, cat, evaluator):
    P.Scanner(fs, cat).scan()
    eng = P.PolicyEngine(cat, clock=lambda: 2e9, **P.dev)
    hits = []
    eng.register(P.PolicyDefinition.from_config(
        "p", lambda e, params: hits.append(e) or True,
        scope="path == '/proj/*.bin'",   # glob: kernel paths must degrade
        evaluator=evaluator, mutates=False, dry_run=True))
    return eng


def _fallback_series(reg):
    return {name: value for name, value in reg.counter_values().items()
            if name.startswith("fallback{")}


def _chain(P):
    fs, _ = _fs(P)
    cat = P.Catalog()
    # no device store attached: policy_scan_mesh degrades to policy_scan,
    # whose glob predicate then degrades to numpy; both edges are counted
    rep = _engine(P, fs, cat, "policy_scan_mesh").run("p", matching="full")
    assert rep.evaluator == "numpy"
    assert "policy_scan_mesh->policy_scan" in rep.fallback_reason
    assert "policy_scan->numpy" in rep.fallback_reason
    series = _fallback_series(cat.telemetry)
    assert any('stage="policy_scan_mesh->policy_scan"' in k
               for k in series), series
    assert any('stage="policy_scan->numpy"' in k for k in series), series
    assert sum(series.values()) == 2
    run_counters = rep.telemetry["counters"]
    assert sum(v for k, v in run_counters.items()
               if k.startswith("fallback{")) == 2
    return rep.fallback_reason, series, run_counters


def test_fallback_chain_mesh_to_policy_scan_to_numpy():
    both(_chain)


def _policy_scan_only(P):
    fs, _ = _fs(P)
    cat = P.Catalog()
    rep = _engine(P, fs, cat, "policy_scan").run("p", matching="full")
    assert rep.evaluator == "numpy"
    assert rep.fallback_reason.startswith("policy_scan->numpy")
    series = _fallback_series(cat.telemetry)
    assert len(series) == 1 and sum(series.values()) == 1
    assert 'stage="policy_scan->numpy"' in next(iter(series))
    return rep.fallback_reason, series


def test_fallback_policy_scan_to_numpy_only():
    both(_policy_scan_only)


def test_no_fallback_records_nothing():
    P = port()
    fs, _ = _fs(P)
    cat = P.Catalog()
    rep = _engine(P, fs, cat, "numpy").run("p", matching="full")
    assert rep.fallback_reason == ""
    assert _fallback_series(cat.telemetry) == {}


def test_reports_fallback_counter_matches_string():
    P = port()
    fs, _ = _fs(P)
    cat = P.Catalog()
    P.Scanner(fs, cat).scan()
    rep = P.Reports(cat)
    rep.find("path == '/proj/*.bin'")
    # no store attached: host path, no fallback counter (nothing degraded)
    assert _fallback_series(cat.telemetry) == {}
    assert rep.last_fallback_reason is None


# -- run span tree -------------------------------------------------------------

def _span_names(node):
    return [node["name"], [_span_names(c) for c in node.get("children", [])]]


def _span_tree(P):
    fs, _ = _fs(P)
    cat = P.Catalog()
    eng = _engine(P, fs, cat, "numpy")
    rep = eng.run("p", matching="full")
    tree = rep.telemetry["spans"]
    assert tree["name"] == "run"
    child_names = [c["name"] for c in tree["children"]]
    assert child_names[:2] == ["run.ingest", "run.match"]
    assert "run.act" in child_names
    assert tree["elapsed_s"] >= 0
    # deltas only contain series this run actually moved
    assert all(v != 0 for v in rep.telemetry["counters"].values())
    # disabled registry: no per-run telemetry, run still works
    cat.telemetry.enabled = False
    rep2 = eng.run("p", matching="full")
    assert rep2.telemetry == {}
    return _span_names(tree), sorted(rep.telemetry["counters"])


def test_run_report_carries_span_tree_and_counter_deltas():
    both(_span_tree)


# -- alerts --------------------------------------------------------------------

def _alert_log(P, tmp_path):
    fs, proj = _fs(P, 5)
    cat = P.Catalog()
    log = tmp_path / f"{P.name}.log"
    with P.AlertManager(str(log), telemetry=cat.telemetry) as mgr:
        mgr.add_rule(P.AlertRule("big", "size > 250"))
        cat.add_entry_hook(mgr.on_entry)
        P.Scanner(fs, cat).scan()
        assert mgr._fh is not None          # lazy-opened once, kept open
        fired = len(mgr.fired)
        assert fired > 0
        lines = log.read_text().strip().splitlines()
        assert len(lines) == fired          # flushed per record
    assert mgr._fh is None                  # context manager closed it
    vals = cat.telemetry.counter_values()
    assert vals['alerts_fired{rule="big"}'] == fired
    # firing after close lazily reopens
    f = fs.create(proj, "huge.bin", owner="u0")
    fs.write(f, 10_000)
    P.Scanner(fs, cat).scan()
    assert len(mgr.fired) > fired
    mgr.close()
    return fired, len(mgr.fired), sorted(a["path"] for a in mgr.fired)


def test_alert_log_persistent_handle_and_counter(tmp_path):
    both(_alert_log, tmp_path)
