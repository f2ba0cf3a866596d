"""Live `robinhood --top`-style status board off the telemetry registry,
on the port.

Runs the full pipeline (changelog ingest -> catalog -> device store ->
policy runs -> report serving) against the simulated Lustre while a
background mutator keeps the filesystem churning, and every refresh
interval repaints one status frame computed *entirely* from
``catalog.telemetry`` — counter deltas for rates, callback gauges for
backlog/lag, histograms for serve latency — plus the usual top-files
table. Nothing here reaches into component internals: if the board can
show it, an external Prometheus scrape of ``render_prometheus()`` can
too.

The port of ``examples/fs_top.py`` through ``repro_torch``. The port's
column store lives on one device, not a mesh: ``DeviceColumnStore(cat,
groups=1, device=...)`` takes the reference's ``mesh=None``; the sweep's
``policy_scan_mesh`` matches and ``find`` run the store form of the
``policy_scan`` kernel on the card. ``--device`` (default the card) is
the store's and the engine's. ``main`` returns each frame's sweep
report.

    PYTHONPATH=src python examples/torch_fs_top.py          # 5 frames
    PYTHONPATH=src python examples/torch_fs_top.py 20       # more frames
    PYTHONPATH=src python examples/torch_fs_top.py --device cpu
"""
import argparse
import random
import time

from repro_torch.core import (Catalog, DeviceColumnStore, EventPipeline,
                              PipelineConfig, PolicyDefinition, PolicyEngine,
                              Reports, StatsAggregator, format_size)
from repro_torch.fs import LustreSim

INTERVAL = 0.5          # seconds per frame
N_FILES = 2_000


def build(device=None):
    fs = LustreSim(n_osts=4, n_mdts=1)
    proj = fs.mkdir(fs.root_fid(), "proj")
    rng = random.Random(7)
    fids = []
    for i in range(N_FILES):
        f = fs.create(proj, f"f{i}.dat", owner=f"u{i % 5}",
                      uid=f"u{i % 5}")
        fs.write(f, rng.randrange(100, 1_000_000))
        fids.append(f)

    cat = Catalog(n_shards=4)
    stats = StatsAggregator(cat.strings)
    cat.add_delta_hook(stats.on_delta)
    stream = fs.changelog.stream(0)
    pipe = EventPipeline(fs, cat, stream, PipelineConfig())
    pipe.process_once(10 * N_FILES)

    store = DeviceColumnStore(cat, groups=1, device=device)
    store.refresh()
    rep = Reports(cat, stats).attach_device_store(store)
    eng = PolicyEngine(cat, device=device)
    eng.attach_device_store(store)
    eng.register(PolicyDefinition.from_config(
        "sweep", lambda e, params: True, scope="size > 500k",
        evaluator="policy_scan_mesh", mutates=False, dry_run=True))
    return fs, proj, fids, rng, stream, pipe, store, rep, eng


def churn(fs, proj, fids, rng):
    """One tick of filesystem activity for the pipeline to chase."""
    for _ in range(200):
        fs.write(rng.choice(fids), rng.randrange(100, 1_000_000))
    f = fs.create(proj, f"new{rng.randrange(1 << 30)}.dat", owner="u0",
                  uid="u0")
    fs.write(f, rng.randrange(100, 1_000_000))
    fids.append(f)


def _hist(snap, name):
    fam = snap.get(name, {}).get("series", {})
    out = {}
    for labels, s in fam.items():
        out[labels] = s
    return out


def frame(i, reg, prev_counters, dt, rep):
    snap = reg.snapshot()
    cur = reg.counter_values()
    rate = {k: (cur.get(k, 0) - prev_counters.get(k, 0)) / dt
            for k in cur}

    def r(prefix):
        return sum(v for k, v in rate.items() if k.startswith(prefix))

    def tot(prefix):
        return int(sum(v for k, v in cur.items() if k.startswith(prefix)))

    lag = max((v for k, f in snap.items() if k.startswith("changelog_lag")
               for v in f["series"].values()), default=0.0)
    backlog = int(sum(v for k, f in snap.items()
                      if k.startswith("changelog_backlog")
                      for v in f["series"].values()))

    print(f"\x1b[2J\x1b[H== fs_top — frame {i} "
          f"(every {INTERVAL:.1f}s, all numbers from the registry) ==")
    print(f"ingest   {r('pipeline_events_folded'):8.0f} ev/s folded   "
          f"backlog {backlog:6d} rec   lag {lag:6.2f}s")
    print(f"refresh  {r('store_rows_scattered'):8.0f} rows/s scattered "
          f" bytes {format_size(int(r('store_bytes_moved')))}/s   "
          f"full uploads {tot('store_full_uploads')}")
    print(f"matching {r('store_queries'):8.0f} store queries/s   "
          f"fallbacks {tot('fallback')}   "
          f"alerts {tot('alerts_fired')}")
    lat = _hist(snap, "reports_serve_seconds")
    if lat:
        print("serve latency (per query kind):")
        for labels, s in sorted(lat.items()):
            if not s["count"]:
                continue
            print(f"  {labels:<55} n={s['count']:<5d} "
                  f"p50={s['p50'] * 1e3:7.2f}ms p99={s['p99'] * 1e3:7.2f}ms")
    print("top consumers (Reports.top_files, served from the store):")
    for e in rep.top_files(by="size", k=5):
        print(f"  {format_size(int(e['size'])):>10}  {e['path']}")
    return cur


def main(n_frames: int = 5, device=None) -> list:
    fs, proj, fids, rng, stream, pipe, store, rep, eng = build(device)
    sweeps = []
    reg = rep.telemetry
    prev = reg.counter_values()
    t_prev = time.perf_counter()
    for i in range(n_frames):
        churn(fs, proj, fids, rng)
        pipe.process_once(100_000)
        store.refresh()
        sweeps.append(eng.run("sweep", matching="full"))
        rep.du("/proj")
        rep.find("size > 800k")
        now = time.perf_counter()
        prev = frame(i, reg, prev, max(now - t_prev, 1e-9), rep)
        t_prev = now
        time.sleep(max(0.0, INTERVAL - (time.perf_counter() - now)))
    print("\nPrometheus exposition (first 12 lines of "
          "registry.render_prometheus()):")
    for line in reg.render_prometheus().splitlines()[:12]:
        print(" ", line)
    return sweeps


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n_frames", type=int, nargs="?", default=5)
    ap.add_argument("--device", default=None,
                    help='"cuda" (the default) or "cpu"')
    args = ap.parse_args()
    main(args.n_frames, device=args.device)
