#!/usr/bin/env python3
"""Streamed scans of bench_tiering's catalog on one card, in turns.

    python3 tools/tiered_turns.py [--entries N] [--turns T]

Builds ``chip_smoke.tiering_catalog`` (2,000,000 entries by default, 16
shards) under ``DeviceColumnStore(groups=8, hbm_budget_rows=200_000)``, so
every group streams, and times ``store.scan`` of bench_tiering's
``MATCH_EXPR`` (host clock ending in a synchronize, 5 scans a turn) with
the store form's program arrays uploaded once a program set (what the op
does) against uploaded at every launch (what it did before: an upload
from pageable memory waits for the stream, so each window's launch waited
for that window's copy), in turns: every launch, once, once, every launch.
Prints, with the card's name and power limit, each variant's median and
all its times, and per scan the host seconds of the window spans
(``store.window.stage`` / ``.copy`` / ``.launch``) and the window stalls.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entries", type=int, default=2_000_000)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this tool needs a card")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as c
    from repro_torch.core import DeviceColumnStore, parse_expr
    from repro_torch.kernels.policy_scan import ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    cat = c.tiering_catalog(args.entries, 0)
    store = DeviceColumnStore(cat, groups=c.TIER_GROUPS, device="cuda",
                              hbm_budget_rows=c.TIER_BUDGET)
    store.refresh()
    expr = parse_expr(c.TIER_EXPR)
    once = ops._program_tensors
    variants = {"every launch": once.__wrapped__, "once": once}
    spans = ("store.window.stage", "store.window.copy", "store.window.launch")
    hist = {n: store.telemetry.histogram("span_seconds", span=n)
            for n in spans}
    out = {k: dict(times=[], stalls=0, spans=dict.fromkeys(spans, 0.0))
           for k in variants}
    store.scan(expr, c.TIER_NOW)                 # warm-up: builds, caches
    torch.cuda.synchronize()
    try:
        for _ in range(args.turns):
            for name in ("every launch", "once", "once", "every launch"):
                ops._program_tensors = variants[name]
                rec = out[name]
                h0 = {n: hist[n].sum for n in spans}
                s0 = store.window_stalls
                for _ in range(5):
                    t0 = time.perf_counter()
                    store.scan(expr, c.TIER_NOW)
                    torch.cuda.synchronize()
                    rec["times"].append(time.perf_counter() - t0)
                rec["stalls"] += store.window_stalls - s0
                for n in spans:
                    rec["spans"][n] += hist[n].sum - h0[n]
    finally:
        ops._program_tensors = once
    for name, rec in out.items():
        n = len(rec["times"])
        print(f"[tiered-turns] {card}: program upload {name}: streamed scan "
              f"median {statistics.median(rec['times'])!r} s of {n} "
              f"(all {json.dumps(rec['times'])}); per scan host s "
              + ", ".join(f"{k.rsplit('.', 1)[1]} {v / n!r}"
                          for k, v in rec["spans"].items())
              + f"; window stalls {rec['stalls']} in {n} scans "
              f"({store.windows_streamed} windows streamed in all)",
              flush=True)
    store.detach()


if __name__ == "__main__":
    main()
