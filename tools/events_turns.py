#!/usr/bin/env python3
"""What tracing costs on the card, and the breakdown by layer kind that
the program's own spans give (``portbench/events.py``), over one cell.

    python3 tools/events_turns.py --workload <cell> --seed <n> --steps 24

A decode cell: steps of one batch in turns, each turn ``--steps`` long:
plain (no trace), host spans only (a trace, the plain graph), events (a
trace and a timeline: the instrumented graph and the plain one in turns);
then the profiler started and stopped once, and plain and events again.
Each turn gives the host clock's ms a step (delivery to delivery) and of
the launch alone; an events turn adds ``Events.summary()``, the p95 of
the plain replay and of the gap after it, the spans' breakdown and the
counters. A prefill cell: ``--prefills`` prefills under a timeline,
``prefill.mix`` and ``prefill.ffn`` each. One JSON line on standard
output, also written to ``chiprun_out/events-<cell>-<seed>.json``; needs
one H100.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Dict, List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import events, run, stats  # noqa: E402
from portbench import traffic as traffic_mod  # noqa: E402
from portbench.harness import Session  # noqa: E402


def turns(s, seed: int, steps: int) -> Dict:
    """One batch's decode steps in turns of ``steps`` (module docstring).
    Host clock a step: ``step_ms`` from delivery to delivery,
    ``launch_ms`` the step call alone; ``epoch_s``: when a turn began and
    ended (``time.time()``, beside a log of the card's clocks)."""
    from repro_torch.core.telemetry import MetricRegistry
    prompts = traffic_mod.prompts(s.traffic, s.config["vocab"], seed, 0)
    logits, cache = s.prefill(torch.from_numpy(prompts).to(s.device))
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    del logits
    pos = s.P
    out: Dict[str, List] = {}

    def block(mode: str) -> None:
        nonlocal nxt, cache, pos
        ev = events.Events(s.device) if mode.startswith("events") else None
        trace = MetricRegistry().trace("host") if mode == "host" else None
        if ev is not None:
            ev.start()
        if trace is not None:
            trace.__enter__()
        step_s, launch_s = [], []
        nxt.cpu()
        begun = time.time()
        last = time.perf_counter()
        for _ in range(steps):
            nxt, cache = s.step(cache, nxt, pos)
            launched = time.perf_counter()
            nxt.cpu()
            step_s.append(time.perf_counter() - last)
            launch_s.append(launched - last)
            if ev is not None:
                ev.after_step()
            pos += 1
            last = time.perf_counter()
        if trace is not None:
            trace.__exit__(None, None, None)
        rec = {"epoch_s": [begun, time.time()],
               "step_ms": statistics.median(step_s) * 1e3,
               "step_p95_ms": stats.percentile(step_s, 95) * 1e3,
               "launch_ms": statistics.median(launch_s) * 1e3}
        if ev is not None:
            ev.stop()
            rec.update(ev.summary())
            graphs = [events.first(iv, events.GRAPH) for iv in ev.steps]
            plain = [i for i, f in enumerate(ev.full) if not f]
            rec["graph_p95_ms"] = stats.percentile(
                [graphs[i][2] - graphs[i][1] for i in plain], 95)
            rec["step_gap_p95_ms"] = stats.percentile(
                [graphs[i + 1][1] - graphs[i][2] for i in plain
                 if i + 1 < len(graphs)], 95)
            rec["breakdown"] = events.breakdown(ev.steps, ev.full)
            # decode.graph's start event is recorded before the launch:
            # from it to the graph's first span, the launch's latency
            rec["graph_lead_ms"] = statistics.median(
                min(start for name, start, _ in iv if name != events.GRAPH)
                - events.first(iv, events.GRAPH)[1]
                for iv, f in zip(ev.steps, ev.full) if f)
            rec["counters"] = ev.counters
        out.setdefault(mode, []).append(rec)

    for mode in ("plain", "host", "events", "events", "host", "plain"):
        block(mode)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(4):
            nxt, cache = s.step(cache, nxt, pos)
            nxt.cpu()
            pos += 1
    for mode in ("plain after profiler", "events after profiler"):
        block(mode)
    return out


def prefills(s, seed: int, n: int) -> Dict:
    ev = events.Events(s.device)
    ev.start()
    for i in range(n):
        prompts = traffic_mod.prompts(s.traffic, s.config["vocab"], seed, i)
        logits, cache = s.prefill(torch.from_numpy(prompts).to(s.device))
        del logits, cache
        ev.after_prefill()
    ev.stop()
    per = [events.summed(iv, "prefill.mix") for iv in ev.prefills]
    return {**ev.summary(), "prefill.mix_ms_each": per,
            "ffn_ms_each": [events.summed(iv, "prefill.ffn")
                            for iv in ev.prefills]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/events_turns.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--prefills", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        return run.fail("CUDA is not available: the events run on the card")
    run.use_checkout()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    s = Session(args.workload, device)
    s.load_weights(args.seed)
    s.warm(args.seed)
    events.Events(device).capture(s.step, s.B, s.cache_len)
    if s.traffic["trace"]["phase"] == "decode":
        result = turns(s, args.seed, args.steps)
    else:
        result = prefills(s, args.seed, args.prefills)
    result = {"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(device), **result}
    line = json.dumps(result)
    out = run.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"events-{args.workload}-{args.seed}.json").write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
