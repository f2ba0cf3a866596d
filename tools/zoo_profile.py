#!/usr/bin/env python3
"""Where the time goes in the model zoo's slowest paths on one card: one
whisper-large-v3 train step and graphed decode steps of llama3.2-vision-11b
and whisper-large-v3, under ``torch.profiler``.

    python3 tools/zoo_profile.py [--steps N]

* whisper-large-v3 at its published width and depth, ``make_train_step``
  with AdamW, accum 2, microbatch 2 x 448 tokens with (2, 1,500, 1,280)
  frames (``chip_smoke.py``'s ``[zoo-train]`` shape), after two warm-up
  steps: the step's wall (profiled), device ms, device operations, the
  largest operations by device time and by host time;
* llama3.2-vision-11b (2 x 512-token prompt, (2, 1,600, 4,096) image
  tokens) and whisper-large-v3 (4 x 64, (4, 1,500, 1,280) frames) served
  through ``make_prefill`` and the graphed ``make_serve_step``: ``--steps``
  decode steps (4 by default) after 3 of warm-up, their wall, device ms
  and the largest operations.

Cross-attention gates are set to 1.0, weights drawn on the card from seed
0, TF32 off. Prints the card's name and power limit, then ``[prof]``
lines; needs one H100.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top(c, prof, n: int):
    """(device ms, device operations, the n largest by device time)."""
    rows = c.device_rows(prof)
    return (sum(r[1] for r in rows) / 1e3, sum(r[2] for r in rows),
            [[k[:70], round(us / 1e3, 3), cnt] for k, us, cnt in rows[:n]])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        sys.exit("zoo_profile: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.train import init_train_state, make_train_step
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    cfg = c.zoo_config("whisper_large_v3", None)
    model = Model(cfg)
    opt = AdamW(lr=3e-4, weight_decay=0.01)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = init_train_state(model, opt, g)
    c.set_gates(torch, model, 1.0)
    tok = torch.randint(0, cfg.vocab, (2, 2, 448), generator=g, device=dev)
    ex = c.zoo_extras(torch, cfg, 4, g, dev)
    batch = {"tokens": tok, "labels": tok, "extras": {
        k: v.reshape(2, 2, *v.shape[1:]) for k, v in ex.items()}}
    step = make_train_step(model, opt)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dms, nops, rows = top(c, prof, 12)
    host = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)[:12]
    print(f"[prof] whisper_large_v3 train step: wall {wall!r} s (profiled), "
          f"device {dms!r} ms, {nops} device operations", flush=True)
    print("[prof] top by device ms " + json.dumps(rows))
    print("[prof] top by host ms " + json.dumps(
        [[e.key[:60], round(e.cpu_time_total / 1e3, 2), e.count]
         for e in host]), flush=True)
    del model, state, step, opt, batch
    torch.cuda.empty_cache()

    for arch, B, P in (("llama3p2_vision_11b", 2, 512),
                       ("whisper_large_v3", 4, 64)):
        cfg = c.zoo_config(arch, None)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        model = Model(cfg).init(g, dev)
        c.set_gates(torch, model, 1.0)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=g, device=dev)
        ex = c.zoo_extras(torch, cfg, B, g, dev)
        n = 3 + args.steps
        last, cache = make_prefill(model, P + n)(prompt, ex)
        st = make_serve_step(model)
        st.capture(B, P + n)
        nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
        for i in range(3):
            nxt, cache = st(cache, nxt, P + i)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(args.steps):
                nxt, cache = st(cache, nxt, P + 3 + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dms, nops, rows = top(c, prof, 15)
        print(f"[prof] {arch} {args.steps} graphed decode steps: wall "
              f"{wall!r} s, device {dms!r} ms, {nops} device operations")
        print("[prof] top by device ms " + json.dumps(rows), flush=True)
        del model, st, cache
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
