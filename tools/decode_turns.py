#!/usr/bin/env python3
"""Time the recurrent models' decode step, eager and graphed, on one card,
so two checkouts can be compared in turns.

    python3 tools/decode_turns.py [--src PATH] [--tag NAME] [--steps N]

For rwkv6-1.6b (8 sequences, cache length 576, from position 512) and
recurrentgemma-9b (4 sequences, 2,080, from 2,016: ``chip_smoke.py``'s
serving shapes, full width and depth, parameters drawn on the card from
seed 0), decode ``--steps`` tokens (16 by default) after 2 of warm-up
from a zero cache, greedily, and report the host-clock ms a step (ending
in a synchronize):

* ``eager``: ``model.decode_step`` and the argmax, chained;
* ``graphed``: ``serve.make_serve_step`` as a CUDA graph
  (``GraphedServeStep``), captured before the timing; null where the
  checkout has none.

``--src PATH`` imports ``repro_torch`` from another checkout's ``src``
(an older commit's, to time its eager step on the same card). Prints the
card's name and power limit, then one JSON line a model; needs one H100.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# arch, sequences, cache length, first position
MODELS = (("rwkv6_1p6b", 8, 576, 512), ("recurrentgemma_9b", 4, 2080, 2016))


def steps_ms(torch, step, cache, tokens, pos: int, n: int) -> float:
    """Host ms a step over ``n`` chained steps after 2 of warm-up."""
    for i in range(2):
        tokens, cache = step(cache, tokens, pos + i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        tokens, cache = step(cache, tokens, pos + 2 + i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--steps", type=int, default=16)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_turns: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import serve_step as SS
    dev = torch.device("cuda")
    for arch, batch, cache_len, pos in MODELS:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = Model(get_config(arch)).init(gen, dev)
        tokens = torch.randint(0, model.cfg.vocab, (batch, 1), generator=gen,
                               device=dev, dtype=torch.int64)

        def eager(cache, tok, p):
            logits, cache = model.decode_step(cache, tok, p)
            return torch.argmax(logits[:, -1], dim=-1)[:, None], cache
        eager_ms = steps_ms(torch, eager, model.init_cache(batch, cache_len),
                            tokens, pos, a.steps)
        graphed_ms = None
        if hasattr(SS, "GraphedServeStep"):
            step = SS.make_serve_step(model)
            step.capture(batch, cache_len)
            graphed_ms = steps_ms(torch, step,
                                  model.init_cache(batch, cache_len),
                                  tokens, pos, a.steps)
            del step
        print(json.dumps({"tag": a.tag, "src": a.src, "card": card,
                          "arch": arch, "batch": batch,
                          "cache_len": cache_len, "steps": a.steps,
                          "eager_ms": eager_ms, "graphed_ms": graphed_ms}),
              flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
