"""The readings a cell's limit is set from, on the card.

    python -m portbench.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out FILE]

For each seed, in one process: the seed's weights bound into the model,
as many whole batches of the cell's traffic through the timed path (the
cell's own load) as hold the requests a run judges, and the float32
reference over as many of them as a run judges: the program's ``mean_gap`` and ``token_gap`` (lower readings,
the largest over the seeds), and where the reference's routing is
recorded, where the large gaps fall against router near-ties. For each
control seed the reference is also put in the program's place in float8
(e4m3) products, the nearest precision below the configuration's
bfloat16: ``mean_gap.fp8`` and ``token_gap.fp8`` read the gaps of the
tokens it puts first (upper readings, the least over the control seeds).
One JSON line a seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from .run import use_checkout
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: CUDA is not available", file=sys.stderr)
        return 2
    use_checkout()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from .harness import Session
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = {int(x) for x in args.control_seeds.split(",") if x}
    device = torch.device("cuda", 0)
    s = Session(args.workload, device)
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        s.load_weights(seed)
        if n == 0:
            s.warm(seed)
        w = s.window(seed, 0.0, batches=s.check_batches)
        t1 = time.perf_counter()
        judged = s.judge(seed, w, ("fp8",) if seed in controls else (),
                         diagnose=True)
        judged.pop("sequence_gaps", None)
        rec = {"workload": args.workload, "seed": seed,
               "batch_s": t1 - t0, "judge_s": time.perf_counter() - t1,
               "peak_bytes": torch.cuda.max_memory_allocated(device),
               "card": torch.cuda.get_device_name(0), **judged}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
