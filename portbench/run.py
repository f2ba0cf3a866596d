"""Run one cell of the benchmark on the card and print its result.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checked``: each number
compared with its limit); the last lines of standard error repeat the
numbers compared. ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer ones, from a run that profiles a part of the
window. Without a card, or with fewer than the cell asks for, it prints
no result and exits with 2; so it does where the checkout lacks the port
(``src/repro_torch``) or where a forbidden module (JAX, or the JAX
package ``repro``) was loaded.
"""
from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names of loaded modules, each compared whole, that a run
    may not load: JAX and the JAX package (``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def use_checkout() -> None:
    """Keeps every build and kernel cache in fixed directories of the
    checkout and puts its ``src/`` first on the path."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise FileNotFoundError(f"{src / 'repro_torch'}: the port under "
                                "test is not in this checkout")
    sys.path.insert(0, str(src))


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((c for c in bench["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available: the benchmark runs on the card")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} asks for {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} found")
    try:
        use_checkout()
    except FileNotFoundError as e:
        return fail(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checked = run_cell(bench, args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        return fail(f"forbidden modules loaded: {found}")
    for line in checked:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, smoke: bool = False):
    """Set-up, window and check of one cell on ``device`` (``smoke``: the
    configuration's and traffic's small sizes, for the CPU tests). Returns
    the result object and the lines that name each number compared with
    its limit."""
    import torch
    from .harness import Session
    from .metrics import Run, reader
    on_card = device.type == "cuda"
    marks = [("imports", time.perf_counter())]
    s = Session(workload, device, smoke=smoke, bench=bench)
    marks.append(("model", time.perf_counter()))
    s.load_weights(seed)
    marks.append(("weights", time.perf_counter()))
    s.warm(seed, trace=trace)
    if on_card:
        torch.cuda.synchronize()
    marks.append(("capture and warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - _START
    w = s.window(seed, seconds, trace=trace)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    s.free()

    run = Run(config=s.config, traffic=s.traffic, count=s.count,
              setup_s=setup_s, window=w)
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    judged = s.judge(seed, w)
    compared = {k: (judged.get(k), limit) for k, limit in s.limits.items()}
    correct = bool(judged) and all(v is not None and v <= limit
                                   for v, limit in compared.values())
    judged_n = len(judged.get("sequence_gaps", []))
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card
                   else device.type, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w.attempted,
              "failed": 0 if correct else judged_n,
              "metrics": metrics, "device": device_info}
    if w.trace is not None:
        device_info["busy_s"] = w.trace["busy_s"]
        device_info["window_s"] = w.trace["window_s"]
        result["breakdown"] = {"device_ops": w.trace["device_ops"],
                               "idle_gaps": w.trace["idle_gaps"]}
    steps = max(w.steps, 1)
    host_ms = {k: round(statistics.median(v) * 1e3, 4)
               for k, v in (("step", w.step_s), ("launch", w.launch_s)) if v}
    result["checked"] = {k: {"value": v, "limit": limit}
                         for k, (v, limit) in compared.items()}
    checked = [
        f"portbench: {workload} seed {seed}: {w.prefills} prefills, "
        f"{w.steps} decode steps, {len(w.finished)} batches finished in "
        f"{w.seconds} s; launches a decode step "
        f"{ {k: v / steps for k, v in w.launches.items() if v} }; host ms "
        f"a decode step (median) {host_ms}; judged "
        f"{judged_n} requests, {judged.get('judged_tokens', 0)} tokens: "
        f"widest gap {judged.get('token_gap')}, mean gap "
        f"{judged.get('mean_gap')}, mismatch {judged.get('mismatch')}; "
        f"set-up seconds {[(n, round(t - p, 3)) for (_, p), (n, t) in zip([('start', _START)] + marks, marks)]}"]
    checked += [f"checked {k} {v!r} limit {limit!r}"
                for k, (v, limit) in compared.items()]
    return result, checked


if __name__ == "__main__":
    sys.exit(main())
