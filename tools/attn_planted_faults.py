#!/usr/bin/env python3
"""Plant faults in the bf16 ``paged_attention`` kernels and report which
of ``chip_smoke.py``'s tolerances catch them.

    python3 tools/attn_planted_faults.py [--seed S]

Each fault is one edit of ``csrc/paged_attention.cu`` (in the bf16
tensor-core split kernel or in the combine), made in a copy of
``src/repro_torch`` in a temporary directory, so the checkout is never
changed, and built there with ``nvcc``: all faults at once, one process
each. On its faulty kernel each process runs the bf16 inputs of
``chip_smoke.py``'s attention phase at chatglm3-6b's widths (the
64-sequence batch and the one 8,192-token sequence, from the same seed)
and applies ``chip_smoke.attn_close``: the elementwise tolerance and the
per-row relative L2 limit. Needs one H100. Prints one JSON line a fault
and exits 0 when the unchanged kernel passes both and every fault fails
the per-row limit in at least one case.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("repro_torch", "kernels", "paged_attention", "csrc",
                      "paged_attention.cu")
BF16_CASE = "chatglm3-6b bf16"
# fault -> (the function the edit lies in, the text, its replacement)
FAULTS = {
    "none": None,
    "split 1 dropped": ("mma_split_kernel(const",
                        "const int n_pg = n_mine;",
                        "const int n_pg = split == 1 ? 0 : n_mine;"),
    "warp 3's rows of each tile dropped": (
        "mma_split_kernel(const", "if (w0 >= n) continue;",
        "if (w0 >= n || warp == 3) continue;"),
    "combine leaves P unnormalised": ("combine_kernel(const",
                                      "from_f32<T>(a / denom)",
                                      "from_f32<T>(a)"),
}


def plant(src_dir: str, fault) -> None:
    """Apply ``fault`` to the copy of the source under ``src_dir``: the
    first occurrence of its text after the function's definition."""
    if fault is None:
        return
    where, old, new = fault
    path = os.path.join(src_dir, SOURCE)
    with open(path) as f:
        text = f.read()
    at = text.index(where)
    hit = text.index(old, at)
    with open(path, "w") as f:
        f.write(text[:hit] + new + text[hit + len(old):])


def worker(name: str, seed: int) -> None:
    """Run the bf16 attention inputs on the kernel this process imports
    (the planted copy) and print one JSON line."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.paged_attention import kernel as AK
    from repro_torch.kernels.paged_attention import ref as AR
    if not AK.__file__.startswith(os.environ["PLANTED_SRC"]):
        raise RuntimeError(f"imported {AK.__file__}, not the planted copy")
    device = torch.device("cuda")
    H, K, hd = next(c[1:4] for c in cs.ATTN_CONFIGS if c[0] == BF16_CASE)
    lengths, table = cs.attn_tables(torch, seed + 3, device)
    long_len, long_table = cs.attn_long_table(torch, seed + 5, device)
    cases = {"batch": (lengths, table, cs.ATTN_POOL),
             "B=1, 8192 tokens": (long_len, long_table, cs.ATTN_MAX_PAGES)}
    out = {"fault": name}
    for case, (ln, tb, pool) in cases.items():
        q, kp, vp = cs.attn_inputs(torch, H, K, hd, torch.bfloat16,
                                   tb.shape[0], pool, seed, device)
        got = AK.paged_attention_cuda(q, kp, vp, tb, ln)
        want = AR.paged_attention_ref(q, kp, vp, tb, ln)
        out[case] = cs.attn_close(torch, got, want,
                                  float(vp.float().abs().max().item()),
                                  "bfloat16")
        del q, kp, vp, got, want
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.seed)
        return 0
    tmp = tempfile.mkdtemp(prefix="attn_faults_")
    procs = {}
    try:
        for i, (name, fault) in enumerate(FAULTS.items()):
            src = os.path.join(tmp, str(i), "src")
            shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                            os.path.join(src, "repro_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            plant(src, fault)
            env = dict(os.environ, PYTHONPATH=os.pathsep.join((src, ROOT)),
                       PLANTED_SRC=src, REPRO_TORCH_BUILD_DIR=os.path.join(
                           tmp, str(i), "build"))
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", name,
                 "--seed", str(args.seed)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        ok = True
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            if proc.returncode != 0:
                print(f"{name}: failed ({proc.returncode}):\n{stderr}",
                      file=sys.stderr)
                ok = False
                continue
            res = json.loads(stdout.strip().splitlines()[-1])
            print(json.dumps(res), flush=True)
            verdicts = [res[c] for c in res if c != "fault"]
            if name == "none":
                ok &= all(v["ok"] for v in verdicts)
            else:
                ok &= any(not v["rows"] for v in verdicts)
        return 0 if ok else 1
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
