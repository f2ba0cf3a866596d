#!/usr/bin/env python3
"""Time variants of the ``rglru_scan`` gradient kernel in turns on one card.

    python3 tools/rglru_bwd_variants.py [--unroll 8,16,32] [--turns 2]

Each variant is ``csrc/rglru_scan.cu`` with ``BWD_UNROLL`` (the time steps
whose loads a gradient thread issues before their sequential work) set to one of
``--unroll``, built with ``nvcc -Xptxas -v`` into a temporary library and
launched through its C entry point on the current stream. At the training
path's shape (2, 2560, 4096) and the kernel phase's (8, 4096, 4096), with
``h0``, each variant's dlog_a, db and dh0 must equal ``ref.rglru_bwd_ref``
bit for bit; then the variants are timed in turns (first to last, then
back), each call from an idle card by CUDA events, median of 10, beside
the bound (20 B an element plus h0 and dh0 over 3.35 TB/s). Prints the
card's name and power limit, each variant's registers and the order of its
global loads and stores in the SASS (``cuobjdump``), then one JSON line.
Needs one H100 and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "rglru_scan",
                    "csrc", "rglru_scan.cu")
SHAPES = ((2, 2560, 4096), (8, 4096, 4096))
HBM_BYTES_PER_S = 3.35e12
REPS = 10


def nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build(unroll: int, tmp: str) -> tuple:
    src = open(CSRC).read()
    src, n = re.subn(r"constexpr int BWD_UNROLL = \d+;",
                     f"constexpr int BWD_UNROLL = {unroll};", src)
    assert n == 1, "BWD_UNROLL not found"
    cu = os.path.join(tmp, f"rglru_u{unroll}.cu")
    so = os.path.join(tmp, f"librglru_u{unroll}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run(
        [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so,
         cu], capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed for BWD_UNROLL={unroll}:\n{proc.stderr}")
    regs = re.findall(r"Function properties for (\S+)[\s\S]*?Used (\d+) "
                      r"registers", proc.stderr)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc()),
                                        "cuobjdump"), "-sass", so],
                          capture_output=True, text=True).stdout
    body = sass.split("rglru_scan_bwd_kernel")[-1]
    order = "".join("L" if "LDG" in line else "S" for line in
                    body.splitlines() if "LDG" in line or "STG" in line)
    return so, {k.split("rglru_scan")[-1][:24]: int(v) for k, v in regs}, \
        order


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unroll", default="8,16,32")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.kernels import _launches
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rglru_scan import ref as RGR
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    unrolls = [int(u) for u in args.unroll.split(",")]
    out = {"card": card, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for u in unrolls:
            so, regs, order = build(u, tmp)
            lib = ctypes.CDLL(so)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.rglru_scan_bwd_launch.argtypes = [p] * 7 + [i, i, i, p]
            lib.rglru_scan_bwd_launch.restype = i
            libs[u] = lib
            out["variants"][u] = {"registers": regs, "sass_ldg_stg": order}
            print(f"BWD_UNROLL {u}: registers {regs}; bwd SASS global loads (L) "
                  f"and stores (S) in order: {order}", flush=True)
        for shape in SHAPES:
            g = torch.Generator(device=dev)
            g.manual_seed(sum(shape))
            B, S, R = shape
            la = -0.05 * torch.rand(shape, generator=g, device=dev)
            b = torch.randn(shape, generator=g, device=dev)
            h0 = torch.randn((B, R), generator=g, device=dev)
            gh = torch.randn(shape, generator=g, device=dev)
            h = RGK.rglru_scan_cuda(la, b, h0)
            want = RGR.rglru_bwd_ref(la, h, gh, h0)
            outs = [torch.empty_like(la), torch.empty_like(la),
                    torch.empty_like(h0)]

            def call(u):
                err = _launches.launch(
                    libs[u].rglru_scan_bwd_launch, dev.index or 0,
                    la.data_ptr(), h.data_ptr(), gh.data_ptr(),
                    h0.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                    outs[2].data_ptr(), B, S, R)
                assert err == 0, err
            for u in unrolls:
                call(u)
                torch.cuda.synchronize()
                ok = all(torch.equal(o, w) for o, w in zip(outs, want))
                if not ok:
                    sys.exit(f"BWD_UNROLL {u} at {shape}: differs from "
                             "rglru_bwd_ref")
            times = {u: [] for u in unrolls}
            order = []
            for t in range(args.turns):
                order += unrolls if t % 2 == 0 else unrolls[::-1]
            for u in order:
                for _ in range(2):
                    call(u)
                torch.cuda.synchronize()
                for _ in range(REPS):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    call(u)
                    e1.record()
                    e1.synchronize()
                    times[u].append(e0.elapsed_time(e1))
            bound = (20 * B * S * R + 8 * B * R) / HBM_BYTES_PER_S * 1e3
            for u in unrolls:
                ms = statistics.median(times[u])
                out["variants"][u][str(shape)] = {
                    "ms": ms, "min": min(times[u]), "max": max(times[u]),
                    "bound_ms": bound, "of_bound": bound / ms}
                print(f"{shape} BWD_UNROLL {u} {card}: {ms!r} ms (median of "
                      f"{len(times[u])} in {args.turns} turns, min "
                      f"{min(times[u])!r}, max {max(times[u])!r}); bound "
                      f"{bound!r} ms; {bound / ms:.3f} of it; equal to "
                      "rglru_bwd_ref", flush=True)
            del la, b, h0, gh, h, want, outs
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
