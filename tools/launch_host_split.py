#!/usr/bin/env python3
"""Split the host time of one eager ``rglru_scan`` / ``rwkv6_step`` call
into its parts, on one card, at the recurrent serving paths' decode shapes.

    python3 tools/launch_host_split.py [--src PATH] [--tag NAME] [--calls N]

The decode shapes are ``chip_smoke.py``'s: ``rglru_scan`` (4, 1, 4096)
with ``h0`` (recurrentgemma-9b, 4 prompts) and ``rwkv6_step`` (8, 32, 64)
f32 (rwkv6-1.6b, 8 prompts). Each part is called ``--calls`` times (1,000
by default) after a warm-up, each call timed alone on the host clock
(``time.perf_counter_ns``), and the median kept:

* ``call``: the whole wrapper (``kernel.rglru_scan_cuda`` /
  ``kernel.rwkv6_step_cuda``), the card never drained in between;
* ``checks``: the argument checks alone (``kernel._check``);
* ``outputs``: ``torch.empty_like`` of the outputs;
* ``lib``: ``kernel._lib()`` once loaded;
* ``device context``: entering and leaving ``torch.cuda.device``;
* ``current device``: ``torch.cuda.current_device()``;
* ``stream object``: ``torch.cuda.current_stream(device).cuda_stream``;
* ``raw stream``: ``_launches.raw_stream(index)``;
* ``pointers``: the ``data_ptr()`` of every argument;
* ``ctypes launch``: the library's C launch function on ready pointers;
* ``count``: ``_launches.count`` (the capture test and the +1).

``--src PATH`` imports ``repro_torch`` from another checkout's ``src`` (an
older commit's, to time its ``call`` on the same card); parts that version
lacks are reported as null. Prints the card's name and power limit, then
one JSON line a kernel; needs one H100.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RG_PATH = (4, 1, 4096)
RW_PATH = (8, 32, 64)


def median_ns(fn, calls: int) -> float:
    """Median host ns of ``fn()`` over ``calls`` calls (after 50 of
    warm-up), each timed alone."""
    for _ in range(50):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    return float(statistics.median(times))


def parts(torch, K, launch_name: str, args, outputs, ptrs, counter: str,
          calls: int) -> dict:
    """name -> median host microseconds of each part (None where this
    version of ``K`` lacks it)."""
    dev = args[0].device
    idx = dev.index
    try:
        from repro_torch.kernels import _launches
    except ImportError:
        _launches = None
    wrapper = getattr(K, launch_name.replace("_launch", "_cuda"))
    lib = K._lib()
    cfn = getattr(lib, launch_name)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def device_context():
        with torch.cuda.device(dev):
            pass

    table = {
        "call": lambda: wrapper(*args),
        "checks": (lambda: K._check(*args)) if hasattr(K, "_check")
        else None,
        "outputs": lambda: [torch.empty_like(t) for t in outputs],
        "lib": K._lib,
        "device context": device_context,
        "current device": torch.cuda.current_device,
        "stream object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream": (lambda: _launches.raw_stream(idx))
        if _launches is not None else None,
        "pointers": lambda: [None if t is None else t.data_ptr()
                             for t in args + tuple(outputs)],
        "ctypes launch": lambda: cfn(*ptrs, stream),
        "count": (lambda: _launches.count(K.__name__, counter))
        if _launches is not None else None,
    }
    out = {}
    for name, fn in table.items():
        out[name] = None if fn is None else median_ns(fn, calls) / 1e3
        torch.cuda.synchronize()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--calls", type=int, default=1000)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("launch_host_split: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rwkv6_step import kernel as RWK
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    B, S, R = RG_PATH
    la = -torch.rand(RG_PATH, generator=g, device=dev) * 0.1
    b = torch.randn(RG_PATH, generator=g, device=dev)
    h0 = torch.randn((B, R), generator=g, device=dev)
    out = torch.empty_like(b)
    rg = parts(torch, RGK, "rglru_scan_launch", (la, b, h0), (out,),
               (la.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
                B, S, R), "rglru_scan_launches", a.calls)
    print(json.dumps({"tag": a.tag, "src": a.src, "card": card,
                      "kernel": "rglru_scan", "shape": list(RG_PATH),
                      "calls": a.calls, "median_us": rg}), flush=True)

    B, H, hd = RW_PATH
    r, k, v = (torch.randn(RW_PATH, generator=g, device=dev)
               for _ in range(3))
    w = torch.rand(RW_PATH, generator=g, device=dev)
    u = torch.randn((H, hd), generator=g, device=dev)
    s = torch.randn((B, H, hd, hd), generator=g, device=dev)
    y, s2 = torch.empty_like(r), torch.empty_like(s)
    rw = parts(torch, RWK, "rwkv6_step_launch", (r, k, v, w, u, s), (y, s2),
               tuple(t.data_ptr() for t in (r, k, v, w, u, s, y, s2))
               + (0, B, H, hd), "rwkv6_step_launches", a.calls)
    print(json.dumps({"tag": a.tag, "src": a.src, "card": card,
                      "kernel": "rwkv6_step", "shape": list(RW_PATH),
                      "calls": a.calls, "median_us": rw}), flush=True)


if __name__ == "__main__":
    main()
