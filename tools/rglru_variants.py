#!/usr/bin/env python3
"""Build designs of the ``rglru_scan`` kernels, read what the compiler made
of them, check them bit for bit and time them in turns on one card.

    python3 tools/rglru_variants.py [--variants current,bulk,...]
        [--turns 2] [--reps 5] [--seed S]

A variant is ``csrc/rglru_scan.cu`` as it stands ("current") or the ring
design with one bulk copy a row for a producer
(``tools/rglru_scan_bulk.cu``, "bulk"), each with ``constexpr int``
constants set: ``current:GROUP=64+FWD_STAGES=8``.
Each is written to a temporary directory (the checkout is never changed)
and built with ``nvcc -Xptxas -v``, one process each, started together:
registers, spills and static shared memory of every kernel, and the ring
kernels' dynamic shared memory and resident blocks an SM.

Then, with ``chip_smoke.py``'s inputs (decays as recurrentgemma-9b draws
them, b, h0 and gh standard normal, from the seed), every variant's
forward at (2, 2560, 4096), (4, 2016, 4096) and (8, 4096, 4096) must equal
``ref.rglru_ref`` and its gradient at (2, 2560, 4096) and (8, 4096, 4096)
``ref.rglru_bwd_ref`` under ``torch.equal``, with and without h0, twice.
All variants are timed in turns (first to last, then back, ``--turns``
times; ``--reps`` calls from an idle card by CUDA events each time, as
``chip_smoke.py`` times, each launched straight through the library's C
entry point), beside the bound (each input read once, each output written
once, over 3.35 TB/s), and the decode step (4, 1, 4096) as a call launched
from a CUDA graph of 64 calls. Needs one H100 and the CUDA toolkit.
Prints the card's name and power limit, one line a variant and a shape,
then one JSON line; exits non-zero when a build fails or an output
differs.
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
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "rglru_scan",
                    "csrc", "rglru_scan.cu")
BASES = {"current": CSRC,
         "bulk": os.path.join(ROOT, "tools", "rglru_scan_bulk.cu")}
FWD_SHAPES = ((2, 2560, 4096), (4, 2016, 4096), (8, 4096, 4096))
BWD_SHAPES = ((2, 2560, 4096), (8, 4096, 4096))
DECODE = (4, 1, 4096)


def source(spec: str) -> str:
    """The .cu text of a variant: its base, then each ``NAME=value``
    constant set."""
    base, _, edits = spec.partition(":")
    if base not in BASES:
        sys.exit(f"rglru_variants: unknown design {base!r} (not one of "
                 f"{sorted(BASES)})")
    with open(BASES[base]) as f:
        text = f.read()
    for edit in filter(None, edits.split("+")):
        name, _, value = edit.partition("=")
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            sys.exit(f"rglru_variants: {spec!r}: constant {name} occurs {n} "
                     "times in the source")
    return text


def build(spec: str, workdir: str) -> dict:
    """Compile one variant into a shared library with ``-Xptxas -v``;
    returns its path and the ptxas report of each kernel."""
    from repro_torch.kernels._build import NVCC_FLAGS
    from scan_variants import ptxas_info, tool
    d = os.path.join(workdir, re.sub(r"\W", "_", spec))
    os.makedirs(d, exist_ok=True)
    cu = os.path.join(d, "rglru_scan.cu")
    with open(cu, "w") as f:
        f.write(source(spec))
    lib = os.path.join(d, "librglru_scan.so")
    proc = subprocess.run([tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           lib, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {spec}:\n{proc.stderr}")
    info = ptxas_info(proc.stderr)
    return dict(lib=lib, ptxas={re.sub(r"\(.*", "", k).replace(
        "void ", "").replace("rglru_scan::", ""): v for k, v in info.items()})


class Variant:
    """One built library (its path, or the library already loaded),
    launched through its C entry points on the current stream into outputs
    the caller allocates."""

    def __init__(self, name: str, lib):
        self.name = name
        if not isinstance(lib, ctypes.CDLL):
            lib = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_launch.argtypes = [p, p, p, p, i, i, i, p]
        lib.rglru_scan_launch.restype = i
        lib.rglru_scan_bwd_launch.argtypes = [p] * 7 + [i, i, i, p]
        lib.rglru_scan_bwd_launch.restype = i
        lib.rglru_scan_ring_shape.argtypes = [i, ctypes.POINTER(i)]
        lib.rglru_scan_ring_shape.restype = i
        lib.rglru_scan_prepare.restype = i
        err = lib.rglru_scan_prepare()
        if err != 0:
            raise RuntimeError(f"{name}: rglru_scan_prepare failed ({err})")
        self.lib = lib

    def ring_shape(self, backward: bool):
        """The ring kernel's launch shape (``kernel.RING_FIELDS``)."""
        from repro_torch.kernels.rglru_scan.kernel import RING_FIELDS
        out = (ctypes.c_int * len(RING_FIELDS))()
        err = self.lib.rglru_scan_ring_shape(int(backward), out)
        if err != 0:
            raise RuntimeError(f"{self.name}: rglru_scan_ring_shape ({err})")
        return dict(zip(RING_FIELDS, out))

    def fwd(self, la, b, h0, out) -> None:
        from repro_torch.kernels import _launches
        B, S, R = la.shape
        err = _launches.launch(
            self.lib.rglru_scan_launch, la.device.index, la.data_ptr(),
            b.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), B, S, R)
        if err != 0:
            raise RuntimeError(f"{self.name}: forward launch failed ({err})")

    def bwd(self, la, h, gh, h0, dla, db, dh0) -> None:
        from repro_torch.kernels import _launches
        B, S, R = la.shape
        err = _launches.launch(
            self.lib.rglru_scan_bwd_launch, la.device.index, la.data_ptr(),
            h.data_ptr(), gh.data_ptr(),
            None if h0 is None else h0.data_ptr(), dla.data_ptr(),
            db.data_ptr(), dh0.data_ptr(), B, S, R)
        if err != 0:
            raise RuntimeError(f"{self.name}: gradient launch failed ({err})")


def build_all(specs, workdir: str) -> dict:
    """spec -> (Variant, ptxas report), built in parallel."""
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        built = dict(zip(specs, pool.map(lambda s: build(s, workdir),
                                         specs)))
    return {s: (Variant(s, b["lib"]), b["ptxas"]) for s, b in built.items()}


def in_turns(fns: dict, turns: int, reps: int, timer) -> dict:
    """name -> every time ``timer(fn, reps)`` took, the names walked first
    to last, then back, ``turns`` times."""
    names = list(fns)
    times = {n: [] for n in names}
    for t in range(turns):
        for n in (names if t % 2 == 0 else names[::-1]):
            times[n] += timer(fns[n], reps)
    return times


def fwd_equal(torch, variant, la, b, h0) -> bool:
    """The forward equal to ``rglru_ref`` bit for bit, twice, with h0 and
    without."""
    from repro_torch.kernels.rglru_scan import ref as RGR
    for h0_arg in (h0, None):
        want = RGR.rglru_ref(la, b, h0 if h0_arg is not None
                             else torch.zeros_like(h0))
        for _ in range(2):
            out = torch.empty_like(la)
            variant.fwd(la, b, h0_arg, out)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                return False
    return True


def bwd_equal(torch, variant, la, h, gh, h0) -> bool:
    """The gradient (dlog_a, db, dh0) equal to ``rglru_bwd_ref`` bit for
    bit, twice, with h0 and without."""
    from repro_torch.kernels.rglru_scan import ref as RGR
    for h0_arg in (h0, None):
        want = RGR.rglru_bwd_ref(la, h, gh, h0 if h0_arg is not None
                                 else torch.zeros_like(h0))
        for _ in range(2):
            outs = (torch.empty_like(la), torch.empty_like(la),
                    torch.empty_like(h0))
            variant.bwd(la, h, gh, h0_arg, *outs)
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                return False
    return True


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current,bulk")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.rglru_scan import ref as RGR
    if not torch.cuda.is_available():
        sys.exit("rglru_variants: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cs.CARD = card
    print(card, flush=True)
    dev = torch.device("cuda")
    specs = args.variants.split(",")
    out = {"card": card, "variants": {}, "forward": {}, "gradient": {}}
    with tempfile.TemporaryDirectory() as tmp:
        variants = build_all(specs, tmp)
        for spec, (v, ptxas) in variants.items():
            rec = {"ptxas": ptxas, "ring_forward": v.ring_shape(False),
                   "ring_gradient": v.ring_shape(True)}
            out["variants"][spec] = rec
            print(f"{spec}: {json.dumps(rec)}", flush=True)

        def timer(fn, reps):
            return cs.cuda_times_ms(fn, reps)[1]

        def report(kind, shape, bound, times):
            res = {}
            for spec, t in times.items():
                ms = statistics.median(t)
                res[spec] = dict(ms=ms, min=min(t), max=max(t), n=len(t),
                                 bound_ms=bound, of_bound=bound / ms)
                print(f"{kind} {shape} {spec} {card}: {ms!r} ms (median of "
                      f"{len(t)} in {args.turns} turns, min {min(t)!r}, max "
                      f"{max(t)!r}); bound {bound!r} ms; {bound / ms:.3f} "
                      "of it", flush=True)
            out[kind][str(shape)] = res

        for i, shape in enumerate(FWD_SHAPES):
            la, b, h0 = cs.rglru_inputs(torch, shape, args.seed + 20 + i, dev)
            for spec, (v, _) in variants.items():
                if not fwd_equal(torch, v, la, b, h0):
                    sys.exit(f"{spec} forward at {shape}: differs from "
                             "rglru_ref")
            outs = {s: torch.empty_like(la) for s in variants}
            fns = {s: (lambda v=v, o=outs[s]: v.fwd(la, b, h0, o))
                   for s, (v, _) in variants.items()}
            report("forward", shape, cs.rglru_bound_ms(shape, True)[0],
                   in_turns(fns, args.turns, args.reps, timer))
            del la, b, h0, outs
            torch.cuda.empty_cache()
        for i, shape in enumerate(BWD_SHAPES):
            la, b, h0 = cs.rglru_inputs(torch, shape, args.seed + 50 + i, dev)
            g = torch.Generator(device=dev)
            g.manual_seed(args.seed + 60 + i)
            gh = torch.randn(shape, generator=g, device=dev)
            h = RGR.rglru_ref(la, b, h0)
            for spec, (v, _) in variants.items():
                if not bwd_equal(torch, v, la, h, gh, h0):
                    sys.exit(f"{spec} gradient at {shape}: differs from "
                             "rglru_bwd_ref")
            outs = {s: (torch.empty_like(la), torch.empty_like(la),
                        torch.empty_like(h0)) for s in variants}
            fns = {s: (lambda v=v, o=outs[s]: v.bwd(la, h, gh, h0, *o))
                   for s, (v, _) in variants.items()}
            report("gradient", shape, cs.rglru_bwd_bound_ms(shape, True)[0],
                   in_turns(fns, args.turns, args.reps, timer))
            del la, b, h0, gh, h, outs
            torch.cuda.empty_cache()
        la, b, h0 = cs.rglru_inputs(torch, DECODE, args.seed + 25, dev)
        for spec, (v, _) in variants.items():
            if not fwd_equal(torch, v, la, b, h0):
                sys.exit(f"{spec} decode step: differs from rglru_ref")
        outs = {s: torch.empty_like(la) for s in variants}
        fns = {s: (lambda v=v, o=outs[s]: v.fwd(la, b, h0, o))
               for s, (v, _) in variants.items()}
        times = in_turns(fns, args.turns, 1,
                         lambda fn, _: [cs.graph_call_ms(torch, fn)[0]])
        out["decode_graph_call_ms"] = {
            s: dict(ms=statistics.median(t), each_turn=t)
            for s, t in times.items()}
        for s, t in times.items():
            print(f"decode {DECODE} {s} {card}: graph-launched "
                  f"{statistics.median(t)!r} ms a call (each turn: {t}; a "
                  f"graph of {cs.GRAPH_CALLS} calls, median of {cs.REPS} "
                  "replays)", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
