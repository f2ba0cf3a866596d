#!/usr/bin/env python3
"""Build variants of the ``policy_scan`` CUDA kernel, read what the
compiler made of them, and time them in turns on one card.

    python3 tools/scan_variants.py [--variants NAME,...] [--parent DIR,...]
        [--programs batch,single,wide,allcols] [--rows N] [--turns N]
        [--seed S]

A variant is ``csrc/`` as it stands ("current") or a design of
``tools/policy_scan_designs.cu`` (the first kernel, with its ``VARIANT``
constant set): "v0" as it was, "v1" without the aggregate code, "v2"
with each row's referenced columns loaded once before the program loop,
"v3" a copy kernel that reads the same columns and writes R + 1 words a
row. Each is written to a temporary directory, so the checkout is never
changed; ``--parent DIR,...`` adds older ``csrc/`` directories
(``policy_scan.cu`` and its header, e.g. ``git archive <commit>`` of
``src/repro_torch/kernels/policy_scan/csrc`` unpacked under ``build/``),
each named by its directory. Every variant is built with ``nvcc -Xptxas
-v`` at once, one process each (registers, spills and shared memory of
each kernel), and its resident blocks an SM come from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.

Then ``chip_smoke.py``'s 2^27 rows are generated from the seed and each
variant runs ``BATCH_CRITERIA`` (R = 4, "batch"), its first program (R =
1, "single"), those and 4 more rules (R = 8, "wide") or those and
``chip_smoke.WIDE_CRITERIA``'s 2 rules that read every kernel column (R
= 6, "allcols", half-tile stages): masks and rule index must equal the
plain version's, aggregates lie within ``TOL`` and repeat bit for bit
(v1's aggregates and all of v3's outputs are not checked). All are timed
in turns (v0 .. vk vk .. v0, ``--turns`` times; CUDA events, median of
10 from an idle card, as ``chip_smoke.py`` times), with the scan and
reduce kernels' own device times from ``torch.profiler`` and the bound
from the same run.

Needs one H100. Prints the card, then one JSON line a variant (registers,
occupancy) and one a program set (checks, times); exits non-zero when a
variant fails to build or a checked output disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "policy_scan",
                    "csrc")
DESIGNS = os.path.join(ROOT, "tools", "policy_scan_designs.cu")
FIRST = "constexpr int VARIANT = 0;"
# variant -> (source: "csrc" or DESIGNS, [(old text, new text) edits of the
# .cu])
VARIANTS = {
    "current": ("csrc", []),
    "v0": (DESIGNS, []),
    "v1": (DESIGNS, [(FIRST, "constexpr int VARIANT = 1;")]),
    "v2": (DESIGNS, [(FIRST, "constexpr int VARIANT = 2;")]),
    "v3": (DESIGNS, [(FIRST, "constexpr int VARIANT = 3;")]),
}
UNCHECKED_AGG = ("v1", "v3")
UNCHECKED = ("v3",)
# appended to a source without policy_scan_occupancy (the first kernel's csrc/)
OCCUPANCY_OF_FIRST = r"""
extern "C" int policy_scan_occupancy(int n_progs, int n_instr) {
  using namespace policy_scan;
  const size_t smem = sizeof(float) * (3 * (size_t)n_progs * n_instr +
                                       WARPS * N_AGG +
                                       (size_t)n_progs * N_AGG);
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scan_kernel,
                                                    THREADS, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}
"""
FIRST_BLOCKS_PER_SM = 8        # the first kernel's grid: 8 blocks an SM
WIDE_RULES = ["last_access > 90d", "nlink == 2 or ost_idx == 3",
              "mode >= 256 and not (dirty == 1)", "group == 1 and pool != 2"]


def tool(name: str) -> str:
    """A CUDA binary utility: on PATH or in the toolkit."""
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)


def demangle(names):
    try:
        proc = subprocess.run([shutil.which("c++filt") or tool("cu++filt")],
                              input="\n".join(names), capture_output=True,
                              text=True, timeout=60)
        out = proc.stdout.splitlines()
        if proc.returncode == 0 and len(out) == len(names):
            return out
    except (OSError, subprocess.SubprocessError):
        pass
    return list(names)


def ptxas_info(stderr: str) -> dict:
    """kernel -> {registers, spill stores/loads, static shared bytes} from
    ``-Xptxas -v``."""
    out, cur = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_shared"] = int(m.group(1)) if m else 0
    names = list(out)
    return dict(zip(demangle(names), out.values()))


def sources(names, parents=()) -> dict:
    """variant -> {file name: text}, the edits applied."""
    def read(path):
        with open(path) as f:
            return f.read()
    out = {}
    for parent in parents:
        files = {f: read(os.path.join(parent, f))
                 for f in ("policy_scan.cu", "policy_scan.cuh")
                 if os.path.exists(os.path.join(parent, f))}
        out[os.path.basename(os.path.normpath(parent))] = files
    for name in names:
        src, edits = VARIANTS[name]
        if src == "csrc":
            files = {f: read(os.path.join(CSRC, f))
                     for f in ("policy_scan.cu", "policy_scan.cuh")}
        else:
            files = {"policy_scan.cu": read(src)}
        text = files["policy_scan.cu"]
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"scan_variants: variant {name!r}: {old!r} occurs "
                         f"{text.count(old)} times in the source")
            text = text.replace(old, new)
        files["policy_scan.cu"] = text
        out[name] = files
    for files in out.values():
        if "policy_scan_occupancy" not in files["policy_scan.cu"]:
            files["policy_scan.cu"] += OCCUPANCY_OF_FIRST
    return out


def build(name: str, files: dict, workdir: str) -> dict:
    """Compile one variant into a shared library with ``-Xptxas -v``;
    returns its path and the ptxas report."""
    from repro_torch.kernels._build import NVCC_FLAGS
    d = os.path.join(workdir, re.sub(r"\W", "_", name))
    os.makedirs(d, exist_ok=True)
    for f, text in files.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(d, "libpolicy_scan.so")
    proc = subprocess.run([tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           lib, os.path.join(d, "policy_scan.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return dict(lib=lib, ptxas=ptxas_info(proc.stderr))


class Variant:
    """One built library, launched as ``kernel.py`` launches its own: the
    redesign's grid (``policy_scan_grid``) or the first kernel's (8 blocks
    an SM); both take the first kernel's ``policy_scan_launch``
    arguments."""

    def __init__(self, name: str, lib_path: str):
        self.name = name
        lib = ctypes.CDLL(lib_path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.persistent = hasattr(lib, "policy_scan_grid")
        lib.policy_scan_launch.argtypes = [p, ll, i, p, p, p, i, i, i, i, i,
                                           p, p, p, p, i, p]
        lib.policy_scan_launch.restype = i
        lib.policy_scan_tile_rows.restype = i
        if self.persistent:
            lib.policy_scan_grid.argtypes = [ll, i]
            lib.policy_scan_grid.restype = i
        lib.policy_scan_occupancy.argtypes = [i, i]
        lib.policy_scan_occupancy.restype = i
        self.lib = lib

    def grid(self, n: int, sms: int) -> int:
        if self.persistent:
            return self.lib.policy_scan_grid(n, sms)
        tile = self.lib.policy_scan_tile_rows()
        return max(1, min(-(-n // tile), sms * FIRST_BLOCKS_PER_SM))

    def shape(self, n: int, sms: int, prog) -> dict:
        """Grid and resident blocks an SM of one launch."""
        r, p = prog[0].shape
        return dict(grid=self.grid(n, sms),
                    blocks_per_sm=self.lib.policy_scan_occupancy(r, p))

    def __call__(self, cols, ops, colidx, operands, with_rule, kw):
        import torch
        from repro_torch.kernels.policy_scan.ref import N_AGG
        dev = cols.device
        n_cols, n = cols.shape
        r, p = ops.shape
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = self.grid(n, sms)
        masks = torch.empty((r, n), dtype=torch.float32, device=dev)
        rule = (torch.empty((n,), dtype=torch.int32, device=dev)
                if with_rule else None)
        partials = torch.empty((grid, r, N_AGG), dtype=torch.float32,
                               device=dev)
        agg = torch.empty((r, N_AGG), dtype=torch.float32, device=dev)
        args = [cols.data_ptr(), n, n_cols, ops.data_ptr(), colidx.data_ptr(),
                operands.data_ptr(), r, p, kw["size_col"], kw["blocks_col"],
                kw["valid_col"], masks.data_ptr(),
                rule.data_ptr() if rule is not None else None,
                partials.data_ptr(), agg.data_ptr(), grid,
                torch.cuda.current_stream(dev).cuda_stream]
        err = self.lib.policy_scan_launch(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed ({err})")
        return masks, rule, agg


def program_sets(torch, cs, names, device):
    """name -> (prog tensors on the card, host arrays, with_rule)."""
    from repro_torch.core.catalog import StringTable
    from repro_torch.core.policy import compile_programs, parse_expr
    st = StringTable()
    for s in ("u0", "u1", "u2"):
        st.intern(s)
    host = compile_programs([parse_expr(e) for e in cs.BATCH_CRITERIA], st,
                            cs.NOW)
    out = {}
    if "wide" in names:              # R = 8: BATCH_CRITERIA and 4 more rules
        wide = compile_programs([parse_expr(e) for e in cs.BATCH_CRITERIA
                                 + WIDE_RULES], st, cs.NOW)
        out["wide"] = ([torch.from_numpy(a).to(device) for a in wide], wide,
                       True)
    if "allcols" in names:           # R = 6: and 2 rules reading every column
        every = compile_programs([parse_expr(e) for e in cs.BATCH_CRITERIA
                                  + cs.WIDE_CRITERIA], st, cs.NOW)
        out["allcols"] = ([torch.from_numpy(a).to(device) for a in every],
                          every, True)
    if "batch" in names:
        out["batch"] = ([torch.from_numpy(a).to(device) for a in host], host,
                        True)
    if "single" in names:
        one = tuple(a[:1] for a in host)
        out["single"] = ([torch.from_numpy(a).to(device) for a in one], one,
                         False)
    return out


def turns(variants, call, n_turns: int, reps: int, cs) -> dict:
    """variant -> CUDA-event medians, in turns v0 .. vk vk .. v0."""
    order = variants + variants[::-1]
    times = {v.name: [] for v in variants}
    for _ in range(n_turns):
        for v in order:
            times[v.name].append(cs.cuda_times_ms(lambda: call(v), reps)[0])
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="v0,v1,v2,v3",
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--parent", default="", help="older csrc/ directories "
                    "(comma-separated) to time "
                    "beside them")
    ap.add_argument("--programs", default="batch,single")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows (default chip_smoke.ROWS, 2^27)")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    from repro_torch.core.policy import KERNEL_COLUMNS
    from repro_torch.kernels.policy_scan import kernel as K
    from repro_torch.kernels.policy_scan import ref as R
    if not torch.cuda.is_available():
        sys.exit("scan_variants: needs a CUDA card")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = cs.CARD = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "ncu": shutil.which("ncu") is not None}), flush=True)

    names = [v for v in args.variants.split(",") if v]
    srcs = sources(names, [d for d in args.parent.split(",") if d])
    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            futs = {n: pool.submit(build, n, f, work)
                    for n, f in srcs.items()}
            built = {n: f.result() for n, f in futs.items()}
        variants = [Variant(n, b["lib"]) for n, b in built.items()]
        n = args.rows or cs.ROWS
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        cols = cs.make_columns(torch, n, args.seed, device)
        kw = dict(size_col=KERNEL_COLUMNS.index("size"),
                  blocks_col=KERNEL_COLUMNS.index("blocks"),
                  valid_col=len(KERNEL_COLUMNS))
        sets = program_sets(torch, cs, args.programs.split(","), device)
        for v in variants:
            shapes = {}
            for pname, (prog, host, _) in sets.items():
                shapes[pname] = v.shape(n, sms, prog)
            print(json.dumps({"variant": v.name,
                              "ptxas": built[v.name]["ptxas"],
                              "launch": shapes}), flush=True)
        failed = []
        for pname, (prog, host, with_rule) in sets.items():
            res = {"programs": pname, "rows": n, "checks": {}, "agg_err": {},
                   "launch": K.launch_shape(cols, prog[0], prog[1], **kw)}
            if with_rule:
                want = R.policy_scan_batch_ref(cols, *prog, **kw)
            else:
                m, a = R.policy_scan_ref(cols, *(x[0] for x in prog), **kw)
                want = (m[None], None, a[None])
            for v in variants:
                got = v(cols, *prog, with_rule, kw)
                again = v(cols, *prog, with_rule, kw)
                torch.cuda.synchronize()
                if v.name in UNCHECKED:
                    res["checks"][v.name] = "not checked"
                    continue
                ok = torch.equal(got[0], want[0]) and (
                    not with_rule or torch.equal(got[1], want[1]))
                if v.name not in UNCHECKED_AGG:
                    ok = ok and torch.allclose(got[2], want[2], **cs.TOL) \
                        and torch.equal(got[2], again[2])
                    res["agg_err"][v.name] = (got[2].double()
                                              - want[2].double()
                                              ).abs().max().item()
                res["checks"][v.name] = ok
                if not ok:
                    failed.append(f"{v.name} {pname}")
                del got, again
            del want
            torch.cuda.empty_cache()

            def call(v):
                return v(cols, *prog, with_rule, kw)
            times = turns(variants, call, args.turns, cs.REPS, cs)
            res["ms"] = times
            res["median_ms"] = {k: statistics.median(t)
                                for k, t in times.items()}
            res["device_ms"] = {}
            for v in variants:
                kern = cs.kernel_device_ms(torch, lambda: call(v), cs.REPS)
                res["device_ms"][v.name] = {
                    cs.short_kernel_name(k): ms for k, (ms, _) in
                    kern.items()}
            bms, by, nbytes, nops = cs.bound_ms(
                n, host[0], host[1], with_rule=with_rule, **kw)
            res.update(bound_ms=bms, bound_by=by, bytes=nbytes,
                       card=card)
            print(json.dumps(res), flush=True)
    if failed:
        sys.exit(f"scan_variants: disagreeing outputs: {failed}")


if __name__ == "__main__":
    main()
