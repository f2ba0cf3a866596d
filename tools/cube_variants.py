#!/usr/bin/env python3
"""Build variants of the ``profile_cube`` CUDA kernel, read what the
compiler made of them, and time them in turns on one card.

    python3 tools/cube_variants.py [--variants NAME,...] [--parent PATH]
        [--cells a,b,d,path] [--turns N] [--seed S]

A variant is ``csrc/profile_cube.cu`` as it stands ("current") or one of
the designs of ``tools/profile_cube_designs.cu`` named in ``VARIANTS`` (that
file with its constants edited), written to a temporary directory, so the
checkout is never changed; ``--parent PATH`` adds an
older source of the kernel (its C interface: a zeroed f64 scratch of
3 * B * 70 doubles, no ``profile_cube_work_bytes``). Every variant is built
with ``nvcc`` at once, one process each, with ``-Xptxas -v`` (registers,
spills and shared memory of each kernel), and ``cuobjdump -sass`` counts
the atomic instructions of each kernel; a probe of one atomic add of each
kind (shared and global; u32, u64, f32, f64) shows which of them the card
does natively. Then each cell's columns are generated once with
``chip_smoke.py``'s generators and seed: (a) 2^27 rows, 4,096 groups,
prebucketed; (b) 2^27 rows, 64 groups, raw; (d) cell (a) with Zipf gids;
``path`` the four shards of the reports phase's 2^20-entry catalog. Each
variant is held to the f64 plain version cast to f32, to itself run to run
and to the valid-row count, then all are timed in turns (v0 .. vk vk .. v0,
``--turns`` times; CUDA events, median of 10 from an idle card, as
``chip_smoke.py`` times), with each kernel's own device time from
``torch.profiler``, ``index_add_`` and the bound from the same run.

Needs one H100. Prints the card, then one JSON line for the probe, one a
variant (registers, SASS atomics) and one a cell (designs, checks, times);
exits non-zero when a variant fails to build or disagrees.
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

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "profile_cube",
                      "csrc", "profile_cube.cu")
DESIGNS = os.path.join(ROOT, "tools", "profile_cube_designs.cu")
GLOBAL = ("constexpr int LARGE = 2;", "constexpr int LARGE = 0;")
# variant -> (source, [(old text, new text) edits of it])
VARIANTS = {
    "current": (SOURCE, []),
    # rows partitioned by band of 138 groups, each band summed in shared
    # memory (4 passes)
    "banded": (DESIGNS, []),
    # the global design with a row's three adds issued by its own thread
    "thread adds": (DESIGNS, [GLOBAL, ("constexpr bool LANE_ADDS = true;",
                                       "constexpr bool LANE_ADDS = false;")]),
    # the global design with groups 0-67 summed per block in shared memory
    # (2 blocks of 114,240 B an SM)
    "hot band": (DESIGNS, [GLOBAL, ("constexpr int HOT_GROUPS = 0;",
                                    "constexpr int HOT_GROUPS = 68;")]),
    # the same over groups 0-137 (1 block of 1,024 threads and 231,840 B an
    # SM)
    "hot wide": (DESIGNS, [GLOBAL, ("constexpr int HOT_GROUPS = 0;",
                                    "constexpr int HOT_GROUPS = BAND_GROUPS;"),
                           ("constexpr int GLOBAL_THREADS = 512;",
                            "constexpr int GLOBAL_THREADS = 1024;")]),
}
ATOMIC_OPS = ("ATOM", "ATOMS", "ATOMG", "RED", "REDG", "REDAS", "REDUX")
PROBE_CU = r"""
template <typename T>
__global__ void shared_add(const unsigned* idx, const T* v, T* out) {
  __shared__ T s[1024];
  s[threadIdx.x] = T(0);
  __syncthreads();
  atomicAdd(&s[idx[threadIdx.x] & 1023], v[threadIdx.x]);
  __syncthreads();
  out[threadIdx.x] = s[threadIdx.x];
}
template <typename T>
__global__ void global_add(const unsigned* idx, const T* v, T* out) {
  atomicAdd(&out[idx[threadIdx.x]], v[threadIdx.x]);
}
template __global__ void shared_add<unsigned>(const unsigned*,
    const unsigned*, unsigned*);
template __global__ void shared_add<unsigned long long>(const unsigned*,
    const unsigned long long*, unsigned long long*);
template __global__ void shared_add<float>(const unsigned*, const float*,
    float*);
template __global__ void shared_add<double>(const unsigned*, const double*,
    double*);
template __global__ void global_add<unsigned>(const unsigned*,
    const unsigned*, unsigned*);
template __global__ void global_add<unsigned long long>(const unsigned*,
    const unsigned long long*, unsigned long long*);
template __global__ void global_add<float>(const unsigned*, const float*,
    float*);
template __global__ void global_add<double>(const unsigned*, const double*,
    double*);
"""


def tool(name: str) -> str:
    """A CUDA binary utility: on PATH, in the toolkit, or in Triton's."""
    found = shutil.which(name)
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if os.path.exists(os.path.join(cuda, "bin", name)):
        return os.path.join(cuda, "bin", name)
    import triton
    return os.path.join(os.path.dirname(triton.__file__), "backends",
                        "nvidia", "bin", name)


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
    """kernel -> {registers, spill stores/loads, shared bytes} from
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


def sass_atomics(binary: str) -> dict:
    """kernel -> {atomic instruction with its modifiers: count} from
    ``cuobjdump -sass``."""
    proc = subprocess.run([tool("cuobjdump"), "-sass", binary],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-500:]}
    out, cur = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if cur is None or not m:
            continue
        op = m.group(1)
        if op.split(".")[0] in ATOMIC_OPS or "CAS" in op:
            out[cur][op] = out[cur].get(op, 0) + 1
    names = list(out)
    return dict(zip(demangle(names), out.values()))


def build(name: str, text: str, workdir: str) -> dict:
    """Compile one variant's source into a shared library with
    ``-Xptxas -v``; returns its path, the ptxas report and the SASS
    atomics."""
    from repro_torch.kernels._build import NVCC_FLAGS
    d = os.path.join(workdir, name.replace(" ", "_"))
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "profile_cube.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(d, "libprofile_cube.so")
    proc = subprocess.run([tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return dict(lib=lib, ptxas=ptxas_info(proc.stderr),
                sass=sass_atomics(lib))


def probe(workdir: str) -> dict:
    """The SASS of one atomic add of each kind."""
    src = os.path.join(workdir, "probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_CU)
    cubin = os.path.join(workdir, "probe.cubin")
    proc = subprocess.run([tool("nvcc"), "-cubin", "-gencode",
                           "arch=compute_90a,code=sm_90a", "-O3", "-o",
                           cubin, src], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr[-500:]}
    return sass_atomics(cubin)


class Variant:
    """One built library, launched as ``kernel.profile_cube_cuda`` does."""

    def __init__(self, name: str, lib_path: str):
        self.name = name
        lib = ctypes.CDLL(lib_path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.profile_cube_launch.argtypes = [p, ll, i, i, i, i, i, i, i, i,
                                            p, p, i, p]
        lib.profile_cube_launch.restype = i
        lib.profile_cube_design.argtypes = [i]
        lib.profile_cube_design.restype = i
        self.legacy = not hasattr(lib, "profile_cube_work_bytes")
        if not self.legacy:
            lib.profile_cube_work_bytes.argtypes = [ll, i]
            lib.profile_cube_work_bytes.restype = ll
        self.lib = lib

    def design(self, n_groups: int) -> str:
        code = self.lib.profile_cube_design(n_groups)
        names = (("global", "shared") if self.legacy
                 else ("global", "shared", "banded"))
        return names[code] if 0 <= code < len(names) else f"error {code}"

    def __call__(self, cols, n_groups, gid_col, size_col, blocks_col,
                 age_col, valid_col, sb_col, ab_col):
        import torch
        n = cols.shape[1]
        dev = cols.device
        if self.legacy:
            work = torch.zeros((3 * n_groups * 70,), dtype=torch.float64,
                               device=dev)
        else:
            work = torch.empty(
                (self.lib.profile_cube_work_bytes(n, n_groups),),
                dtype=torch.uint8, device=dev)
        out = torch.empty((3, n_groups, 10, 7), dtype=torch.float32,
                          device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        err = self.lib.profile_cube_launch(
            cols.data_ptr(), n, n_groups, gid_col, size_col, blocks_col,
            age_col if ab_col < 0 else -1, valid_col, sb_col, ab_col,
            work.data_ptr(), out.data_ptr(), sms,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed ({err})")
        return out


def cells(torch, cs, names, seed: int, device) -> dict:
    """cell -> list of (cols, kw, prebucketed) (one entry; four for the
    path's shards), as ``chip_smoke.py`` makes them."""
    out = {}
    if {"a", "b", "d"} & set(names):
        a = cs.cube_columns(torch, cs.ROWS, cs.CUBE_GROUPS, seed + 1, device)
        pre = dict(cs.PREBUCKETED, n_groups=cs.CUBE_GROUPS)
        if "a" in names:
            out["a"] = [(a, pre, True)]
        if "b" in names:
            out["b"] = [(cs.raw_layout(torch, a, cs.CUBE_GROUPS_SMALL),
                         dict(cs.RAW, n_groups=cs.CUBE_GROUPS_SMALL), False)]
        if "d" in names:
            d = a.clone() if "a" in names else a
            d[0] = cs.zipf_gid(torch, cs.ROWS, cs.CUBE_GROUPS, seed + 4,
                               device)
            out["d"] = [(d, pre, True)]
    if "path" in names:
        from repro_torch.core import ProfileCube
        cat = cs.build_catalog(cs.ENTRIES, seed)
        cube = ProfileCube(cat, clock=lambda: cs.NOW, use_kernel=False,
                           device="cpu")
        cube.rebuild()
        shards = cs.path_cube_columns(torch, cat, cube.groups, device)
        kw = dict(cs.PREBUCKETED, n_groups=len(cube.groups))
        out["path"] = [(c, kw, True) for c in shards]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current",
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--parent", help="an older profile_cube.cu to time "
                    "beside them")
    ap.add_argument("--cells", default="a,b,d,path")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("cube_variants: needs a CUDA card")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = cs.CARD = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    sources = {}
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    for name in args.variants.split(","):
        path, edits = VARIANTS[name]
        with open(path) as f:
            edited = f.read()
        for old, new in edits:
            if edited.count(old) != 1:
                sys.exit(f"cube_variants: variant {name!r}: {old!r} occurs "
                         f"{edited.count(old)} times in the source")
            edited = edited.replace(old, new)
        sources[name] = edited

    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(max_workers=len(sources) + 1) as pool:
            futs = {n: pool.submit(build, n, t, work)
                    for n, t in sources.items()}
            probe_fut = pool.submit(probe, work)
            built = {n: f.result() for n, f in futs.items()}
            print(json.dumps({"probe": probe_fut.result()}), flush=True)
        for n, b in built.items():
            print(json.dumps({"variant": n, "ptxas": b["ptxas"],
                              "sass": b["sass"]}), flush=True)
        variants = [Variant(n, b["lib"]) for n, b in built.items()]

        names = args.cells.split(",")
        data = cells(torch, cs, names, args.seed, device)
        torch.cuda.synchronize()
        for cell in names:
            parts = data.pop(cell)
            res = {"designs": {}, "checks": {}}
            for v in variants:
                res["designs"][v.name] = v.design(parts[0][1]["n_groups"])
            for si, (cols, kw, _) in enumerate(parts):
                from repro_torch.kernels.profile_cube import ref as PR
                want = PR.profile_cube_ref(cols.double(), **kw).float()
                n_valid = int((cols[kw["valid_col"]] != 0).sum().item())
                for v in variants:
                    got, again = v(cols, **kw), v(cols, **kw)
                    torch.cuda.synchronize()
                    ok = (torch.equal(got, want) and torch.equal(got, again)
                          and int(got[0].double().sum().item()) == n_valid)
                    res["checks"][f"{v.name} {si}"] = ok
                    if not ok:
                        print(json.dumps(res), flush=True)
                        sys.exit(f"cube_variants: {v.name} disagrees on "
                                 f"cell {cell} part {si}")
                del want
            order = variants + variants[::-1]
            times = {v.name: [] for v in variants}
            for _ in range(args.turns):
                for v in order:
                    t = 0.0
                    for cols, kw, _ in parts:
                        t += cs.cuda_times_ms(lambda: v(cols, **kw),
                                              cs.REPS)[0]
                    times[v.name].append(t)
            res["ms"] = times
            res["median_ms"] = {n: statistics.median(t)
                                for n, t in times.items()}
            res["device_ms"] = {}
            for v in variants:
                dev: dict = {}
                for cols, kw, _ in parts:
                    for k, ms in cs.cube_device_ms(
                            torch, lambda: v(cols, **kw)).items():
                        dev[k] = dev.get(k, 0.0) + ms
                res["device_ms"][v.name] = dev
            res["library_ms"] = sum(cs.cube_library_ms(torch, c, kw[
                "n_groups"], pre) for c, kw, pre in parts)
            res["bound_ms"] = sum(cs.cube_bound_ms(torch, c, kw["n_groups"],
                                                   pre)[0]
                                  for c, kw, pre in parts)
            res["rows"] = sum(c.shape[1] for c, _, _ in parts)
            res["groups"] = parts[0][1]["n_groups"]
            print(json.dumps({"cell": cell, **res}), flush=True)
            del parts
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
