#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed S]

Phases, each of which ends the run with a non-zero exit at its first
failure:

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions;
2. build: the ``policy_scan``, ``profile_cube``, ``paged_attention``,
   ``rglru_scan`` and ``rwkv6_step`` libraries from their ``csrc/``, and
   the first ``policy_scan`` design (``v0`` of
   ``tools/policy_scan_designs.cu``), one ``nvcc`` each, started together,
   with each build time;
3. kernels at device scale: 2^27 rows of the 16 kernel columns plus a
   validity row, generated on the card from a seed with f32-exact values;
   ``policy_scan_batch`` and ``policy_scan`` are held to their plain
   PyTorch versions (masks and rule indices identical, aggregates within
   ``rtol=1e-5, atol=1``: f32 sums of more than 2^24 units round in any
   order), must repeat bit for bit on a second call, and the single
   program's aggregates must equal the batch's program 0 bit for bit;
   each is timed with CUDA events (median after a warm-up) beside the
   least time the card could take, its scan and reduce kernels' own
   device times (``torch.profiler``), its grid and ring stages, and the
   first design in turns (first, this, this, first; an older ``csrc/`` is
   compared with ``tools/scan_variants.py --parent``); then a batch of
   ``BATCH_CRITERIA`` and ``WIDE_CRITERIA`` (programs that read all 16
   kernel columns, so the kernel stages half tiles) is held to the plain
   version the same way and timed;
4. profile cube at device scale, columns generated on the card from a
   seed: (a) 2^27 rows, 4096 groups, the prebucketed layout
   ``ProfileCube`` passes; (b) 2^27 rows, 64 groups, the raw layout
   (bucketized on the card); (c) 2^20 rows, 64 groups, every per-cell
   sum below 2^24; (d) cell (a) with Zipf-skewed group ids. Counts must
   equal the plain version's and sum to the valid rows; volume and
   spc_used must equal the plain version run on f64 columns and cast to
   f32 (in (c) also the f32 plain version itself); (a), (b) and (d) must
   repeat bit for bit; the edge shapes (no rows, no groups, a ragged N,
   too many groups) must behave as the op says. (a), (b) and (d) are
   timed beside the bound, the plain version and one ``index_add_``
   (which excludes the bucketizing), with the kernels' own device times
   from a ``torch.profiler`` trace;
5. engine: a 2^20-entry catalog, one policy (scope, two rules, LRU sort,
   a recording batch action) run through ``PolicyEngine.run`` with
   ``evaluator="policy_scan"`` on the card and with ``evaluator="numpy"``:
   the actioned (fid, rule params) sequences must be identical, with and
   without budgets, and the run must have launched the batch kernel once;
   the batch kernel is held to its plain version on the policy's programs
   and this catalog's column stack; then ``scan_catalog`` must launch the
   single-program kernel once and ``match_programs(single_launch=False)``
   once per program, each path counted on its own, and both must agree
   with the batch path;
6. reports on the same catalog: ``ProfileCube(use_kernel=True).attach()``
   on the card must launch ``profile_cube`` once per shard (4) and give
   the cube of the exact int64 host groupby (counts equal, volume and
   spc_used within ``rtol=1e-5``), and ``Reports`` over the two cubes must
   answer every ``rbh-report`` query alike; the kernel is held to its
   plain version on each shard's columns; after a few thousand changed
   entries go through the catalog's delta hooks, the kernel-built cube's
   counts must equal a fresh host rebuild's;
7. paged attention at device scale (after the cube phase): 64 sequences
   with lengths uniform in [1, 8192] (one of length 0, one with a -1 hole
   in its table, one a multiple of the 64-token page), tables drawn from a
   seeded permutation of an 8192-page pool, in four configurations:
   chatglm3-6b's widths (32 query heads, 2 KV heads, head_dim 128) in f32
   and in bf16, deepseek-coder-33b's (56, 8) and codeqwen1.5-7b's (32, 32)
   in f32; then one sequence of 8192 tokens (B = 1) at chatglm3-6b's
   widths in f32 and bf16. The op (split kernel, and the combine when a
   table is wider than one split; f32 on CUDA cores, bf16 on tensor cores)
   is held to its plain version (f32 ``rtol=1e-4`` with atol
   ``1e-4 * max|v|``; bf16 ``5e-2``; and each output row's relative L2
   error within 1e-4 in f32, 1e-2 in bf16) and must repeat bit for bit; in
   the batch the empty sequence must give exact zeros, and the hole
   sequence must equal, bit for bit, the op over the same table with the
   hole taken out and the op over that sequence alone. Each is timed from
   an idle card with the L2 cache flushed before each call, beside its
   bound, the plain version and one ``scaled_dot_product_attention`` over
   K/V gathered beforehand; the split kernel's and the combine's own
   device times come from a ``torch.profiler`` trace of the call, and the
   grid (blocks, splits, live blocks, waves) is reported;
8. recurrent kernels at device scale (after the attention phase), seeded
   inputs drawn on the card with the models' decay distributions:
   ``rglru_scan`` at recurrentgemma-9b's width (B 8, S 4096, R 4096, f32,
   1.6 GB) and at S 1, S 2016 and R 100, each with and without ``h0``,
   within ``rtol=1e-5, atol=1e-6`` of its plain version; ``rwkv6_step`` at
   rwkv6-1.6b's heads (B 256, H 32, hd 64: a 134 MB state), at hd 16 and
   at B 1, y within rtol 1e-5 and atol 1e-5 sum_i |r_i| (|S_ij| +
   |u_i k_i v_j|), the state within ``rtol=atol=1e-6``; both must repeat
   bit for bit and are timed beside their bound and plain version (no
   single PyTorch call computes either), and at the serving paths' decode
   shapes beside the kernels' own device times and the time of a call
   launched from a CUDA graph (a graph of 64 calls, replayed from an idle
   card, over 64);
9. paged serving: ``ServingEngine`` at chatglm3-6b's full width and depth
   (28 layers, weights drawn on the card from the seed), 4 requests of 256
   seeded prompt tokens and 32 new tokens over a 16-page hot pool a layer,
   so the watermark releases and restores pages in every layer. Each run
   must launch ``paged_attention`` 28 * 4 * (256 + 31) = 32,144 times and
   nothing else, with no combine (the tables are one split wide); a
   checker around the op the engine calls holds the
   kernel to its plain version on the run's own tensors (the first call of
   every layer, every call right after a restore, every 29th call) within
   bounds that follow the f32 error of the scores, which grow with depth
   (see ``attn_agrees``); a
   second run with the same seed must give the same tokens, and is timed
   with the host seconds of each cache and op call kind;
10. recurrent-model serving (last), one model after the other, each at
    full width and depth with parameters drawn on the card from the seed,
    through ``make_prefill`` and a decode step: rwkv6-1.6b, 8 prompts of
    512 seeded tokens and 64 new (exactly 24 x 63 = 1,512 ``rwkv6_step``
    launches: prefill runs the plain chunked form), and recurrentgemma-9b,
    4 prompts of 2016 tokens and 64 new with ``cache_len`` 2080, so the
    2048-slot local-attention ring wraps (exactly 26 x 64 = 1,664
    ``rglru_scan`` launches: prefill and every step). Run (a) decodes
    eagerly (``model.decode_step`` and the argmax) with a checker around
    the op that holds the kernel to its plain version on the first call of
    every layer and every 29th call; its logits must lie within the
    reference's decode-consistency bound ``0.05 * scale + 0.05`` of one
    forward over prompt and generated tokens (beside the same forward for
    one prompt alone, the rounding floor). Run (b), with the same seed,
    decodes through ``make_serve_step``, one CUDA graph a step over a
    static cache, captured before the launch window: it must give (a)'s
    tokens, the same launch count and logits within the same bound, and
    whether its final caches equal (a)'s bit for bit is printed. (b) is
    timed (prefill seconds, decode ms a step, tokens/s, each kernel's
    device time against reading the weights once), then 8 eager steps are
    timed, and four graphed and four eager decode steps run under
    ``torch.profiler`` for the card's busy share and device operations a
    step, eager and graphed side by side.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or without
the repository beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
F64_OPS_PER_S = 34e12           # H100 SXM f64 outside the tensor cores
NOW = 16_000_000.0              # f32-exact "now" for every phase
CARD = ""                       # nvidia-smi's name and power limit
TOL = dict(rtol=1e-5, atol=1.0)
ROWS = 1 << 27                  # kernel phase: rows on the card
ENTRIES = 1 << 20               # engine phase: catalog entries
REPS = 10                       # timed calls per kernel and plain version
L2_FLUSH_BYTES = 256 << 20      # written before each timed attention call
CUBE_GROUPS = 4096              # cell (a): profile_cube's MAX_GROUPS
CUBE_GROUPS_SMALL = 64          # cells (b) and (c)
# cell (d): cell (a) with gid drawn from p_g ~ (g + 1)^-CUBE_ZIPF_S over
# CUBE_GROUPS groups. The exponent is a choice: it puts about 16% of rows
# in group 0 and 70% in groups 0-127, as a catalog where a few accounts
# own most entries gives ProfileCube's dense group codes (frequent groups
# get low ids).
CUBE_ZIPF_S = 1.1
EXACT_ROWS = 1 << 20            # cell (c)
F32_EXACT = 1 << 24             # f32 holds every integer below this
BATCH_CRITERIA = ["(size > 1GB or owner == 'u1') and type == file",
                  "size > 1GB", "owner == 'u1'",
                  "not (type == file and size <= 32M)"]
# rules that read every kernel column between them and each
WIDE_CRITERIA = [
    "(size > 1GB or blocks < 4096) and (nlink == 2 or ost_idx == 3 or "
    "archive_id == 1) or (mode >= 256 and dirty == 1) or last_access > 90d "
    "or last_mod > 30d or creation > 1d or type == file or "
    "hsm_state == archived or owner == 'u1' or group == 'u2' or "
    "pool == 'u0' or status == 'u1'",
    "size <= 32M and blocks >= 8 and nlink != 1 and ost_idx < 5 and "
    "archive_id != 2 and mode < 448 and dirty == 0 and "
    "not (last_access > 10d and last_mod > 20d and creation > 30d) and "
    "type == file and hsm_state != released and owner != 'u0' and "
    "(group == 'u1' or pool == 'u2' or status != 'u0')"]
TPU_KERNELS = {
    "policy_scan_batch": "src/repro/kernels/policy_scan/kernel.py:237",
    "policy_scan": "src/repro/kernels/policy_scan/kernel.py:131",
    "profile_cube": "src/repro/kernels/profile_cube/kernel.py:88",
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:75",
    "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:43",
    "rwkv6_step": "src/repro/kernels/rwkv6_step/kernel.py:35",
}
KERNEL_SOURCE = "src/repro_torch/kernels/policy_scan/csrc/policy_scan.cu"
CUBE_SOURCE = "src/repro_torch/kernels/profile_cube/csrc/profile_cube.cu"
ATTN_SOURCE = ("src/repro_torch/kernels/paged_attention/csrc/"
               "paged_attention.cu")
ATTN_SEQS = 64                  # attention phase: sequences
ATTN_CONTEXT = 8192             # chatglm3-6b's context length
ATTN_PAGE = 64                  # tokens a page
ATTN_MAX_PAGES = ATTN_CONTEXT // ATTN_PAGE
ATTN_POOL = ATTN_SEQS * ATTN_MAX_PAGES     # pages in the pool
# name, query heads, KV heads, head_dim, dtype (widths from
# src/repro/configs/{chatglm3_6b,deepseek_coder_33b,codeqwen1p5_7b}.py)
ATTN_CONFIGS = (("chatglm3-6b f32", 32, 2, 128, "float32"),
                ("chatglm3-6b bf16", 32, 2, 128, "bfloat16"),
                ("deepseek-coder-33b f32", 56, 8, 128, "float32"),
                ("codeqwen1.5-7b f32", 32, 32, 128, "float32"))
# the long-context decode case: one sequence of ATTN_CONTEXT tokens
ATTN_LONG = (("chatglm3-6b f32 B=1", 32, 2, 128, "float32"),
             ("chatglm3-6b bf16 B=1", 32, 2, 128, "bfloat16"))
# serving phase: chatglm3-6b (src/repro/configs/chatglm3_6b.py) at full
# width and depth, a 16-page hot pool a layer
SERVE_MODEL = dict(vocab=65024, d_model=4096, n_layers=28, n_heads=32,
                   n_kv=2, head_dim=128, d_ff=13696)
SERVE_POOL = dict(page_size=64, n_pages=16, high_wm=80.0, low_wm=50.0)
SERVE_REQUESTS = 4
SERVE_PROMPT = 256
SERVE_NEW = 32
SERVE_CHECK_EVERY = 29          # the checker's sampling stride
RG_SOURCE = "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"
RW_SOURCE = "src/repro_torch/kernels/rwkv6_step/csrc/rwkv6_step.cu"
RG_TOL = dict(rtol=1e-5, atol=1e-6)
# recurrent kernels: rglru_scan (B, S, R) at recurrentgemma-9b's d_rnn and
# the ragged shapes (a decode step, its prefill length, an odd width);
# rwkv6_step (B, H, hd) at rwkv6-1.6b's heads, hd 16 and B = 1
RG_SHAPE = (8, 4096, 4096)
RG_RAGGED = ((8, 1, 4096), (4, 2016, 4096), (8, 4096, 100))
RW_SHAPE = (256, 32, 64)
RW_RAGGED = ((256, 32, 16), (1, 32, 64))
# the serving paths' shapes: a recurrentgemma-9b decode step (4 prompts)
# and an rwkv6-1.6b one (8 prompts)
RG_PATH = (4, 1, 4096)
RW_PATH = (8, 32, 64)
# recurrent serving (src/repro/configs/): arch, prompts, prompt tokens, new
# tokens, cache_len (recurrentgemma-9b's 2048-slot ring wraps in decode)
RECURRENT_SERVE = (("rwkv6_1p6b", 8, 512, 64, 576),
                   ("recurrentgemma_9b", 4, 2016, 64, 2080))
PROFILED_STEPS = 4              # decode steps under the profiler
EAGER_STEPS = 8                 # eager decode steps timed after run (b)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_times_ms(fn, reps: int, warmup: int = 2, flush=None):
    """Median and all per-call times (ms) of ``fn()`` by CUDA events, each
    from an idle card, so the host's work to launch ``fn``'s kernels is
    included. With ``flush`` (a tensor larger than the L2 cache) it is
    zeroed, and the card drained, before each call, so ``fn`` reads its
    inputs from device memory."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def device_rows(prof) -> list:
    """(name, device microseconds, count) of every CUDA operation in a
    ``torch.profiler`` profile, the largest first."""
    from torch.autograd import DeviceType
    rows = [(e.key, getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0), e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return rows


def kernel_device_ms(torch, fn, reps: int, flush=None) -> dict:
    """The card's own time of each kernel ``fn()`` launches, by name from a
    ``torch.profiler`` trace of ``reps`` calls, each waited for (after a
    warm-up call; with ``flush`` zeroed before each call, as in
    :func:`cuda_times_ms`): kernel name -> (mean device ms a launch,
    launches a call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
            torch.cuda.synchronize()
    return {k: (us / count / 1e3, count / reps)
            for k, us, count in device_rows(prof) if count}


def one_kernel_ms(kern: dict, part: str, what: str) -> float:
    """The device ms of the one kernel in ``kern`` whose name holds
    ``part``; it must have launched once a call."""
    hits = [v for k, v in kern.items() if part in k]
    check(len(hits) == 1 and hits[0][1] == 1, f"{what}: the profile shows "
          f"{len(hits)} kernels named *{part}* ({hits}), not one launched "
          f"once a call, among {sorted(kern)}")
    return hits[0][0]


def bound_ms(n: int, ops, colidx, size_col: int, blocks_col: int,
             valid_col: int, with_rule: bool):
    """Least time for one scan: each input read once, each output written
    once, over the memory rate; or the f32 work over its peak rate."""
    live = ops >= 0
    is_cmp = live & (ops < 6)
    read_cols = set(colidx[is_cmp].tolist()) | {size_col, blocks_col,
                                                valid_col}
    n_progs = ops.shape[0]
    bytes_moved = 4 * n * (len(read_cols) + n_progs + (1 if with_rule
                                                        else 0))
    # per row and program: its live instructions, 2 multiplies and 14
    # additions / maxima for the aggregates
    operations = n * (int(live.sum()) + 16 * n_progs)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = operations / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", bytes_moved, operations)


def make_columns(torch, n: int, seed: int, device):
    """(17, n) f32 on the card: the 16 KERNEL_COLUMNS plus validity, every
    value exact in f32 (sizes/blocks multiples of 4 KiB below 2^36, times
    integers below 2^24)."""
    from repro_torch.core.policy import KERNEL_COLUMNS
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ranges = {"size": (0, 1 << 24, 4096), "blocks": (0, 1 << 24, 4096),
              "nlink": (1, 4, 1), "ost_idx": (0, 16, 1),
              "archive_id": (0, 4, 1), "mode": (0, 512, 1),
              "dirty": (0, 2, 1), "atime": (0, 1 << 24, 1),
              "mtime": (0, 1 << 24, 1), "ctime": (0, 1 << 24, 1),
              "type": (0, 2, 1), "hsm_state": (0, 7, 1),
              "owner": (0, 8, 1), "group": (0, 4, 1), "pool": (0, 3, 1),
              "status": (0, 3, 1)}
    cols = torch.empty((len(KERNEL_COLUMNS) + 1, n), dtype=torch.float32,
                       device=device)
    for i, name in enumerate(KERNEL_COLUMNS):
        lo, hi, unit = ranges[name]
        cols[i] = torch.randint(lo, hi, (n,), generator=g, device=device)
        if unit != 1:
            cols[i] *= unit
    cols[-1] = torch.randint(0, 64, (n,), generator=g, device=device) > 0
    return cols


def scan_variants():
    """``tools/scan_variants.py`` as a module."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import scan_variants as sv
    return sv


def build_first_scan():
    """The first ``policy_scan`` design (``v0`` of
    ``tools/policy_scan_designs.cu``), built under ``build/``."""
    sv = scan_variants()
    built = sv.build("first", sv.sources(["v0"])["v0"],
                     os.path.join(ROOT, "build", "scan_variants"))
    return sv.Variant("first", built["lib"]), built["ptxas"]


def kernel_phase(torch, seed, device, results, first=None):
    from repro_torch.core.catalog import StringTable
    from repro_torch.core.policy import (KERNEL_COLUMNS, compile_programs,
                                         parse_expr)
    from repro_torch.kernels.policy_scan import kernel as K
    from repro_torch.kernels.policy_scan import ref as R
    n = ROWS
    t0 = time.perf_counter()
    cols = make_columns(torch, n, seed, device)
    torch.cuda.synchronize()
    log(f"[kernels] columns {tuple(cols.shape)} f32 = "
        f"{cols.numel() * 4 / 1e9:.2f} GB generated in "
        f"{time.perf_counter() - t0:.2f} s")
    st = StringTable()
    for s in ("u0", "u1", "u2"):
        st.intern(s)
    ops, colidx, operands = compile_programs(
        [parse_expr(e) for e in BATCH_CRITERIA], st, NOW)
    prog = [torch.from_numpy(a).to(device) for a in (ops, colidx, operands)]
    kw = dict(size_col=KERNEL_COLUMNS.index("size"),
              blocks_col=KERNEL_COLUMNS.index("blocks"),
              valid_col=len(KERNEL_COLUMNS))

    # policy_scan_batch against its plain version
    masks_k, rule_k, agg_k = K.policy_scan_batch_cuda(cols, *prog, **kw)
    torch.cuda.synchronize()
    masks_r, rule_r, agg_r = R.policy_scan_batch_ref(cols, *prog, **kw)
    torch.cuda.synchronize()
    check(torch.equal(masks_k, masks_r), "policy_scan_batch masks differ "
          "from the plain version")
    check(torch.equal(rule_k, rule_r), "policy_scan_batch rule index "
          "differs from the plain version")
    check(torch.allclose(agg_k, agg_r, **TOL),
          f"policy_scan_batch aggregates differ:\n{agg_k}\n{agg_r}")
    batch_err = (agg_k.double() - agg_r.double()).abs().max().item()
    batch_rel = ((agg_k.double() - agg_r.double()).abs()
                 / agg_r.double().abs().clamp_min(1)).max().item()
    log(f"[kernels] policy_scan_batch R={ops.shape[0]} N={n}: masks and "
        f"rule identical; agg max abs err {batch_err!r}, max rel err "
        f"{batch_rel!r}; matched per program "
        f"{agg_k[:, 0].tolist()}")
    del masks_r, rule_r
    again = K.policy_scan_batch_cuda(cols, *prog, **kw)
    torch.cuda.synchronize()
    check(torch.equal(again[2], agg_k), "policy_scan_batch aggregates "
          "differ between two calls")
    check(torch.equal(again[0], masks_k) and torch.equal(again[1], rule_k),
          "policy_scan_batch masks or rule differ between two calls")
    del again

    # policy_scan (program 0) against its plain version and the batch row
    m1_k, a1_k = K.policy_scan_cuda(cols, *(p[0] for p in prog), **kw)
    torch.cuda.synchronize()
    m1_r, a1_r = R.policy_scan_ref(cols, *(p[0] for p in prog), **kw)
    torch.cuda.synchronize()
    check(torch.equal(m1_k, m1_r), "policy_scan mask differs from the "
          "plain version")
    check(torch.equal(m1_k, masks_k[0]), "policy_scan mask differs from "
          "the batch kernel's program 0")
    check(torch.allclose(a1_k, a1_r, **TOL),
          f"policy_scan aggregates differ:\n{a1_k}\n{a1_r}")
    single_err = (a1_k.double() - a1_r.double()).abs().max().item()
    single_rel = ((a1_k.double() - a1_r.double()).abs()
                  / a1_r.double().abs().clamp_min(1)).max().item()
    log(f"[kernels] policy_scan N={n}: mask identical; agg max abs err "
        f"{single_err!r}, max rel err {single_rel!r}")
    again = K.policy_scan_cuda(cols, *(p[0] for p in prog), **kw)
    torch.cuda.synchronize()
    check(torch.equal(again[1], a1_k) and torch.equal(again[0], m1_k),
          "policy_scan outputs differ between two calls")
    check(torch.equal(a1_k, agg_k[0]), "policy_scan aggregates differ from "
          "the batch kernel's program 0")
    del again
    del m1_r, masks_k, rule_k, m1_k

    # times: CUDA events, median of REPS after a warm-up
    p0 = [p[0] for p in prog]
    timings = {
        "policy_scan_batch": (
            cuda_times_ms(lambda: K.policy_scan_batch_cuda(cols, *prog, **kw),
                          REPS),
            cuda_times_ms(lambda: R.policy_scan_batch_ref(cols, *prog, **kw),
                          REPS),
            bound_ms(n, ops, colidx, with_rule=True, **kw), batch_err,
            batch_rel),
        "policy_scan": (
            cuda_times_ms(lambda: K.policy_scan_cuda(cols, *p0, **kw),
                          REPS),
            cuda_times_ms(lambda: R.policy_scan_ref(cols, *p0, **kw),
                          REPS),
            bound_ms(n, ops[:1], colidx[:1], with_rule=False, **kw),
            single_err, single_rel),
    }
    calls = {"policy_scan_batch": (
                 lambda: K.policy_scan_batch_cuda(cols, *prog, **kw),
                 prog, True),
             "policy_scan": (lambda: K.policy_scan_cuda(cols, *p0, **kw),
                             [p[None] for p in p0], False)}
    for name, ((ms, times), (plain_ms, _), (bms, by, nbytes, nops), err,
               rel) in timings.items():
        call, pr, with_rule = calls[name]
        shape = K.launch_shape(cols, pr[0], pr[1], **kw)
        ring = shape["passes"][0]
        kern = kernel_device_ms(torch, call, REPS)
        dev_ms = {"scan": one_kernel_ms(kern, "scan_kernel", name),
                  "reduce": one_kernel_ms(kern, "reduce_kernel", name)}
        log(f"[kernels] {name}: {ms!r} ms (median of {len(times)}, min "
            f"{min(times)!r}, max {max(times)!r}); plain {plain_ms!r} ms; "
            f"bound {bms!r} ms by {by} ({nbytes} B, {nops} f32 ops); "
            f"{bms / ms:.3f} of the bound; kernel_device_ms {dev_ms}; "
            f"launch {json.dumps(shape)}")
        results[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNELS[name], "launches": None,
            "max_abs_err": err, "max_rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "rows": n, "programs": int(
                ops.shape[0] if name == "policy_scan_batch" else 1),
            "device_ms": dev_ms, "grid": shape["grid"],
            "stages": ring["stages"], "stage_rows": ring["stage_rows"]}
        if first is not None:
            # the first design beside this one in turns on this card:
            # first, this, this, first (CUDA events, medians of REPS)
            first_call = (lambda: first(cols, *pr, with_rule, kw))
            turns = {"first": [], "this": []}
            for who in ("first", "this", "this", "first"):
                turns[who].append(cuda_times_ms(
                    first_call if who == "first" else call, REPS)[0])
            log(f"[kernels] {name} in turns (ms, first design/this): "
                f"{json.dumps(turns)}")
            results[name]["first_design_ms"] = statistics.median(
                turns["first"])
            results[name]["turns_ms"] = statistics.median(turns["this"])
    wide_phase(torch, K, R, cols, st, kw, results)
    del cols
    torch.cuda.empty_cache()


def wide_phase(torch, K, R, cols, strings, kw, results):
    """``BATCH_CRITERIA`` + ``WIDE_CRITERIA`` over the kernel phase's
    columns: 17 staged columns, half-tile stages. Masks and rule identical
    to the plain version, aggregates within TOL and bit for bit on a second
    call, and each program's R = 1 launch bit-equal to its batch row (those
    of ``BATCH_CRITERIA`` stage whole tiles alone); timed."""
    from repro_torch.core.policy import compile_programs, parse_expr
    exprs = BATCH_CRITERIA + WIDE_CRITERIA
    ops, colidx, operands = compile_programs(
        [parse_expr(e) for e in exprs], strings, NOW)
    prog = [torch.from_numpy(a).to(cols.device)
            for a in (ops, colidx, operands)]
    shape = K.launch_shape(cols, prog[0], prog[1], **kw)
    ring = shape["passes"][0]
    check(len(ring["staged_cols"]) == cols.shape[0]
          and ring["stage_rows"] < shape["tile_rows"],
          f"the wide batch stages {ring}, not every column in part tiles")
    masks_k, rule_k, agg_k = K.policy_scan_batch_cuda(cols, *prog, **kw)
    again = K.policy_scan_batch_cuda(cols, *prog, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(again, (masks_k, rule_k,
                                                        agg_k))),
          "wide policy_scan_batch outputs differ between two calls")
    del again
    masks_r, rule_r, agg_r = R.policy_scan_batch_ref(cols, *prog, **kw)
    torch.cuda.synchronize()
    check(torch.equal(masks_k, masks_r) and torch.equal(rule_k, rule_r),
          "wide policy_scan_batch masks or rule differ from the plain "
          "version")
    check(torch.allclose(agg_k, agg_r, **TOL), "wide policy_scan_batch "
          f"aggregates differ:\n{agg_k}\n{agg_r}")
    err = (agg_k.double() - agg_r.double()).abs().max().item()
    del masks_r, rule_r
    for r in range(len(exprs)):
        m1, a1 = K.policy_scan_cuda(cols, *(p[r] for p in prog), **kw)
        check(torch.equal(m1, masks_k[r]) and torch.equal(a1, agg_k[r]),
              f"wide program {r}: the R = 1 launch differs from its batch "
              "row")
        del m1
    del masks_k, rule_k
    ms, times = cuda_times_ms(
        lambda: K.policy_scan_batch_cuda(cols, *prog, **kw), REPS)
    plain_ms, _ = cuda_times_ms(
        lambda: R.policy_scan_batch_ref(cols, *prog, **kw), REPS)
    bms, by, nbytes, _ = bound_ms(cols.shape[1], ops, colidx,
                                  with_rule=True, **kw)
    kern = kernel_device_ms(
        torch, lambda: K.policy_scan_batch_cuda(cols, *prog, **kw), REPS)
    dev = one_kernel_ms(kern, "scan_kernel", "wide policy_scan_batch")
    log(f"[kernels] wide policy_scan_batch R={ops.shape[0]} "
        f"N={cols.shape[1]} {CARD}: masks and rule identical, agg max abs "
        f"err {err!r}, bit for bit on a second call and per program at "
        f"R = 1; {ms!r} ms (median of {len(times)}); plain {plain_ms!r} ms;"
        f" bound {bms!r} ms by {by} ({nbytes} B); {bms / ms:.3f} of the "
        f"bound; scan device ms {dev!r}; launch {json.dumps(shape)}")
    results["policy_scan_batch"]["wide"] = dict(
        programs=int(ops.shape[0]), ms=ms, plain_ms=plain_ms, bound_ms=bms,
        scan_device_ms=dev, max_abs_err=err, stages=ring["stages"],
        stage_rows=ring["stage_rows"])


def cube_columns(torch, n: int, n_groups: int, seed: int, device,
                 small: bool = False):
    """(7, n) f32 on the card in the prebucketed layout ``ProfileCube``
    passes: [gid, size, blocks, age, sb, ab, valid]. gid uniform in
    [0, n_groups); sizes and blocks multiples of 4 KiB below 2^36 (below
    2^11 when ``small``); ages integers in [-100, 400 days] (f32 rounds the
    odd ones above 2^24); about 1/64 of rows invalid. sb/ab are the plain
    version's buckets of these f32 values."""
    from repro_torch.kernels.profile_cube import ref as PR
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    hi, unit = (1 << 11, 1) if small else (1 << 24, 4096)
    cols = torch.empty((7, n), dtype=torch.float32, device=device)
    cols[0] = torch.randint(0, n_groups, (n,), generator=g, device=device)
    for r in (1, 2):
        cols[r] = torch.randint(0, hi, (n,), generator=g, device=device)
        cols[r] *= unit
    cols[3] = torch.randint(-100, 400 * 86400 + 1, (n,), generator=g,
                            device=device)
    cols[4] = PR.size_buckets(cols[1])
    cols[5] = PR.age_buckets(cols[3])
    cols[6] = torch.randint(0, 64, (n,), generator=g, device=device) > 0
    return cols


def raw_layout(torch, cols, n_groups=None):
    """[gid, size, blocks, age, valid] of a prebucketed stack, gid taken
    modulo ``n_groups`` when given (still uniform)."""
    out = torch.empty((5, cols.shape[1]), dtype=torch.float32,
                      device=cols.device)
    out[0] = cols[0] if n_groups is None else cols[0].remainder(n_groups)
    out[1:4] = cols[1:4]
    out[4] = cols[6]
    return out


PREBUCKETED = dict(gid_col=0, size_col=1, blocks_col=2, age_col=3,
                   sb_col=4, ab_col=5, valid_col=6)
RAW = dict(gid_col=0, size_col=1, blocks_col=2, age_col=3, sb_col=-1,
           ab_col=-1, valid_col=4)


def cube_bound_ms(torch, cols, n_groups: int, prebucketed: bool):
    """Least time for one cube build: each row's validity read once and,
    for a valid row, the four or five other rows the function needs
    (gid, size, blocks and sb/ab, or age), plus the f32 cube written once,
    over the memory rate; or the work (f32 compares of the raw layout's
    17 bucket edges, 2 f64 products and 3 f64 sums a valid row) over the
    peak rates. Returns (ms, by, bytes, f32 ops, f64 ops)."""
    valid_col = 6 if prebucketed else 4
    n = cols.shape[1]
    n_valid = int((cols[valid_col] != 0).sum().item())
    rows_read = 5 if prebucketed else 4
    out_bytes = 4 * 3 * n_groups * 70
    bytes_moved = 4 * n + 4 * rows_read * n_valid + out_bytes
    f32_ops = 0 if prebucketed else 17 * n_valid
    f64_ops = 5 * n_valid
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", bytes_moved, f32_ops, f64_ops)


def cube_library_ms(torch, cols, n_groups: int, prebucketed: bool) -> float:
    """Median ms of one ``index_add_`` of the (N, 3) valid-weighted values
    into a zeroed (n_groups * 70, 3) f32 cube on the cell index, computed
    beforehand (the bucketizing excluded)."""
    from repro_torch.kernels.profile_cube import ref as PR
    valid = cols[6 if prebucketed else 4]
    gid = cols[0].to(torch.int64)
    sb = cols[4].to(torch.int64) if prebucketed else PR.size_buckets(cols[1])
    ab = cols[5].to(torch.int64) if prebucketed else PR.age_buckets(cols[3])
    flat = (gid * 10 + sb) * 7 + ab
    vals = torch.stack([valid, valid * cols[1], valid * cols[2]], dim=1)
    del gid, sb, ab
    return cuda_times_ms(lambda: torch.zeros(
        (n_groups * 70, 3), dtype=torch.float32, device=cols.device)
        .index_add_(0, flat, vals), REPS)[0]


def rel_err(torch, got, want) -> float:
    d = (got.double() - want.double()).abs()
    return (d / want.double().abs().clamp_min(1)).max().item()


def zipf_gid(torch, n: int, n_groups: int, seed: int, device):
    """(n,) f32 group ids on the card with p_g ~ (g + 1)^-CUBE_ZIPF_S over
    [0, n_groups): a uniform from a seeded generator, searchsorted on the
    CDF."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    p = torch.arange(1, n_groups + 1, dtype=torch.float64,
                     device=device).pow(-CUBE_ZIPF_S)
    cdf = (p.cumsum(0) / p.sum()).float()
    u = torch.rand(n, generator=g, device=device)
    gid = torch.searchsorted(cdf, u, right=True, out_int32=True)
    return gid.clamp_(max=n_groups - 1).float()


def short_kernel_name(name: str) -> str:
    """``profile_cube::cube_kernel<true>`` of a profiler's
    ``void profile_cube::cube_kernel<true>(float const*, ...)``."""
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip() if "::" in name else name


def cube_device_ms(torch, fn) -> dict:
    """The card's own ms a call of each kernel (and memset) ``fn()``
    launches, by short name, from a ``torch.profiler`` trace of REPS
    calls (:func:`kernel_device_ms`)."""
    return {short_kernel_name(k): ms * per
            for k, (ms, per) in kernel_device_ms(torch, fn, REPS).items()}


def cube_phase(torch, seed, device, results):
    from repro_torch.kernels.profile_cube import kernel as PK
    from repro_torch.kernels.profile_cube import ops as PO
    from repro_torch.kernels.profile_cube import ref as PR
    n = ROWS
    t0 = time.perf_counter()
    cols_a = cube_columns(torch, n, CUBE_GROUPS, seed + 1, device)
    cols_b = raw_layout(torch, cols_a, CUBE_GROUPS_SMALL)
    cols_d = cols_a.clone()
    cols_d[0] = zipf_gid(torch, n, CUBE_GROUPS, seed + 4, device)
    torch.cuda.synchronize()
    log(f"[cube] columns (a) {tuple(cols_a.shape)}, (b) "
        f"{tuple(cols_b.shape)} and (d) {tuple(cols_d.shape)} f32 = "
        f"{(cols_a.numel() + cols_b.numel() + cols_d.numel()) * 4 / 1e9:.2f}"
        f" GB generated in {time.perf_counter() - t0:.2f} s; (d) gid Zipf "
        f"s={CUBE_ZIPF_S}: {(cols_d[0] == 0).float().mean().item():.4f} of "
        f"rows in group 0, {(cols_d[0] < 128).float().mean().item():.4f} in "
        f"groups 0-127")
    cells = {"a": (cols_a, CUBE_GROUPS, True),
             "b": (cols_b, CUBE_GROUPS_SMALL, False),
             "d": (cols_d, CUBE_GROUPS, True)}
    stats = {}
    for name, (cols, b, pre) in cells.items():
        kw = dict(PREBUCKETED if pre else RAW, n_groups=b)
        got = PK.profile_cube_cuda(cols, **kw)
        again = PK.profile_cube_cuda(cols, **kw)
        f32 = PR.profile_cube_ref(cols, **kw)
        f64 = PR.profile_cube_ref(cols.double(), **kw).float()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"profile_cube cell ({name}) differs "
              "from run to run")
        check(torch.equal(got[0], f32[0]), f"profile_cube cell ({name}) "
              "counts differ from the plain version")
        check(torch.equal(got, f64), f"profile_cube cell ({name}) differs "
              "from the f64 plain version cast to f32")
        n_valid = int((cols[kw["valid_col"]] != 0).sum().item())
        counted = int(got[0].double().sum().item())
        check(counted == n_valid, f"profile_cube cell ({name}) counted "
              f"{counted} rows, the valid rows are {n_valid}")
        abs_err = (got.double() - f64.double()).abs().max().item()
        rel32 = rel_err(torch, got, f32)
        stats[name] = dict(abs_err=abs_err, rel_err_f32=rel32,
                           design=PK.design(b, device))
        log(f"[cube] cell ({name}) N={n} B={b} "
            f"{'prebucketed' if pre else 'raw'} design "
            f"{stats[name]['design']}: identical to the f64 plain version "
            f"and to itself run to run; counts equal to the f32 plain "
            f"version; max rel err vs the f32 plain version {rel32!r}; "
            f"rows counted {counted}, equal to the valid rows")
        del got, again, f32, f64

    # (c): every per-cell sum below 2^24, so the f32 plain version is exact
    cols_c = cube_columns(torch, EXACT_ROWS, CUBE_GROUPS_SMALL, seed + 2,
                          device, small=True)
    for layout, cols, kw in (("prebucketed", cols_c, PREBUCKETED),
                             ("raw", raw_layout(torch, cols_c), RAW)):
        kw = dict(kw, n_groups=CUBE_GROUPS_SMALL)
        got = PK.profile_cube_cuda(cols, **kw)
        f32 = PR.profile_cube_ref(cols, **kw)
        f64 = PR.profile_cube_ref(cols.double(), **kw)
        torch.cuda.synchronize()
        top = f64.max().item()
        check(top < F32_EXACT, f"cell (c) has a cell sum {top} >= 2^24")
        check(torch.equal(got, f32), f"profile_cube cell (c) {layout} "
              "differs from the f32 plain version")
        log(f"[cube] cell (c) N={EXACT_ROWS} B={CUBE_GROUPS_SMALL} {layout} "
            f"design {PK.design(CUBE_GROUPS_SMALL, device)}: identical to "
            f"the f32 plain version (largest cell {top!r})")

    # edges: no rows / no groups, a ragged N, too many groups
    for n_rows, b in ((0, 0), (0, 3), (5, 0)):
        z = torch.zeros(n_rows).numpy()
        cube = PO.profile_cube(z, z, z, z, n_groups=b, device=device)
        check(cube.shape == (3, b, 10, 7) and not cube.any(),
              f"profile_cube with {n_rows} rows, {b} groups gave "
              f"{cube.shape}")
    ragged = torch.cat([cols_c, cols_c[:, :3]], dim=1)
    kw = dict(PREBUCKETED, n_groups=CUBE_GROUPS_SMALL)
    got = PK.profile_cube_cuda(ragged, **kw)
    check(torch.equal(got, PR.profile_cube_ref(ragged.double(), **kw)
                      .float()), "profile_cube differs on a ragged N")
    for fn in (lambda: PO.profile_cube(
                   *(torch.zeros(4).numpy(),) * 4,
                   n_groups=PK.MAX_GROUPS + 1, device=device),
               lambda: PK.profile_cube_cuda(
                   cols_c, **dict(PREBUCKETED,
                                  n_groups=PK.MAX_GROUPS + 1))):
        try:
            fn()
        except ValueError:
            continue
        fail("n_groups = MAX_GROUPS + 1 did not raise")
    log(f"[cube] edges: empty shapes as the reference's, ragged N="
        f"{ragged.shape[1]} identical to the f64 plain version, n_groups="
        f"{PK.MAX_GROUPS + 1} raises")
    del cols_c, ragged

    # times: CUDA events, median of REPS after a warm-up, beside the bound,
    # the plain version and one index_add_ on the precomputed cell index;
    # and the kernels' own device times from a torch.profiler trace
    timings = {}
    for name, (cols, b, pre) in cells.items():
        kw = dict(PREBUCKETED if pre else RAW, n_groups=b)
        call = lambda: PK.profile_cube_cuda(cols, **kw)  # noqa: E731
        ms, times = cuda_times_ms(call, REPS)
        dev = cube_device_ms(torch, call)
        plain_ms, _ = cuda_times_ms(lambda: PR.profile_cube_ref(cols, **kw),
                                    REPS)
        lib_ms = cube_library_ms(torch, cols, b, pre)
        bms, by, nbytes, f32_ops, f64_ops = cube_bound_ms(torch, cols, b,
                                                          pre)
        log(f"[cube] cell ({name}) {CARD}: design {stats[name]['design']}; "
            f"kernel {ms!r} ms (median of {len(times)}, min {min(times)!r}, "
            f"max {max(times)!r}); the card's own time (torch.profiler, "
            f"mean of {REPS}) {json.dumps(dev)} ms, sum "
            f"{sum(dev.values())!r}; plain {plain_ms!r} ms; index_add_ "
            f"{lib_ms!r} ms (excludes bucketize); bound {bms!r} ms by {by} "
            f"({nbytes} B, {f32_ops} f32 ops, {f64_ops} f64 ops); "
            f"{bms / ms:.3f} of the bound")
        timings[name] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by,
                             bytes=nbytes, rows=n, groups=b,
                             layout="prebucketed" if pre else "raw",
                             **stats[name])
    a = timings["a"]
    results["profile_cube"] = {
        "name": "profile_cube", "route": "cuda", "source": CUBE_SOURCE,
        "replaces": TPU_KERNELS["profile_cube"], "launches": None,
        "max_abs_err": a["abs_err"], "max_rel_err": a["rel_err_f32"],
        "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": a["library_ms"],
        "library": "index_add_ of (N, 3) valid-weighted values on the "
                   "precomputed cell index (excludes bucketize)",
        "error_against": "max_abs_err: the f64 plain version cast to f32; "
                         "max_rel_err: the f32 plain version",
        "cells": timings}
    del cols_a, cols_b, cols_d, cells
    torch.cuda.empty_cache()


def close_reports(got, want, key=None) -> bool:
    """Two report answers agree: the same keys, lengths and order, counts
    and labels equal, byte measures within rtol=1e-5."""
    import numpy as np
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(close_reports(got[k], want[k], k) for k in want))
    if isinstance(want, (list, tuple)):
        return (len(got) == len(want)
                and all(close_reports(g, w, key) for g, w in zip(got, want)))
    if key in ("volume", "spc_used", "avg_size"):
        return bool(np.isclose(got, want, rtol=1e-5, atol=0))
    return got == want


def path_cube_columns(torch, cat, groups, device) -> list:
    """The (7, N) f32 prebucketed columns ``ProfileCube.rebuild`` hands the
    op for each shard of ``cat`` (group ids from ``groups``, a
    ``ProfileCube``'s group table), on ``device``."""
    import numpy as np
    from repro_torch.core.profiles import age_buckets_np, size_buckets_np
    needed = ("owner", "group", "type", "hsm_state", "size", "blocks",
              "atime")
    out = []
    for shard in cat.shards:
        snap, _ = shard.snapshot(names=needed, with_strings=False)
        gids = groups.get_or_add_many(snap["owner"], snap["group"],
                                      snap["type"], snap["hsm_state"])
        age = NOW - snap["atime"]
        rows = (gids, snap["size"], snap["blocks"], age,
                size_buckets_np(snap["size"]), age_buckets_np(age),
                np.ones(len(gids)))
        out.append(torch.from_numpy(np.stack(
            [np.asarray(r, np.float32) for r in rows])).to(device))
    return out


def reports_phase(torch, cat, device, results):
    import dataclasses

    import numpy as np
    from repro_torch.core import ProfileCube, Reports
    from repro_torch.kernels.profile_cube import kernel as PK
    from repro_torch.kernels.profile_cube import ref as PR
    clock = lambda: NOW  # noqa: E731

    t0 = time.perf_counter()
    kcube, counts = launch_window(lambda: ProfileCube(
        cat, clock=clock, use_kernel=True, device=device).attach())
    k_wall = time.perf_counter() - t0
    want = only(profile_cube=cat.n_shards)
    check(counts == want, f"ProfileCube(use_kernel=True).attach() launched "
          f"{counts}, expected {want}")
    results["profile_cube"]["launches"] = counts["profile_cube"]
    results["profile_cube"]["launches_by_path"] = {
        "ProfileCube.rebuild": counts["profile_cube"]}
    t0 = time.perf_counter()
    host = ProfileCube(cat, clock=clock, device=device)
    host.rebuild()
    h_wall = time.perf_counter() - t0
    kc, hc = kcube.cube(), host.cube()
    check(kc.shape == hc.shape, f"cube shapes differ: {kc.shape} vs "
          f"{hc.shape}")
    check(np.array_equal(kc[0], hc[0]), "kernel-built cube counts differ "
          "from the host groupby's")
    check(np.allclose(kc[1:], hc[1:], rtol=1e-5, atol=0), "kernel-built "
          "cube volume/spc_used differ from the host groupby's")
    rel = float((np.abs(kc - hc) / np.maximum(np.abs(hc), 1)).max())
    log(f"[reports] {CARD}: ProfileCube rebuild over {len(cat)} entries, "
        f"{kc.shape[1]} groups: kernel {k_wall!r} s (launches "
        f"{json.dumps(counts)}), host int64 groupby {h_wall!r} s; counts "
        f"identical, volume/spc_used max rel err {rel!r}")

    # the kernel at this path's shapes: each shard's prebucketed columns
    path_ms = path_plain_ms = 0.0
    path_dev: dict = {}
    shards = path_cube_columns(torch, cat, kcube.groups, device)
    for sid, cols in enumerate(shards):
        kw = dict(PREBUCKETED, n_groups=len(kcube.groups))
        got = PK.profile_cube_cuda(cols, **kw)
        check(torch.equal(got, PR.profile_cube_ref(cols.double(), **kw)
                          .float()), f"shard {sid}: profile_cube differs "
              "from the f64 plain version")
        check(torch.equal(got[0], PR.profile_cube_ref(cols, **kw)[0]),
              f"shard {sid}: profile_cube counts differ from the plain "
              "version")
        call = lambda: PK.profile_cube_cuda(cols, **kw)  # noqa: E731
        path_ms += cuda_times_ms(call, REPS)[0]
        for k, v in cube_device_ms(torch, call).items():
            path_dev[k] = path_dev.get(k, 0.0) + v
        path_plain_ms += cuda_times_ms(
            lambda: PR.profile_cube_ref(cols, **kw), REPS)[0]
    b = len(kcube.groups)
    results["profile_cube"]["path"] = dict(
        ms=path_ms, device_ms=path_dev, plain_ms=path_plain_ms,
        rows=len(cat), groups=b, shards=cat.n_shards,
        design=PK.design(b, device))
    log(f"[reports] {CARD}: profile_cube held to its plain version on each "
        f"of the {cat.n_shards} shards' (7, N) columns, B={b} (design "
        f"{PK.design(b, device)}): identical to the f64 plain version; "
        f"kernel {path_ms!r} ms, plain {path_plain_ms!r} ms over the "
        f"{cat.n_shards} shards (sums of medians of {REPS}); the card's own "
        f"time over the shards (torch.profiler) {json.dumps(path_dev)} ms")
    del shards

    kr = Reports(cat, profiles=kcube, clock=clock)
    hr = Reports(cat, profiles=host, clock=clock)
    owners = sorted({cat.strings.lookup(int(c))
                     for c in np.unique(cat.arrays()["owner"])})
    queries = {f"report_user({u})": (lambda r, u=u: r.report_user(u))
               for u in owners}
    queries.update({f"user_size_profile({u})":
                    (lambda r, u=u: r.user_size_profile(u)) for u in owners})
    queries.update({
        "report_types": lambda r: r.report_types(),
        "report_hsm": lambda r: r.report_hsm(),
        "age_profile": lambda r: r.age_profile(),
        "top_users(count)": lambda r: r.top_users(by="count", k=10)})
    for name, q in queries.items():
        got, want = q(kr), q(hr)
        check(close_reports(got, want), f"Reports.{name} differs between "
              f"the kernel-built and host cubes:\n{got}\n{want}")
    top = kr.top_users(by="count", k=3)
    log(f"[reports] {len(queries)} rbh-report answers from the kernel-built "
        f"cube match the host cube's (counts, keys, order exact; volumes "
        f"rtol 1e-5); top users by count "
        f"{[(d['user'], d['count']) for d in top]}")

    # deltas through the catalog's hooks, then a fresh host rebuild
    rng = np.random.default_rng(7)
    fids = rng.choice(cat.arrays()["fid"], 4096, replace=False).tolist()
    changed = []
    for f in fids:
        e = cat.get(int(f))
        changed.append(dataclasses.replace(
            e, size=int(rng.integers(0, 1 << 24)) * 4096,
            atime=float(rng.integers(0, 1 << 24)),
            owner=f"u{int(rng.integers(0, 8))}"))
    cat.upsert_batch(changed)
    after = kcube.cube()
    fresh = ProfileCube(cat, clock=clock, device=device)
    fresh.rebuild()
    fc = fresh.cube()
    check(after.shape == fc.shape and np.array_equal(after[0], fc[0]),
          "after the deltas the kernel-built cube's counts differ from a "
          "fresh host rebuild's")
    check(np.allclose(after[1:], fc[1:], rtol=1e-5, atol=0), "after the "
          "deltas the kernel-built cube's volumes differ from a fresh "
          "host rebuild's")
    log(f"[reports] {len(changed)} changed entries through upsert_batch: "
        "the kernel-built cube's counts equal a fresh host rebuild's")


class Recorder:
    """Recording action: (fid, rule tier) in the order the engine sent them.

    The tier comes from the params of the rule the engine attributed the
    fid to, so a wrong first-match-wins rule index shows as a difference."""

    def __init__(self):
        self.lock = threading.Lock()
        self.calls = []

        def action_batch(batch, params):
            tier = params.get("tier")
            with self.lock:
                self.calls.extend((f, tier) for f in batch.fids.tolist())
            return [True] * len(batch)

        self.action_batch = action_batch

    def __call__(self, entry, params):
        with self.lock:
            self.calls.append((entry.fid, params.get("tier")))
        return True


def launch_window(fn):
    """``fn()`` with every launch count set to 0 just before it; returns
    its result and the counts it left, read just after."""
    from repro_torch.kernels.paged_attention import kernel as AK
    from repro_torch.kernels.policy_scan import kernel as K
    from repro_torch.kernels.profile_cube import kernel as PK
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rwkv6_step import kernel as RWK
    for mod in (K, PK, AK, RGK, RWK):
        mod.reset_counters()
    out = fn()
    return out, {"policy_scan": K.policy_scan_launches,
                 "policy_scan_batch": K.policy_scan_batch_launches,
                 "profile_cube": PK.profile_cube_launches,
                 "paged_attention": AK.paged_attention_launches,
                 "rglru_scan": RGK.rglru_scan_launches,
                 "rwkv6_step": RWK.rwkv6_step_launches}


def only(**launches) -> dict:
    """The counts a window must show: these kernels so many times, every
    other kernel never."""
    want = dict.fromkeys(TPU_KERNELS, 0)
    want.update(launches)
    return want


def agg_close(got: dict, want: dict) -> bool:
    """Two match_programs aggregate dicts agree key for key within TOL."""
    import numpy as np
    return got.keys() == want.keys() and all(
        np.allclose(np.asarray(got[k], np.float64),
                    np.asarray(want[k], np.float64), **TOL) for k in got)


def flat_spans(node, depth: int = 0):
    """(indented name, elapsed seconds) of a RunReport span tree."""
    if not node:
        return []
    out = [("." * depth + node["name"], node["elapsed_s"])]
    for child in node.get("children", []):
        out += flat_spans(child, depth + 1)
    return out


def build_catalog(n: int, seed: int):
    """n entries, f32-exact, built in chunks through upsert_batch."""
    import numpy as np
    from repro_torch.core import Catalog, Entry, FsType
    rng = np.random.default_rng(seed)
    cat = Catalog(n_shards=4)
    chunk = 1 << 17
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        is_file = (rng.random(m) < 0.9).tolist()
        size = (rng.integers(0, 1 << 24, m) * 4096).tolist()
        blocks = (rng.integers(0, 1 << 24, m) * 4096).tolist()
        owner = rng.integers(0, 8, m).tolist()
        atime = rng.integers(0, 1 << 24, m).astype(float).tolist()
        mtime = rng.integers(0, 1 << 24, m).astype(float).tolist()
        cat.upsert_batch([Entry(
            fid=lo + i + 1, name=f"f{lo + i}", path=f"/fs/d{(lo + i) % 97}"
            f"/f{lo + i}", type=FsType.FILE if is_file[i] else FsType.DIR,
            size=size[i], blocks=blocks[i], owner=f"u{owner[i]}",
            atime=atime[i], mtime=mtime[i], ctime=mtime[i])
            for i in range(m)])
    return cat


def engine_phase(torch, cat, device, results):
    import numpy as np
    from repro_torch.core import PolicyDefinition, PolicyEngine
    from repro_torch.core.policy import KERNEL_COLUMNS, compile_programs
    from repro_torch.kernels.policy_scan import kernel as K
    from repro_torch.kernels.policy_scan import ref as R
    from repro_torch.kernels.policy_scan.ops import (_agg_dict, column_stack,
                                                     match_programs,
                                                     scan_catalog)
    cat.arrays()     # both evaluators then find the column snapshot cached
    eng = PolicyEngine(cat, clock=lambda: NOW, device=device)
    rules = [("archive_big", "size > 16G", {"tier": "archive"}),
             ("purge_old", "last_access > 90d", {"tier": "purge"})]
    windows = {}     # path -> launch counts of its own window
    for budget in ({}, {"max_actions_per_run": 10_000},
                   {"target": 1 << 44}):
        tag = ",".join(f"{k}={v}" for k, v in budget.items()) or "none"
        seqs = {}
        for evaluator in ("policy_scan", "numpy"):
            rec = Recorder()
            eng.register(PolicyDefinition.from_config(
                name="lru", action=rec, scope="type == file", rules=rules,
                sort_by="atime", mutates=False, batch_size=4096,
                max_actions_per_run=budget.get("max_actions_per_run", 0)))
            t1 = time.perf_counter()
            rep, counts = launch_window(lambda: eng.run(
                "lru", evaluator=evaluator,
                target_volume=budget.get("target", 0)))
            wall = time.perf_counter() - t1
            want = only(policy_scan_batch=1 if evaluator == "policy_scan"
                        else 0)
            check(counts == want, f"PolicyEngine.run(evaluator="
                  f"{evaluator!r}) (budget {tag}) launched {counts}, "
                  f"expected {want}")
            if evaluator == "policy_scan" and not budget:
                windows["PolicyEngine.run"] = counts
            seqs[evaluator] = (rep, list(rec.calls))
            log(f"[engine] budget {tag} evaluator {evaluator}: matched "
                f"{rep.matched} succeeded {rep.succeeded} volume "
                f"{rep.volume} evaluator_used {rep.evaluator!r} "
                f"fallback {rep.fallback_reason!r} launches {counts} "
                f"wall {wall!r} s")
            if not budget:
                log(f"[engine] spans ({evaluator}): "
                    + "; ".join(f"{name} {s!r}" for name, s in
                                flat_spans(rep.telemetry.get("spans"))))
        k_rep, k_calls = seqs["policy_scan"]
        n_rep, n_calls = seqs["numpy"]
        check(k_rep.evaluator == "policy_scan",
              f"engine ran {k_rep.evaluator!r}, not policy_scan")
        check(k_rep.fallback_reason == "",
              f"engine fell back: {k_rep.fallback_reason!r}")
        check(n_rep.evaluator == "numpy", "numpy evaluator did not run")
        check(k_calls == n_calls, f"actioned (fid, tier) sequences differ "
              f"(budget {tag}): {len(k_calls)} vs {len(n_calls)}")
        check((k_rep.matched, k_rep.succeeded, k_rep.volume) ==
              (n_rep.matched, n_rep.succeeded, n_rep.volume),
              f"run reports differ (budget {tag})")
        check(len(k_calls) > 0, "the policy actioned nothing")
        tiers = {t: sum(1 for _f, u in k_calls if u == t)
                 for t in ("archive", "purge", None)}
        check(tiers["archive"] > 0 and tiers["purge"] > 0,
              f"a rule actioned nothing (budget {tag}): {tiers}")
        log(f"[engine] budget {tag}: {len(k_calls)} actioned (fid, tier) "
            f"pairs identical across policy_scan and numpy; per tier "
            f"{tiers}")

    # the batch kernel at this path's shapes against its plain version:
    # the policy's compiled programs over this catalog's column stack
    policy = eng.policies["lru"]
    programs = PolicyEngine._programs(policy, None)
    arrays = cat.arrays()
    kcols = column_stack(arrays, device)
    prog = [torch.from_numpy(a).to(device)
            for a in compile_programs(programs, cat.strings, NOW)]
    kw = dict(size_col=KERNEL_COLUMNS.index("size"),
              blocks_col=KERNEL_COLUMNS.index("blocks"))
    masks_k, rule_k, agg_k = K.policy_scan_batch_cuda(kcols, *prog, **kw)
    masks_r, rule_r, agg_r = R.policy_scan_batch_ref(kcols, *prog, **kw)
    torch.cuda.synchronize()
    check(torch.equal(masks_k, masks_r), "engine-shape policy_scan_batch "
          "masks differ from the plain version")
    check(torch.equal(rule_k, rule_r), "engine-shape policy_scan_batch rule "
          "index differs from the plain version")
    check(torch.allclose(agg_k, agg_r, **TOL), "engine-shape "
          f"policy_scan_batch aggregates differ:\n{agg_k}\n{agg_r}")
    ref_masks = [m for m in (masks_r > 0.5).cpu().numpy()]
    ref_rule = rule_r.cpu().numpy()
    ref_agg_np = agg_r.cpu().numpy()
    ref_agg = _agg_dict(ref_agg_np[0], ref_agg_np)
    log(f"[engine] policy_scan_batch R={len(programs)} N={kcols.shape[1]}: "
        "masks and rule identical to the plain version; agg max abs err "
        f"{(agg_k.double() - agg_r.double()).abs().max().item()!r}")
    del kcols, masks_k, rule_k, masks_r, rule_r

    # the path the engine runs, held to the plain version's output
    batch = match_programs(arrays, programs, cat.strings, NOW, device=device)
    check(len(batch[0]) == len(ref_masks) and all(
        np.array_equal(m_b, m_r) for m_b, m_r in zip(batch[0], ref_masks)),
        "match_programs masks differ from the plain version")
    check(np.array_equal(batch[2], ref_rule), "match_programs rule index "
          "differs from the plain version")
    check(agg_close(batch[1], ref_agg), "match_programs aggregates differ "
          f"from the plain version: {batch[1]} vs {ref_agg}")

    # scan_catalog: the single-program kernel, once
    (fids_s, agg_s), counts = launch_window(
        lambda: scan_catalog(cat, programs[0], NOW, device=device))
    check(counts == only(policy_scan=1),
          f"scan_catalog launched {counts}, expected one policy_scan")
    windows["scan_catalog"] = counts
    check(np.array_equal(fids_s, arrays["fid"][ref_masks[0]]),
          "scan_catalog fids differ from the plain version's")
    check(agg_close(agg_s, _agg_dict(ref_agg_np[0])), "scan_catalog "
          f"aggregates differ from the plain version's: {agg_s}")

    # match_programs(single_launch=False): the single-program kernel, once
    # per program, attribution on the host
    per_prog, counts = launch_window(lambda: match_programs(
        arrays, programs, cat.strings, NOW, single_launch=False,
        device=device))
    want = only(policy_scan=len(programs))
    check(counts == want, "match_programs(single_launch=False) launched "
          f"{counts}, expected {want}")
    windows["match_programs(single_launch=False)"] = counts
    for m_s, m_b in zip(per_prog[0], batch[0]):
        check(np.array_equal(m_s, m_b), "per-program masks differ from "
              "the batch path's")
    check(np.array_equal(per_prog[2], batch[2]), "host attribution differs "
          "from the kernel's")
    check(per_prog[1] == batch[1], "per-program aggregates differ from the "
          "batch path's")
    log(f"[engine] scan_catalog: {len(fids_s)} fids, count "
        f"{agg_s['count']!r}; per-program masks, rule index and aggregates "
        "identical to the batch path; launches per path "
        f"{json.dumps(windows)}")
    for name in ("policy_scan_batch", "policy_scan"):
        results[name]["launches_by_path"] = {
            path: c[name] for path, c in windows.items()}
    results["policy_scan_batch"]["launches"] = \
        windows["PolicyEngine.run"]["policy_scan_batch"]
    results["policy_scan"]["launches"] = \
        windows["scan_catalog"]["policy_scan"]


def attn_tables(torch, seed: int, device):
    """Lengths (B,) i32 uniform in [1, ATTN_CONTEXT] and page tables (B,
    ATTN_MAX_PAGES) i32 from a seeded permutation of the pool, -1 past each
    sequence's pages. Sequence 0 is empty, sequence 1 ends mid-page near
    the context and has a -1 hole at its page 1, sequence 2 ends on a page
    boundary."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lengths = torch.randint(1, ATTN_CONTEXT + 1, (ATTN_SEQS,), generator=g,
                            device=device, dtype=torch.int32)
    lengths[0] = 0
    lengths[1] = ATTN_CONTEXT - 37
    lengths[2] = (lengths[2] // ATTN_PAGE).clamp(min=1) * ATTN_PAGE
    table = torch.randperm(ATTN_POOL, generator=g, device=device).to(
        torch.int32).view(ATTN_SEQS, ATTN_MAX_PAGES)
    n_used = (lengths + ATTN_PAGE - 1) // ATTN_PAGE
    page = torch.arange(ATTN_MAX_PAGES, device=device)
    table[page[None, :] >= n_used[:, None]] = -1
    table[1, 1] = -1
    return lengths, table


def attn_long_table(torch, seed: int, device):
    """The long-context decode case: one sequence of ATTN_CONTEXT tokens
    over every page of an ATTN_MAX_PAGES-page pool, in a seeded order."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    table = torch.randperm(ATTN_MAX_PAGES, generator=g, device=device).to(
        torch.int32).view(1, ATTN_MAX_PAGES)
    lengths = torch.full((1,), ATTN_CONTEXT, dtype=torch.int32,
                         device=device)
    return lengths, table


def attn_valid(torch, lengths, table):
    """(B, max_pages * P) bool: positions under the length in pages that
    are not -1, the rows the function must read."""
    pos = torch.arange(table.shape[1] * ATTN_PAGE, device=table.device)
    page_ok = (table >= 0).repeat_interleave(ATTN_PAGE, dim=1)
    return (pos[None, :] < lengths[:, None].long()) & page_ok


def attn_bound_ms(torch, valid, n_heads: int, n_kv: int, hd: int,
                  elt: int):
    """Least time for one call: the K and V rows ``valid`` covers read
    once, q, the tables and lengths read once and out written once, over
    the memory rate; or the 4 * hd f32 operations (two products, two sums)
    per position and query head over the f32 peak. Returns (ms, by, bytes,
    ops)."""
    rows = int(valid.sum().item())
    b = valid.shape[0]
    nbytes = (2 * rows * n_kv * hd * elt + 2 * b * n_heads * hd * elt
              + 4 * b * (valid.shape[1] // ATTN_PAGE) + 4 * b)
    ops = 4 * rows * n_heads * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def attn_grid(torch, AK, lengths, table, n_heads: int, n_kv: int, occ,
              sms: int) -> dict:
    """The split kernel's grid for this batch: (B, K * ceil(G / 16),
    S_max) blocks, the live ones (a sequence's splits that hold a readable
    page) and the waves they take at the occupancy ``occ``."""
    per_kv = -(-(n_heads // n_kv) // 16)
    s_max = AK.n_splits(table.shape[1])
    start = torch.arange(table.shape[1], device=table.device) * ATTN_PAGE
    readable = ((table >= 0) & (start[None, :] < lengths[:, None].long())
                ).sum(1)
    live = int((-(-readable // AK.pages_per_split())).sum().item()) \
        * n_kv * per_kv
    return dict(grid_blocks=table.shape[0] * n_kv * per_kv * s_max,
                s_max=s_max, live_blocks=live,
                waves=live / (occ["blocks_per_sm"] * sms))


ATTN_ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def attn_close(torch, got, want, vmax: float, dtype_name: str) -> dict:
    """The kernel tolerances against the plain version: elementwise (f32
    ``rtol=1e-4`` with atol ``1e-4 * max|v|``; bf16 ``rtol=atol=5e-2``),
    and each output row (a query head of a sequence) within ATTN_ROW_TOL of
    its own size in relative L2 error. The row limit is what holds bf16:
    a long sequence's outputs (std about sqrt(e / L), 0.018 at 8,192
    tokens) are smaller than 5e-2, so a dropped split or tile would pass
    the elementwise one."""
    g, w = got.float(), want.float()
    if dtype_name == "float32":
        rtol, atol = 1e-4, 1e-4 * vmax
    else:
        rtol = atol = 5e-2
    elementwise = bool(torch.allclose(g, w, rtol=rtol, atol=atol))
    diff, size = (g - w).norm(dim=-1), w.norm(dim=-1)
    rows = bool((diff <= ATTN_ROW_TOL[dtype_name] * size).all())
    return dict(ok=elementwise and rows, elementwise=elementwise, rows=rows,
                max_abs_err=float((g - w).abs().max().item()),
                row_err=float((diff / size.clamp(min=1e-30)).max().item()),
                rtol=rtol, atol=atol, row_tol=ATTN_ROW_TOL[dtype_name])


def attn_inputs(torch, H: int, K: int, hd: int, dtype, B: int, n_pool: int,
                seed: int, device):
    """q (B, H, hd) and K/V pages (n_pool, ATTN_PAGE, K, hd), standard
    normal in ``dtype``, from ``seed`` and the widths."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + H + K)
    shape = (n_pool, ATTN_PAGE, K, hd)
    kp = torch.randn(shape, generator=g, device=device).to(dtype)
    vp = torch.randn(shape, generator=g, device=device).to(dtype)
    q = torch.randn((B, H, hd), generator=g, device=device).to(dtype)
    return q, kp, vp


def attn_case(torch, name, H, K, hd, dtype_name, lengths, table,
              n_pool: int, seed: int, device, batch: bool, flush) -> dict:
    """One attention configuration: the op held to its plain version (and,
    for the batch, the zeros, hole and B = 1 checks), then timed from an
    idle card with the L2 cache flushed before each call (``flush``): the
    call, the plain version and SDPA over K/V gathered beforehand, beside
    the bound; and the split kernel's and the combine's own device times
    from a ``torch.profiler`` trace of the call."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import kernel as AK
    from repro_torch.kernels.paged_attention import ref as AR
    B, P = table.shape[0], ATTN_PAGE
    dtype = getattr(torch, dtype_name)
    valid = attn_valid(torch, lengths, table)
    q, kp, vp = attn_inputs(torch, H, K, hd, dtype, B, n_pool, seed, device)
    args = (q, kp, vp, table, lengths)
    got = AK.paged_attention_cuda(*args)
    again = AK.paged_attention_cuda(*args)
    want = AR.paged_attention_ref(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()),
          f"{name}: the kernel gave a non-finite output")
    check(torch.equal(got, again), f"{name}: the kernel differs from "
          "run to run")
    if batch:
        # sequence 1 with its hole taken out: the same pages in the same
        # order; and sequence 1 alone
        row = table[1][table[1] >= 0]
        packed = torch.full((1, table.shape[1]), -1, dtype=torch.int32,
                            device=device)
        packed[0, :row.numel()] = row
        hole = AK.paged_attention_cuda(q[1:2].contiguous(), kp, vp, packed,
                                       lengths[1:2] - P)
        alone = AK.paged_attention_cuda(q[1:2].contiguous(), kp, vp,
                                        table[1:2].contiguous(),
                                        lengths[1:2].contiguous())
        check(bool((got[0] == 0).all()) and bool((want[0] == 0).all()),
              f"{name}: the empty sequence is not exactly zero")
        check(torch.equal(got[1:2], hole), f"{name}: the hole sequence "
              "differs from the same table with the hole taken out")
        check(torch.equal(got[1:2], alone), f"{name}: sequence 1 alone "
              "differs from its row in the batch")
        del hole, alone
    vmax = float(vp.float().abs().max().item())
    close = attn_close(torch, got, want, vmax, dtype_name)
    check(close["ok"], f"{name}: the kernel differs from the plain version: "
          f"{json.dumps(close)}")
    del again, want

    call = lambda: AK.paged_attention_cuda(*args)    # noqa: E731
    ms, times = cuda_times_ms(call, REPS, flush=flush)
    kern = kernel_device_ms(torch, call, REPS, flush)
    split_ms = one_kernel_ms(kern, "split_kernel", name)
    combine_ms = None
    if AK.n_splits(table.shape[1]) > 1:
        combine_ms = one_kernel_ms(kern, "combine_kernel", name)
    else:
        check(not any("combine_kernel" in k for k in kern),
              f"{name}: a one-split table launched the combine")
    kernels_ms = split_ms + (combine_ms or 0.0)
    plain_ms, _ = cuda_times_ms(lambda: AR.paged_attention_ref(*args), REPS,
                                flush=flush)
    # the library call: K/V gathered contiguous (B, K, L, hd) first
    ids = table.clamp(min=0).long()
    kseq = kp[ids].reshape(B, -1, K, hd).transpose(1, 2).contiguous()
    vseq = vp[ids].reshape(B, -1, K, hd).transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    qs = q[:, :, None, :]
    lib_ms, _ = cuda_times_ms(lambda: F.scaled_dot_product_attention(
        qs, kseq, vseq, attn_mask=mask, enable_gqa=True), REPS, flush=flush)
    del kseq, vseq, ids
    bms, by, nbytes, ops = attn_bound_ms(torch, valid, H, K, hd,
                                         kp.element_size())
    occ = AK.occupancy(dtype, H, K, hd, P, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = attn_grid(torch, AK, lengths, table, H, K, occ, sms)
    held = ("zeros, hole, B = 1 and run-to-run checks held" if batch
            else "run-to-run check held")
    log(f"[attn] {name} (B {B}, H {H}, K {K}, hd {hd}) {CARD}: "
        f"{occ['design']}; L2 flushed before each timed call; call "
        f"{ms!r} ms from an idle card (CUDA events, median of {len(times)}, "
        f"min {min(times)!r}, max {max(times)!r}); the card's own time "
        f"(torch.profiler, mean of {REPS}): split kernel {split_ms!r} ms, "
        f"combine {combine_ms!r} ms; plain {plain_ms!r} ms; sdpa {lib_ms!r} "
        f"ms (K/V gathered beforehand; both from an idle card); bound "
        f"{bms!r} ms by {by} ({nbytes} B, {ops} f32 ops); {bms / ms:.3f} of "
        f"the bound ({bms / kernels_ms:.3f} by the kernels' own time); max "
        f"abs err {close['max_abs_err']!r} (max|v| {vmax!r}), largest row "
        f"relative L2 error {close['row_err']!r} (limit "
        f"{close['row_tol']}); grid {grid['grid_blocks']} blocks (S_max "
        f"{grid['s_max']}), {grid['live_blocks']} live, {occ['threads']} "
        f"threads, {occ['shared_bytes']} B shared, {occ['blocks_per_sm']} "
        f"blocks an SM on {sms} SMs ({grid['waves']:.2f} waves of live "
        f"blocks); {held}")
    del q, kp, vp, args, got
    torch.cuda.empty_cache()
    return dict(ms=ms, split_ms=split_ms, combine_ms=combine_ms,
                kernels_ms=kernels_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                max_abs_err=close["max_abs_err"], row_err=close["row_err"],
                max_abs_v=vmax, batch=B, heads=H, kv_heads=K, head_dim=hd,
                dtype=dtype_name, **grid, **occ)


def attn_phase(torch, seed, device, results):
    lengths, table = attn_tables(torch, seed + 3, device)
    valid = attn_valid(torch, lengths, table)
    log(f"[attn] {ATTN_SEQS} sequences, lengths {lengths[:4].tolist()}... "
        f"(sum {int(lengths.sum().item())}, max "
        f"{int(lengths.max().item())}), page size {ATTN_PAGE}, table "
        f"({ATTN_SEQS}, {ATTN_MAX_PAGES}) from a permutation of {ATTN_POOL} "
        f"pages; rows to read {int(valid.sum().item())}")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    configs = {}
    for name, H, K, hd, dtype_name in ATTN_CONFIGS:
        configs[name] = attn_case(torch, name, H, K, hd, dtype_name, lengths,
                                  table, ATTN_POOL, seed, device, batch=True,
                                  flush=flush)
    long_len, long_table = attn_long_table(torch, seed + 5, device)
    for name, H, K, hd, dtype_name in ATTN_LONG:
        configs[name] = attn_case(torch, name, H, K, hd, dtype_name,
                                  long_len, long_table, ATTN_MAX_PAGES, seed,
                                  device, batch=False, flush=flush)
    del flush
    main = configs[ATTN_CONFIGS[0][0]]
    results["paged_attention"] = {
        "name": "paged_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": TPU_KERNELS["paged_attention"], "launches": None,
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "scaled_dot_product_attention(enable_gqa=True) with a "
                   "boolean mask over K/V gathered contiguous beforehand",
        "error_against": "the plain version on the same tensors",
        "configs": configs}


def attn_agrees(torch, out, want, q, k_pages, v_pages, page_table,
                lengths):
    """Whether the kernel's ``out`` agrees with the plain version's
    ``want`` on the serving path's inputs, whose scores grow with depth
    (the reference model has no normalization): deep layers' softmax is
    near one-hot, and f32 rounding of a score can move weight between
    near-tied positions. Each version's f32 score lies within
    delta = (hd + 2) 2^-24 max_t sum_d |q_d k_td| / sqrt(hd) of the exact
    one, so two bounds must hold for every head:

    1. |out - want| <= 1e-4 |want| + max|v| (1e-4 + expm1(4 delta)): two
       score sets 2 delta apart move each softmax weight by a factor
       within e^(+-4 delta);
    2. out lies within the range of the V rows whose exact (f64) score is
       within 4 delta of the largest, give or take
       max|v| (1e-4 + 2 n e^(-2 delta)): every other row weighs at most
       e^(-2 delta) of the largest.

    The first is tight where delta is small (shallow layers), the second
    where one position wins (deep layers). Returns (ok, largest |score|,
    largest delta, heads with 4 delta below 1e-3)."""
    import math
    _, H, hd = q.shape
    _, P, K, _ = k_pages.shape
    G = H // K
    vmax = float(v_pages.abs().max().item())
    ok, top, worst, tight = True, 0.0, 0.0, 0
    for b in range(q.shape[0]):
        n_len = int(lengths[b].item())
        pages = page_table[b][:-(-n_len // P)].long()
        valid = (pages >= 0).repeat_interleave(P)[:n_len]
        k = k_pages[pages.clamp(min=0)].reshape(-1, K, hd)[:n_len][valid]
        v = v_pages[pages.clamp(min=0)].reshape(-1, K, hd)[:n_len][valid]
        o = out[b].double().reshape(K, G, hd)
        w = want[b].double().reshape(K, G, hd)
        if k.shape[0] == 0:
            ok &= bool((o == 0).all()) and bool((w == 0).all())
            continue
        qg = q[b].double().reshape(K, G, hd) / math.sqrt(hd)
        kd, vd = k.double(), v.double().permute(1, 0, 2)   # (K, n, hd)
        sc = torch.einsum("kgd,nkd->kgn", qg, kd)
        mag = torch.einsum("kgd,nkd->kgn", qg.abs(), kd.abs())
        delta = (hd + 2) * 2.0 ** -24 * mag.amax(-1)            # (K, G)
        live = sc > -0.5e30
        smax = torch.where(live, sc, -math.inf).amax(-1)
        near = live & (sc >= (smax - 4 * delta)[..., None])
        pick = near[..., None]                                  # K,G,n,1
        lo = torch.where(pick, vd[:, None], math.inf).amin(2)
        hi = torch.where(pick, vd[:, None], -math.inf).amax(2)
        d = delta[..., None]
        tol1 = 1e-4 * w.abs() + vmax * (1e-4 + torch.expm1(
            (4 * d).clamp(max=60)))
        tol2 = vmax * (1e-4 + 2 * k.shape[0] * torch.exp(-2 * d))
        dead = ~live.any(-1)[..., None]          # every score cut: zeros
        fine = torch.isfinite(w)
        good = ((o - w).abs() <= tol1) & (o >= lo - tol2) & (o <= hi + tol2)
        good = torch.where(dead, o == 0, good)
        ok &= bool(torch.where(fine, good & torch.isfinite(o),
                               ~torch.isfinite(o)).all())
        top = max(top, float(sc.abs().max().item()))
        worst = max(worst, float(delta.max().item()))
        tight += int((4 * delta < 1e-3).sum().item())
    return ok, top, worst, tight


class AttnChecker:
    """Stands in for the op the serving engine calls. It always returns the
    kernel's result; for the first call of every layer, every call right
    after that layer's cache restored a page and every ``every``-th call it
    also runs the plain version on the same device tensors and fails the
    run on any mismatch (``attn_agrees``)."""

    def __init__(self, op, caches, every: int):
        self.op, self.caches, self.every = op, caches, every
        self.layer_of = {c.pool.k.data_ptr(): i for i, c in enumerate(caches)}
        self.restores = [0] * len(caches)
        self.layers = {}            # layer -> [checks, max |score|, delta]
        self.calls = self.checked = self.after_restore = self.tight = 0
        self.max_err = 0.0
        self.last = None

    def __call__(self, q, k_pages, v_pages, page_table, lengths,
                 use_kernel=None):
        import torch
        from repro_torch.kernels.paged_attention import ref as AR
        out = self.op(q, k_pages, v_pages, page_table, lengths, use_kernel)
        li = self.layer_of[k_pages.data_ptr()]
        restores = self.caches[li].restores
        restored = restores != self.restores[li]
        self.restores[li] = restores
        if restored or li not in self.layers or self.calls % self.every == 0:
            pt = torch.as_tensor(page_table).to(q.device, torch.int32)
            ln = torch.as_tensor(lengths).to(q.device, torch.int32)
            want = AR.paged_attention_ref(q, k_pages, v_pages, pt, ln)
            ok, top, delta, tight = attn_agrees(torch, out, want, q, k_pages,
                                                v_pages, pt, ln)
            err = float((out - want).abs().max().item())
            check(ok, f"serving: the kernel differs from the plain version "
                  f"at layer {li}, call {self.calls}: max abs err {err!r}, "
                  f"largest |score| {top!r}, delta {delta!r}")
            self.max_err = max(self.max_err, err)
            self.checked += 1
            self.after_restore += restored
            self.tight += tight
            st = self.layers.setdefault(li, [0, 0.0, 0.0])
            st[0] += 1
            st[1] = max(st[1], top)
            st[2] = max(st[2], delta)
            self.last = (q, k_pages, v_pages, pt, ln)
        self.calls += 1
        return out


class HostTimer:
    """Host seconds inside each of the engine's cache calls and attention
    op calls (two ``perf_counter`` reads a call, about a microsecond)."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            return out
        return timed


def serve_phase(torch, seed, device, results):
    import numpy as np
    import repro_torch.serve.engine as SE
    from repro_torch.kernels.paged_attention import kernel as AK
    from repro_torch.kernels.paged_attention import ref as AR
    from repro_torch.serve import PagedLMConfig, Request, ServingEngine
    cfg = PagedLMConfig(**SERVE_MODEL, **SERVE_POOL)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT).tolist()
               for _ in range(SERVE_REQUESTS)]
    steps = SERVE_REQUESTS * (SERVE_PROMPT + SERVE_NEW - 1)
    want_launches = cfg.n_layers * steps
    op = SE.paged_attention

    def serve(instrument: str):
        t0 = time.perf_counter()
        eng = ServingEngine(cfg, seed=seed, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in eng.model.parameters())
        if instrument == "checker":
            hook = AttnChecker(op, eng.caches, SERVE_CHECK_EVERY)
            SE.paged_attention = hook
        else:
            hook = HostTimer()
            SE.paged_attention = hook.wrap("paged_attention", op)
            for c in eng.caches:
                for m in ("append_token", "page_table", "maybe_run_policies",
                          "finish"):
                    setattr(c, m, hook.wrap(m, getattr(c, m)))
        reqs = [Request(req_id=i, prompt=list(p), max_new=SERVE_NEW)
                for i, p in enumerate(prompts)]
        try:
            t1 = time.perf_counter()
            done, counts = launch_window(lambda: eng.run(reqs,
                                                         policy_interval=4))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            combines = AK.paged_attention_combine_launches
        finally:
            SE.paged_attention = op
        report = eng.tier_report()
        tokens = [list(r.generated) for r in done]
        check(all(r.done and len(r.generated) == SERVE_NEW for r in done),
              f"serving: a request did not finish with {SERVE_NEW} tokens")
        check(all(0 <= t < cfg.vocab for ts in tokens for t in ts),
              "serving: a token outside [0, vocab)")
        check(counts == only(paged_attention=want_launches),
              f"ServingEngine.run launched {counts}, expected "
              f"{want_launches} paged_attention")
        check(combines == 0, f"serving: {combines} combine launches; the "
              "path's tables are one split wide")
        check(all(r["restores"] > 0 for r in report),
              f"serving: a layer restored no page: {report}")
        check(all(r["hot_pages"] == 0 for r in report),
              f"serving: hot pages left after finish: {report}")
        del eng, done
        torch.cuda.empty_cache()
        return dict(tokens=tokens, report=report, counts=counts, wall=wall,
                    init_s=init_s, params=n_params, hook=hook)

    a, b = serve("checker"), serve("timer")
    check(a["tokens"] == b["tokens"], "serving: a second run with the same "
          "seed gave other tokens")
    chk = a["hook"]
    check(set(chk.layers) == set(range(cfg.n_layers)), "serving: the "
          f"checker missed layers: {sorted(chk.layers)}")
    check(chk.after_restore > 0, "serving: no call right after a restore "
          "was checked")
    timer = b["hook"]
    weight_bytes = 4 * b["params"]
    weights_bound_s = steps * weight_bytes / HBM_BYTES_PER_S
    restores = [r["restores"] for r in b["report"]]
    per_layer = [chk.layers[i] for i in sorted(chk.layers)]
    for tag, r in (("checked run", a), ("timed run", b)):
        log(f"[serve] {tag} {CARD}: chatglm3-6b widths, {cfg.n_layers} "
            f"layers, {r['params']} f32 parameters drawn on the card in "
            f"{r['init_s']!r} s; {SERVE_REQUESTS} requests x "
            f"({SERVE_PROMPT} prompt + {SERVE_NEW} new) tokens: wall "
            f"{r['wall']!r} s, {steps / r['wall']!r} token-steps/s, "
            f"{SERVE_REQUESTS * SERVE_NEW / r['wall']!r} generated tokens/s, "
            f"{r['wall'] / want_launches * 1e3!r} ms a layer-step; launches "
            f"{json.dumps(r['counts'])}, no combine (one split a table)")
    log(f"[serve] checker: {chk.checked} of {chk.calls} calls held to the "
        f"plain version ({chk.after_restore} right after a restore, every "
        f"layer at least once; {chk.tight} query heads with 4 delta < 1e-3), "
        f"max abs err {chk.max_err!r}; per layer [checks, largest |score|, "
        f"largest delta] {json.dumps(per_layer)}; "
        f"tokens equal across the two runs; restores per layer {restores}; "
        f"first request's tokens {a['tokens'][0][:8]}...")
    # the kernel at this path's shapes (the last checked call's tensors)
    q, kp, vp, pt, ln = chk.last
    # from an idle card, the L2 cache warm, as earlier slices timed it; and
    # the kernel's own device time (torch.profiler, the L2 cache flushed
    # before each call, as the layers' weights flush it between calls)
    call = lambda: AK.paged_attention_cuda(q, kp, vp, pt, ln)  # noqa: E731
    path_ms, _ = cuda_times_ms(call, REPS)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    kern = kernel_device_ms(torch, call, REPS, flush)
    del flush
    seen = [v for k, v in kern.items() if "split_kernel" in k]
    path_kernel_ms = seen[0][0] if len(seen) == 1 and seen[0][1] == 1 \
        else None
    path_plain_ms, _ = cuda_times_ms(lambda: AR.paged_attention_ref(
        q, kp, vp, pt, ln), REPS)
    log(f"[serve] paged_attention at the path's shapes (q {tuple(q.shape)}, "
        f"pool {tuple(kp.shape)}, table {tuple(pt.shape)}, length "
        f"{int(ln[0].item())}): kernel {path_ms!r} ms from an idle card "
        f"(CUDA events); its own device time {path_kernel_ms!r} ms "
        f"(torch.profiler, L2 flushed; None when the trace did not show "
        f"one launch a call: {json.dumps(kern)}); plain {path_plain_ms!r} "
        f"ms from an idle card")
    host = {k: v for k, v in sorted(timer.seconds.items())}
    attn_dev_s = None if path_kernel_ms is None \
        else want_launches * path_kernel_ms / 1e3
    log(f"[serve] timed run, where the {b['wall']!r} s go: host seconds in "
        f"{json.dumps(host)}; paged_attention {want_launches} launches x "
        f"{path_ms!r} ms = {want_launches * path_ms / 1e3!r} s by the "
        f"idle-card time (host launch included), {attn_dev_s!r} s by its "
        f"own device time; reading the weights once per token-step needs "
        f"{weights_bound_s!r} s at {HBM_BYTES_PER_S / 1e12} TB/s "
        f"({weight_bytes} B x {steps} steps)")
    entry = results["paged_attention"]
    entry["launches"] = a["counts"]["paged_attention"]
    entry["launches_by_path"] = {"ServingEngine.run": entry["launches"]}
    entry["path"] = dict(ms=path_ms, kernel_ms=path_kernel_ms,
                         plain_ms=path_plain_ms,
                         checked_calls=chk.checked,
                         checked_after_restore=chk.after_restore,
                         tight_heads=chk.tight, max_abs_err=chk.max_err,
                         per_layer=per_layer)
    entry["serve"] = dict(wall_s=b["wall"], checked_wall_s=a["wall"],
                          token_steps=steps, layer_steps=want_launches,
                          host_s=host, attn_device_s=attn_dev_s,
                          weights_bound_s=weights_bound_s,
                          restores=restores)


def rglru_inputs(torch, shape, seed: int, device):
    """log_a, b (B, S, R) and h0 (B, R) f32 on the card: decays as the
    model draws them (log_a = -8 sigmoid(x) softplus(-4.35), so exp(log_a)
    lies in (0.90, 1)), b and h0 standard normal."""
    B, S, R = shape
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    la = torch.randn(shape, generator=g, device=device).sigmoid_().mul_(
        -8.0 * math.log1p(math.exp(-4.35)))
    b = torch.randn(shape, generator=g, device=device)
    h0 = torch.randn((B, R), generator=g, device=device)
    return la, b, h0


def rglru_agrees(torch, args, out):
    """The kernel's ``out`` against the plain version on the same tensors
    (``RG_TOL``). Returns (ok, max abs err, bit-identical)."""
    from repro_torch.kernels.rglru_scan import ref as RGR
    la, b, h0 = args
    if h0 is None:
        h0 = torch.zeros((la.shape[0], la.shape[2]), device=la.device)
    want = RGR.rglru_ref(la, b, h0)
    if want.numel() == 0:
        return out.shape == want.shape, 0.0, True
    err = float((out - want).abs().max().item())
    return (bool(torch.allclose(out, want, **RG_TOL)), err,
            bool(torch.equal(out, want)))


def rglru_bound_ms(shape, with_h0: bool):
    """log_a and b read once, h written once (h0 read once) over the memory
    rate; or 3 f32 operations (exp, multiply, add) an element over the f32
    peak. Returns (ms, by, bytes, ops)."""
    B, S, R = shape
    nbytes = 4 * (3 * B * S * R + (B * R if with_h0 else 0))
    ops = 3 * B * S * R
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def rwkv_inputs(torch, shape, seed: int, device):
    """r, k, v, w (B, H, hd), u (H, hd) and the state (B, H, hd, hd) f32 on
    the card: decays as the model draws them (w = exp(-exp(-3.9 + x/2)),
    about 0.98), u as its init (0.02 N(0, 1)), the rest standard normal."""
    B, H, hd = shape
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r, k, v = (torch.randn(shape, generator=g, device=device)
               for _ in range(3))
    w = torch.exp(-torch.exp(-3.9 + 0.5 * torch.randn(
        shape, generator=g, device=device)))
    u = 0.02 * torch.randn((H, hd), generator=g, device=device)
    state = torch.randn((B, H, hd, hd), generator=g, device=device)
    return r, k, v, w, u, state


def rwkv_agrees(torch, args, out):
    """The kernel's (y, state) against the plain version on the same
    tensors: y within rtol 1e-5 and atol 1e-5 sum_i |r_i| (|S_ij| + |u_i k_i
    v_j|) (one f32 sum of hd products, in another order), the state within
    ``rtol=atol=1e-6``. Returns (ok, max abs err of y, of the state, state
    bit-identical)."""
    from repro_torch.kernels.rwkv6_step import ref as RWR
    r, k, v, w, u, s = args
    y, s_new = out
    yw, sw = RWR.rwkv6_step_ref(r, k, v, w, u, s)
    kv = k.float()[..., :, None].abs() * v.float()[..., None, :].abs()
    scale = torch.einsum("bhi,bhij->bhj", r.float().abs(),
                         s.abs() + u.float().abs()[None, :, :, None] * kv)
    dy = (y.float() - yw.float()).abs()
    ok_y = bool((dy <= 1e-5 * scale + 1e-5 * yw.float().abs()).all())
    ok_s = bool(torch.allclose(s_new, sw, rtol=1e-6, atol=1e-6))
    return (ok_y and ok_s, float(dy.max().item()),
            float((s_new - sw).abs().max().item()), bool(torch.equal(s_new,
                                                                      sw)))


def rwkv_bound_ms(shape, elt: int = 4):
    """r, k, v, w, u and the state read once, y and the new state written
    once, over the memory rate; or 7 f32 operations per state entry (three
    products, two adds, a fused multiply-add) over the f32 peak."""
    B, H, hd = shape
    nbytes = elt * (5 * B * H * hd + H * hd) + 4 * 2 * B * H * hd * hd
    ops = 7 * B * H * hd * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


GRAPH_CALLS = 64                # kernel calls in one graph (a call's time)


def graph_call_ms(torch, call, n: int = GRAPH_CALLS):
    """The time of one call of ``call()`` launched from a CUDA graph: a
    graph of ``n`` back-to-back calls on fixed inputs, each replay timed
    from an idle card by CUDA events (median of ``REPS``), over ``n``.
    Returns (ms a call, the replays' times in ms)."""
    from repro_torch.kernels import _launches
    graph = torch.cuda.CUDAGraph()
    with _launches.capturing():
        with torch.cuda.graph(graph):
            for _ in range(n):
                call()
    ms, times = cuda_times_ms(graph.replay, REPS)
    del graph
    return ms / n, times


def path_shape_times(torch, name: str, shape, call) -> dict:
    """One recurrent kernel at a serving path's shape: the call's time from
    an idle card (CUDA events, the host's launch through ``ctypes``
    included) beside the kernel's own device time (``torch.profiler``),
    whose difference is the host's share, and the time of a call launched
    from a CUDA graph (no host launch a call)."""
    ms, times = cuda_times_ms(call, REPS)
    kern = kernel_device_ms(torch, call, REPS)
    dev = one_kernel_ms(kern, f"{name}_kernel", f"{name} {shape}")
    graph_ms, replays = graph_call_ms(torch, call)
    log(f"[recurrent] {name} path shape {shape} {CARD}: call {ms!r} ms from "
        f"an idle card (median of {len(times)}, min {min(times)!r}, max "
        f"{max(times)!r}); the kernel's own device time {dev!r} ms "
        f"(torch.profiler, mean of {REPS}); graph-launched {graph_ms!r} ms a "
        f"call (a graph of {GRAPH_CALLS} calls, median of {len(replays)} "
        f"replays from an idle card, min {min(replays) / GRAPH_CALLS!r}, max "
        f"{max(replays) / GRAPH_CALLS!r} a call)")
    return dict(shape=list(shape), ms=ms, device_ms=dev,
                graph_call_ms=graph_ms)


def recurrent_kernel_phase(torch, seed, device, results):
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rglru_scan import ref as RGR
    from repro_torch.kernels.rwkv6_step import kernel as RWK
    from repro_torch.kernels.rwkv6_step import ref as RWR

    # rglru_scan at recurrentgemma-9b's width, then the ragged shapes
    configs = {}
    for i, shape in enumerate((RG_SHAPE,) + RG_RAGGED):
        la, b, h0 = rglru_inputs(torch, shape, seed + 20 + i, device)
        for with_h0 in (True, False):
            args = (la, b, h0 if with_h0 else None)
            got = RGK.rglru_scan_cuda(*args)
            again = RGK.rglru_scan_cuda(*args)
            torch.cuda.synchronize()
            name = f"B{shape[0]} S{shape[1]} R{shape[2]} " + (
                "h0" if with_h0 else "no h0")
            check(bool(torch.isfinite(got).all()), f"rglru_scan {name}: a "
                  "non-finite output")
            check(torch.equal(got, again), f"rglru_scan {name}: the kernel "
                  "differs from run to run")
            ok, err, same = rglru_agrees(torch, args, got)
            check(ok, f"rglru_scan {name}: the kernel differs from the plain "
                  f"version: max abs err {err!r} ({RG_TOL})")
            entry = dict(max_abs_err=err, bit_identical=same)
            if shape == RG_SHAPE and with_h0:
                entry["ms"], times = cuda_times_ms(
                    lambda: RGK.rglru_scan_cuda(*args), REPS)
                entry["plain_ms"], _ = cuda_times_ms(
                    lambda: RGR.rglru_ref(la, b, h0 if with_h0 else
                                          torch.zeros_like(h0)), REPS)
                (entry["bound_ms"], entry["bound_by"], entry["bytes"],
                 entry["ops"]) = rglru_bound_ms(shape, with_h0)
                log(f"[recurrent] rglru_scan {name} {CARD}: kernel "
                    f"{entry['ms']!r} ms (median of {len(times)}, min "
                    f"{min(times)!r}, max {max(times)!r}); plain "
                    f"{entry['plain_ms']!r} ms; bound {entry['bound_ms']!r} "
                    f"ms by {entry['bound_by']} ({entry['bytes']} B, "
                    f"{entry['ops']} f32 ops); "
                    f"{entry['bound_ms'] / entry['ms']:.3f} of the bound; "
                    f"max abs err {err!r}, bit-identical {same}; grid "
                    f"{-(-shape[2] // RGK.threads()) * shape[0]} blocks of "
                    f"{RGK.threads()} threads")
            else:
                log(f"[recurrent] rglru_scan {name}: max abs err {err!r}, "
                    f"bit-identical {same}")
            configs[name] = entry
            del got, again
        del la, b, h0
        torch.cuda.empty_cache()
    main = configs[f"B{RG_SHAPE[0]} S{RG_SHAPE[1]} R{RG_SHAPE[2]} h0"]
    la, b, h0 = rglru_inputs(torch, RG_PATH, seed + 25, device)
    path = path_shape_times(torch, "rglru_scan", RG_PATH,
                            lambda: RGK.rglru_scan_cuda(la, b, h0))
    del la, b, h0
    results["rglru_scan"] = {
        "name": "rglru_scan", "route": "cuda", "source": RG_SOURCE,
        "replaces": TPU_KERNELS["rglru_scan"], "launches": None,
        "max_abs_err": max(c["max_abs_err"] for c in configs.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "error_against": "the plain version on the same tensors",
        "configs": configs, "decode_shape": path}

    # rwkv6_step at rwkv6-1.6b's heads, then hd 16 and B = 1
    configs = {}
    for i, shape in enumerate((RW_SHAPE,) + RW_RAGGED):
        args = rwkv_inputs(torch, shape, seed + 30 + i, device)
        y, s = RWK.rwkv6_step_cuda(*args)
        y2, s2 = RWK.rwkv6_step_cuda(*args)
        torch.cuda.synchronize()
        name = f"B{shape[0]} H{shape[1]} hd{shape[2]}"
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all()),
              f"rwkv6_step {name}: a non-finite output")
        check(torch.equal(y, y2) and torch.equal(s, s2), f"rwkv6_step "
              f"{name}: the kernel differs from run to run")
        ok, err_y, err_s, same = rwkv_agrees(torch, args, (y, s))
        check(ok, f"rwkv6_step {name}: the kernel differs from the plain "
              f"version: max abs err y {err_y!r}, state {err_s!r}")
        entry = dict(max_abs_err=err_y, max_abs_err_state=err_s,
                     state_bit_identical=same)
        if shape == RW_SHAPE:
            entry["ms"], times = cuda_times_ms(
                lambda: RWK.rwkv6_step_cuda(*args), REPS)
            entry["plain_ms"], _ = cuda_times_ms(
                lambda: RWR.rwkv6_step_ref(*args), REPS)
            (entry["bound_ms"], entry["bound_by"], entry["bytes"],
             entry["ops"]) = rwkv_bound_ms(shape)
            log(f"[recurrent] rwkv6_step {name} f32 {CARD}: kernel "
                f"{entry['ms']!r} ms (median of {len(times)}, min "
                f"{min(times)!r}, max {max(times)!r}); plain "
                f"{entry['plain_ms']!r} ms; bound {entry['bound_ms']!r} ms by "
                f"{entry['bound_by']} ({entry['bytes']} B, {entry['ops']} f32 "
                f"ops); {entry['bound_ms'] / entry['ms']:.3f} of the bound; "
                f"max abs err y {err_y!r}, state {err_s!r} (bit-identical "
                f"{same}); grid {shape[0] * shape[1]} blocks of {shape[2]} "
                "threads")
        else:
            log(f"[recurrent] rwkv6_step {name}: max abs err y {err_y!r}, "
                f"state {err_s!r} (bit-identical {same})")
        configs[name] = entry
        del args, y, s, y2, s2
        torch.cuda.empty_cache()
    main = configs[f"B{RW_SHAPE[0]} H{RW_SHAPE[1]} hd{RW_SHAPE[2]}"]
    args = rwkv_inputs(torch, RW_PATH, seed + 35, device)
    path = path_shape_times(torch, "rwkv6_step", RW_PATH,
                            lambda: RWK.rwkv6_step_cuda(*args))
    del args
    results["rwkv6_step"] = {
        "name": "rwkv6_step", "route": "cuda", "source": RW_SOURCE,
        "replaces": TPU_KERNELS["rwkv6_step"], "launches": None,
        "max_abs_err": max(c["max_abs_err"] for c in configs.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "error_against": "the plain version on the same tensors (y; the "
                         "state's error is in configs)",
        "configs": configs, "decode_shape": path}


def profile_steps(torch, step, cache, nxt, pos: int, n: int) -> dict:
    """``n`` decode steps from ``cache`` under ``torch.profiler``: the wall
    seconds, the device seconds of every CUDA operation, their count and
    the five largest by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            nxt, cache = step(cache, nxt, pos + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    return dict(wall_s=wall, device_s=sum(r[1] for r in rows) / 1e6,
                kernels=sum(r[2] for r in rows),
                top=[[k[:60], us, c] for k, us, c in rows[:5]])


class OpChecker:
    """Stands in for a kernel op the model calls. It always returns the
    kernel's result; for the first ``first`` calls (the layers call the op
    in order, so one a layer) and every ``every``-th call after, it also
    runs the plain version on the same device tensors and fails the run on
    a mismatch (``agrees``)."""

    def __init__(self, op, agrees, first: int, every: int):
        self.op, self.agrees = op, agrees
        self.first, self.every = first, every
        self.calls = self.checked = self.bit_identical = 0
        self.max_err = 0.0
        self.shapes = {}            # call shape -> the last args seen

    def __call__(self, *args, **kw):
        import torch
        out = self.op(*args, **kw)
        if self.calls < self.first or self.calls % self.every == 0:
            ok, err, *rest = self.agrees(torch, args, out)
            check(ok, f"{self.op.__name__}: the kernel differs from the "
                  f"plain version at call {self.calls}: max abs err "
                  f"{err!r} {rest}")
            self.max_err = max(self.max_err, err)
            self.bit_identical += bool(rest[-1])
            self.checked += 1
        self.shapes[tuple(args[0].shape)] = args
        self.calls += 1
        return out


class LogitRecorder:
    """Wraps a model's ``prefill`` and ``decode_step`` and keeps the last
    position's logits of each call (B, V), f32 on the card."""

    def __init__(self, model):
        self.model, self.logits = model, []
        self.prefill, self.decode = model.prefill, model.decode_step

    def __enter__(self):
        def prefill(*a, **kw):
            logits, cache = self.prefill(*a, **kw)
            self.logits.append(logits[:, -1].clone())
            return logits, cache

        def decode_step(*a, **kw):
            logits, cache = self.decode(*a, **kw)
            self.logits.append(logits[:, -1].clone())
            return logits, cache
        self.model.prefill, self.model.decode_step = prefill, decode_step
        return self

    def __exit__(self, *exc):
        del self.model.prefill, self.model.decode_step


def recurrent_serve_phase(torch, seed, device, results, arch: str,
                          batch: int, prompt_len: int, new: int,
                          cache_len: int):
    """Serve ``arch`` at full width and depth through ``make_prefill`` and
    a decode step, twice with the same seed: run (a) eagerly through
    ``model.decode_step`` (checked: the op held to its plain version, the
    logits recorded) and, after one forward over prompt plus generated
    tokens for decode consistency, run (b) through the graphed
    ``make_serve_step`` (timed: the same tokens, launches and consistency,
    final caches compared with (a)'s); then a short eager timing and
    profiled steps of both."""
    import repro_torch.kernels.rglru_scan.ops as RGO
    import repro_torch.kernels.rwkv6_step.ops as RWO
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rwkv6_step import kernel as RWK
    from repro_torch.models import Model
    from repro_torch.models.config import MIX_RGLRU, MIX_RWKV6
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.serve.serve_step import (GraphedServeStep,
                                              make_eager_serve_step)
    cfg = get_config(arch)
    if any(s.mix == MIX_RWKV6 for s in cfg.layers):
        name, mod, cuda_op, agrees = ("rwkv6_step", RWO, RWK.rwkv6_step_cuda,
                                      rwkv_agrees)
        n_kind = sum(s.mix == MIX_RWKV6 for s in cfg.layers)
        want_launches = n_kind * (new - 1)     # decode steps only
    else:
        name, mod, cuda_op, agrees = ("rglru_scan", RGO, RGK.rglru_scan_cuda,
                                      rglru_agrees)
        n_kind = sum(s.mix == MIX_RGLRU for s in cfg.layers)
        want_launches = n_kind * new           # prefill and decode steps
    op = getattr(mod, name)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 40)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=device)

    def serve(graphed: bool):
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model = Model(cfg).init(gen, device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        prefill = make_prefill(model, cache_len)
        times = {}
        if graphed:
            step = make_serve_step(model)
            check(isinstance(step, GraphedServeStep), f"{arch}: "
                  "make_serve_step on the card is not the graphed step")
            # warm-up and capture ahead of the launch window, as the
            # reference compiles ahead
            t0 = time.perf_counter()
            step.capture(batch, cache_len)
            torch.cuda.synchronize()
            times["capture_s"] = time.perf_counter() - t0
        else:
            step = make_eager_serve_step(model)
        hook = OpChecker(op, agrees, n_kind, SERVE_CHECK_EVERY)
        rec = LogitRecorder(model)
        toks = torch.empty((batch, new), dtype=torch.int32, device=device)
        # (b)'s logits: the graph's static logits, copied out each step
        logits = torch.empty((new, batch, cfg.vocab), dtype=torch.float32,
                             device=device) if graphed else None

        def run():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            last, cache = prefill(prompt)
            nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            toks[:, :1].copy_(nxt)
            if graphed:
                logits[0].copy_(last)
            for i in range(new - 1):
                nxt, cache = step(cache, nxt, prompt_len + i)
                toks[:, i + 1:i + 2].copy_(nxt)
                if graphed:
                    logits[i + 1].copy_(step.logits)
            torch.cuda.synchronize()
            times["prefill_s"] = t2 - t1
            times["decode_s"] = time.perf_counter() - t2
            times["cache"], times["next"] = cache, nxt
            return toks

        if graphed:
            _, counts = launch_window(run)
        else:
            setattr(mod, name, hook)
            try:
                with rec:
                    _, counts = launch_window(run)
            finally:
                setattr(mod, name, op)
        check(counts == only(**{name: want_launches}),
              f"{arch} serving ({'graphed' if graphed else 'eager'}) "
              f"launched {counts}, expected {want_launches} {name}")
        check(toks.shape == (batch, new) and bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()),
              f"{arch} serving: tokens outside [0, vocab) or of shape "
              f"{tuple(toks.shape)}")
        peak = torch.cuda.max_memory_allocated(device)
        return dict(model=model, step=step, tokens=toks, counts=counts,
                    hook=hook, logits=logits if graphed else rec.logits,
                    init_s=init_s, params=n_params, param_bytes=param_bytes,
                    peak_bytes=peak, **times)

    a = serve(graphed=False)
    model = a.pop("model")
    a.pop("step")
    # decode consistency: one forward over the prompt and the generated
    # tokens, against the served logits (the last token's are not served;
    # it keeps rwkv6's prefill chunks at 64 for 512 + 64 tokens)
    seq = torch.cat([prompt, a["tokens"].long()], dim=1)
    n_seq = seq.shape[1]
    full, _, _ = model(seq)
    scale = float(torch.maximum(full.amax(), -full.amin()).item()) + 1e-6
    served = slice(prompt_len - 1, prompt_len - 1 + new)
    want = full[:, served].clone()                 # (B, new, V)
    errs = [float((lg - want[:, i]).abs().max().item())
            for i, lg in enumerate(a["logits"])]
    # the rounding floor: the same forward for the first prompt alone (other
    # matrix shapes, so other bf16 roundings), at the served positions
    one, _, _ = model(seq[:1])
    floor = float((one[0, served] - full[0, served]).abs().max().item())
    del one
    check(len(errs) == new, f"{arch}: recorded {len(errs)} logits, "
          f"expected {new}")
    bound = 0.05 * scale + 0.05
    check(max(errs) < bound, f"{arch}: decode consistency failed: max err "
          f"{max(errs)!r} >= {bound!r} (scale {scale!r}); per position "
          f"{errs}")
    del full, model, seq
    a["logits"] = None
    torch.cuda.empty_cache()
    b = serve(graphed=True)
    model = b.pop("model")
    step = b.pop("step")
    check(torch.equal(a["tokens"], b["tokens"]), f"{arch}: the graphed run "
          "gave other tokens than the eager run with the same seed")
    errs_b = [float((b["logits"][i] - want[:, i]).abs().max().item())
              for i in range(new)]
    check(max(errs_b) < bound, f"{arch}: the graphed run's decode "
          f"consistency failed: max err {max(errs_b)!r} >= {bound!r}; per "
          f"position {errs_b}")
    states_equal = {}
    for ca, cb in zip(a.pop("cache"), b["cache"]):
        for key in ca:
            states_equal[key] = states_equal.get(key, True) and bool(
                torch.equal(ca[key], cb[key]))
    del want
    b["logits"] = None
    chk = a["hook"]
    check(chk.checked >= n_kind, f"{arch}: the checker held only "
          f"{chk.checked} calls, fewer than the {n_kind} layers")
    # the kernel at this path's shapes
    path_ms = {}
    for shape, args in sorted(chk.shapes.items()):
        path_ms[str(shape)], _ = cuda_times_ms(lambda: cuda_op(*(
            x.contiguous() if x is not None else None for x in args)), REPS)
    if name == "rglru_scan":
        step_ms = path_ms[str((batch, 1, cfg.rnn_width))]
        prefill_ms = path_ms[str((batch, prompt_len, cfg.rnn_width))]
        dev_s = (n_kind * prefill_ms + n_kind * (new - 1) * step_ms) / 1e3
    else:
        step_ms = path_ms[str((batch, cfg.n_heads, cfg.head_dim))]
        dev_s = want_launches * step_ms / 1e3
    weights_ms = b["param_bytes"] / HBM_BYTES_PER_S * 1e3
    decode_ms = b["decode_s"] / (new - 1) * 1e3
    # eager decode on the same model, from a copy of (b)'s final cache
    pos = prompt_len + new - 1
    eager = make_eager_serve_step(model)
    cache_e = [{k: t.clone() for k, t in cb.items()} for cb in b["cache"]]
    nxt_e, cache_e = eager(cache_e, b["next"].clone(), pos)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(EAGER_STEPS):
        nxt_e, cache_e = eager(cache_e, nxt_e, pos + 1 + i)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / EAGER_STEPS * 1e3
    # a few more steps of each under the profiler: the card's busy time
    prof = {"graphed": profile_steps(torch, step, b.pop("cache"),
                                     b.pop("next"), pos, PROFILED_STEPS),
            "eager": profile_steps(torch, eager, cache_e, nxt_e,
                                   pos + 1 + EAGER_STEPS, PROFILED_STEPS)}
    del cache_e, nxt_e
    step_time = {"graphed": decode_ms, "eager": eager_ms}
    busy = {}
    for kind, pr in prof.items():
        if pr["device_s"] > 0:
            busy[kind] = pr["device_s"] / PROFILED_STEPS / (
                step_time[kind] / 1e3)
            log(f"[{arch}] profiled {PROFILED_STEPS} {kind} decode steps "
                f"(torch.profiler): {pr['kernels']} device operations, "
                f"{pr['device_s'] / PROFILED_STEPS * 1e3!r} ms of device "
                f"time a step against the {kind} timing's "
                f"{step_time[kind]!r} ms a step: the card is busy "
                f"{busy[kind]:.3f} of a step (profiled wall "
                f"{pr['wall_s'] / PROFILED_STEPS * 1e3!r} ms a step); top by "
                f"device time (us) {json.dumps(pr['top'])}")
        else:
            busy[kind] = None
            log(f"[{arch}] profiled {PROFILED_STEPS} {kind} decode steps: "
                "the profiler saw no device time; the busy share is not "
                "measured")
    for tag, r in (("checked run (a), eager", a),
                   ("timed run (b), graphed", b)):
        wall = r["prefill_s"] + r["decode_s"]
        log(f"[{arch}] {tag} {CARD}: {cfg.n_layers} layers, d "
            f"{cfg.d_model}, {r['params']} parameters ({r['param_bytes']} B) "
            f"drawn on the card in {r['init_s']!r} s; {batch} prompts x "
            f"({prompt_len} + {new} new) tokens: prefill {r['prefill_s']!r} "
            f"s, decode {r['decode_s'] / (new - 1) * 1e3!r} ms a step "
            f"({new - 1} steps), {batch * new / wall!r} generated tokens/s, "
            f"{batch * (new - 1) / r['decode_s']!r} decode tokens/s; peak "
            f"memory {r['peak_bytes']} B; launches {json.dumps(r['counts'])}"
            + (f"; warm-up and capture {r['capture_s']!r} s before the run"
               if "capture_s" in r else ""))
    ops_a_step = {kind: pr["kernels"] / PROFILED_STEPS
                  for kind, pr in prof.items()}
    log(f"[{arch}] decode a step {CARD}: eager {eager_ms!r} ms "
        f"({EAGER_STEPS} steps after the graphed run), busy "
        f"{busy['eager']!r}, {ops_a_step['eager']!r} device operations a "
        f"step; graphed {decode_ms!r} ms ({new - 1} steps of run (b)), busy "
        f"{busy['graphed']!r}, {ops_a_step['graphed']!r} device operations "
        f"a step; {eager_ms / decode_ms:.2f}x")
    log(f"[{arch}] checker: {chk.checked} of {chk.calls} {name} calls held to "
        f"the plain version (the first of every layer, then every "
        f"{SERVE_CHECK_EVERY}th), {chk.bit_identical} bit-identical, max abs "
        f"err {chk.max_err!r}; decode consistency against one forward over "
        f"{n_seq} tokens: eager max err {max(errs)!r}, graphed "
        f"{max(errs_b)!r} < {bound!r} (scale {scale!r}; prefill "
        f"{errs[0]!r}, last step {errs[-1]!r}, largest at step "
        f"{errs.index(max(errs))}); the same forward for the first prompt "
        f"alone differs from the batched one by {floor!r} at the served "
        f"positions (the bf16 rounding floor); tokens equal across the two "
        f"runs; final caches of (b) equal to (a)'s bit for bit: "
        f"{json.dumps(states_equal)}; first prompt's tokens "
        f"{b['tokens'][0, :8].tolist()}...")
    log(f"[{arch}] {name} at the path's shapes {json.dumps(path_ms)} ms; on "
        f"the card about {dev_s!r} s of the timed run's "
        f"{b['prefill_s'] + b['decode_s']!r} s; a decode step {decode_ms!r} "
        f"ms against reading the weights once, {weights_ms!r} ms at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s; {name} {step_ms!r} ms a layer-step "
        f"x {n_kind} layers = {n_kind * step_ms!r} ms a step (eager calls)")
    entry = results[name]
    entry["launches"] = b["counts"][name]
    entry["launches_by_path"] = {
        f"{arch} serving (make_prefill + {new - 1} graphed make_serve_step)":
            entry["launches"],
        f"{arch} serving (make_prefill + {new - 1} eager decode_step, "
        "checked)": a["counts"][name]}
    entry["path"] = dict(ms=path_ms, checked_calls=chk.checked,
                         calls=chk.calls, max_abs_err=chk.max_err,
                         bit_identical=chk.bit_identical)
    entry["serve"] = dict(arch=arch, batch=batch, prompt=prompt_len,
                          new=new, prefill_s=b["prefill_s"],
                          decode_ms_a_step=decode_ms,
                          eager_decode_ms_a_step=eager_ms,
                          capture_s=b["capture_s"],
                          tokens_per_s=batch * new / (b["prefill_s"]
                                                      + b["decode_s"]),
                          kernel_device_s=dev_s,
                          weights_read_ms=weights_ms,
                          decode_consistency_err=max(errs),
                          graphed_decode_consistency_err=max(errs_b),
                          decode_consistency_bound=bound,
                          rounding_floor=floor, device_busy_share=busy,
                          device_ops_a_step=ops_a_step,
                          final_cache_bit_equal=states_equal,
                          peak_bytes=b["peak_bytes"])
    del model, step, a, b
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: run "
             "it from a checkout of the repository")
    sys.path.insert(0, SRC)
    from repro_torch import resolve_device
    from repro_torch.kernels.policy_scan import kernel as K
    from repro_torch.kernels.paged_attention import kernel as AK
    from repro_torch.kernels.profile_cube import kernel as PK
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rwkv6_step import kernel as RWK
    global CARD

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = CARD = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    device = resolve_device("cuda")
    # full f32 in every f32 product (the models' gates and readouts)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per library, started together
    def timed_build(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=6) as pool:
        first_fut = pool.submit(timed_build, build_first_scan)
        builds = list(pool.map(timed_build, (K.build, PK.build, AK.build,
                                             RGK.build, RWK.build)))
        (first, first_ptxas), first_secs = first_fut.result()
    for lib, secs in builds:
        log(f"[build] {os.path.relpath(lib, ROOT)} in {secs:.2f} s")
    log(f"[build] the first policy_scan design (tools/policy_scan_designs.cu"
        f" v0) in {first_secs:.2f} s: {json.dumps(first_ptxas)}")

    # 3.-4. kernels at device scale, 5. the engine's main path, 6. reports,
    # 7. paged attention and 8. the recurrent kernels at device scale,
    # 9. paged serving, 10. recurrent-model serving
    results: dict = {}
    kernel_phase(torch, args.seed, device, results, first)
    cube_phase(torch, args.seed, device, results)
    attn_phase(torch, args.seed, device, results)
    recurrent_kernel_phase(torch, args.seed, device, results)
    t0 = time.perf_counter()
    cat = build_catalog(ENTRIES, args.seed)
    log(f"[engine] catalog of {len(cat)} entries built in "
        f"{time.perf_counter() - t0:.2f} s")
    engine_phase(torch, cat, device, results)
    reports_phase(torch, cat, device, results)
    del cat
    serve_phase(torch, args.seed, device, results)
    for arch, batch, prompt_len, new, cache_len in RECURRENT_SERVE:
        recurrent_serve_phase(torch, args.seed, device, results, arch, batch,
                              prompt_len, new, cache_len)
    check(sorted(results) == sorted(TPU_KERNELS), f"kernels {sorted(results)}"
          f" are not those of {sorted(TPU_KERNELS)}")
    for r in results.values():
        check(r["launches"] is not None and r["launches"] > 0,
              f"{r['name']} was not launched on the main path")
    log(json.dumps({"card": card, "kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
