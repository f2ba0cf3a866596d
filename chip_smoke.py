#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed S]

Phases, each of which ends the run with a non-zero exit at its first
failure:

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions;
2. build: the ``policy_scan``, ``profile_cube``, ``paged_attention``,
   ``rglru_scan``, ``rwkv6_step`` and ``decode_attention`` libraries from
   their ``csrc/``, the first ``policy_scan`` design (``v0`` of
   ``tools/policy_scan_designs.cu``) and the first ``rglru_scan`` design
   (``tools/rglru_scan_designs.cu``, through ``tools/rglru_variants.py``
   with ``-Xptxas -v``: registers, spills, shared memory), one ``nvcc``
   each, started together, with each build time;
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
4. the store form at device scale (after the kernel phase, on its rows):
   the 2^27 rows laid out as the column store holds them, 8 shard groups
   of 2^24 rows, ``(8, 17, 2^24)`` (9.13 GB more, freed after), and
   ``policy_scan_store_cuda`` run on ``BATCH_CRITERIA`` with aggregates
   and lean: mask 0 and the rule index identical to the plain version run
   one group at a time and to the 2-D kernel over the same rows, the
   aggregate counts equal to the 2-D kernel's and the sums within
   ``TOL``, bit for bit on a second call; each form timed from an idle
   card beside its scan kernel's device time (``torch.profiler``), its
   bound (the columns ``launch_shape`` stages, read once, and mask 0 and
   the rule index written once), its grid, and the 2-D kernel's time,
   taken in turns (2-D, aggregates, lean, lean, aggregates, 2-D);
5. profile cube at device scale, columns generated on the card from a
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
6. engine: a 2^20-entry catalog, one policy (scope, two rules, LRU sort,
   a recording batch action) run through ``PolicyEngine.run`` with
   ``evaluator="policy_scan"`` on the card and with ``evaluator="numpy"``:
   the actioned (fid, rule params) sequences must be identical, with and
   without budgets, and the run must have launched the batch kernel once;
   the batch kernel is held to its plain version on the policy's programs
   and this catalog's column stack; then ``scan_catalog`` must launch the
   single-program kernel once and ``match_programs(single_launch=False)``
   once per program, each path counted on its own, and both must agree
   with the batch path;
7. the store engine (after the engine phase, on its catalog):
   ``DeviceColumnStore(cat, groups=4, device="cuda")`` attached to a
   ``PolicyEngine`` (one group a shard). The cold
   ``run(evaluator="policy_scan_mesh")`` must make 4 full uploads; with
   and without budgets its actioned (fid, rule params) sequence must equal
   ``numpy``'s and ``policy_scan``'s, its window must show exactly one
   lean store-form launch and no 2-D launch, and its report must name
   ``policy_scan_mesh`` with no fallback. After the cold run the store
   form, both ways, over the engine's resident ``(4, 17, Rp)`` tensor
   with the run's programs must give mask 0 and the rule index identical
   to its plain version on the same tensor, aggregates within TOL. Then
   three warm rounds, each
   changing 1% of the entries in place (10,486 distinct fids, as
   ``benchmarks/bench_policy.py``'s churn): 0 full uploads, exactly the
   changed rows scattered, ``Catalog.arrays`` not called, actions equal to
   a ``numpy`` run of a twin engine; the warm run's ``run``,
   ``run.match``, ``store.refresh`` and ``store.match`` spans are logged
   beside a ``policy_scan`` run's on the same state. Then 1000 removes
   and 1000 inserts in one shard must re-upload its group alone, and
   ``scan_catalog(store=)`` must launch the store form with aggregates
   once and agree with the 2-D ``scan_catalog``;
8. store reports (after the store engine, on its catalog): a fresh
   ``DeviceColumnStore(cat, groups=4)`` with ``Reports`` and
   ``ProfileCube`` attached to it, held to the host folds: two kernel
   ``find`` predicates (each exactly one lean store-form launch) and a
   glob that must fall back, ``top_files`` by size and atime (k = 10,
   both orders), ``du`` of ``/fs``, ``/fs/d3`` and a missing prefix, and
   the cube (a cold one is exactly 4 ``profile_cube`` launches). Paths,
   orders and counts identical, du's sums equal, cube counts equal and
   sums within ``rtol=1e-5``. Then a warm round (1% in-place churn, 30
   days later): 0 full uploads, exactly the changed rows scattered, no
   cube rebuild and no ``profile_cube`` launch (the signed scatter-adds
   and the age rollovers serve), ``Catalog.arrays`` flat across the store
   queries; and a rename round (5 paths of one shard: its group alone
   re-uploads). The query walls are logged, store against host. Then the
   permissions plane (``store_scoped_phase``): an eighth of the entries
   moved to group g1, a fresh 4-group store with ``Reports`` and
   ``ProfileCube`` under a ``GrantTable`` of five subjects (one uid, one
   gid, two subtrees, a mixed one, one that sees nothing); for each, two
   scoped ``find`` (each exactly one lean scoped store-form launch), a
   scoped ``store.scan`` (one scoped launch with aggregates), ``top_files``,
   ``du`` of three prefixes and the scoped cube (one scoped
   ``profile_cube`` launch a group) with four reports from it, all equal
   to the grant-filtered host folds; cold (one materialization a group),
   warm (1% in-place churn moving owners to u3 and groups to g1: 0 full
   uploads, 0 materializations, word scatters, ``Catalog.arrays`` flat)
   and after a ``GrantTable`` change (a subtree granted, a sixth subject:
   one materialization a group, no word scatter); warm scoped and
   unscoped ``find`` / ``top_files`` walls in turns. Then tiered
   residency (``store_tiered_phase``): (a) on the same catalog a 4-group
   store under ``hbm_budget_rows = 2·Rp + 2·D·Rw`` (Rp from the largest
   group, the default 32-tile window slot), so 2 groups stay resident and
   2 stream, with ``Reports`` and ``ProfileCube`` attached and two of the
   subjects; cold, three rounds of 1% in-place churn on one demoted group
   (it must promote and another demote), a round with ``demote_async``
   and ``drain_demotions()``, and 1000 removes and 1000 inserts in one
   shard; every round a ``policy_scan_mesh`` run actioning numpy's
   (fid, rule params) sequence in ``1 + windows streamed`` lean store-form
   launches, ``find`` (one lean launch a window beside the resident one),
   ``top_files`` both ways, three ``du`` and the cube (unscoped: no
   streaming; scoped: one scoped ``profile_cube`` launch a resident group
   and a window), unscoped and scoped, equal to an unbudgeted store and
   to the (grant-filtered) host folds, the cube's reports too; the
   tensor holding exactly the resident groups, within the row budget,
   and a streamed scoped ``find`` drawing no more device memory than its
   two windows and outputs; (b) ``benchmarks/bench_tiering.py``'s full
   setting (2,000,000 entries, 16 shards, budget 200,000) at 8 groups,
   every group streamed: the streamed scan's fids identical to an
   unbudgeted store's and the host mask's, count, size profile and
   ``any_match`` equal, one store-form launch a window; streamed and
   resident scans timed in turns, with the stage / copy / launch spans,
   the stalls and the achieved host-to-device rate beside a pinned 256 MB
   copy's. Then at
   device scale, the store's ``(8, 21, 2^24)`` layout (11.27 GB, drawn on
   the card: ``ord`` a permutation a group, 6,000 profile groups, so a
   cube capacity of 7,504): (i) the store form on ``BATCH_CRITERIA``,
   both ways, identical to the 17-row layout of the same rows and timed
   in turns with it; (i-s) with an ``(8, 8, 2^19)`` permissions plane
   (134 MB), the scoped store form both ways for a subject that sees half
   the rows (identical to the plain version), one that sees all
   (identical to the unscoped form) and one that sees none (empty), timed
   in turns with the unscoped form; (ii) ``mesh_profile_cube``, 8
   launches, counts equal to the plain version and sums to the f64 plain
   version; (ii-s) ``mesh_scoped_cube``, 8 scoped launches, equal to the
   f64 plain version with the validity masked, timed in turns with (ii);
   (iii) the two-pass top-k on size against a ``torch.sort`` of the
   filtered column; (iv) ``mesh_range_aggregate`` on random rank bounds
   against the same sums from a ``torch.sort`` of ``ord``; each timed
   beside the rows it reads over the memory rate;
9. collect (the paper's headline scenario, ``tests/test_system.py``): a
   ``LustreSim`` under load mirrored by a ``Scanner`` and two
   ``EventPipeline``s, ``HsmCoordinator`` policies run through
   ``policy_scan_mesh`` over a ``DeviceColumnStore`` on the card: the
   archive policy's matches equal ``numpy``'s, the archive pass is one
   lean store-form launch, and after the watermark purges every OST is
   under the high watermark;
10. reports on the same catalog: ``ProfileCube(use_kernel=True).attach()``
   on the card must launch ``profile_cube`` once per shard (4) and give
   the cube of the exact int64 host groupby (counts equal, volume and
   spc_used within ``rtol=1e-5``), and ``Reports`` over the two cubes must
   answer every ``rbh-report`` query alike; the kernel is held to its
   plain version on each shard's columns; after a few thousand changed
   entries go through the catalog's delta hooks, the kernel-built cube's
   counts must equal a fresh host rebuild's;
11. paged attention at device scale (after the cube phase): 64 sequences
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
12. recurrent kernels at device scale (after the attention phase), seeded
    inputs drawn on the card with the models' decay distributions:
    ``rglru_scan`` at recurrentgemma-9b's width (B 8, S 4096, R 4096, f32,
    1.6 GB), at S 1, S 2016, R 100 and the training path's (2, 2560,
    4096), each with and without ``h0``, equal to its plain version bit for
    bit (``torch.equal``), and at (2, 2560, 4096), (4, 2016, 4096) and
    (8, 4096, 4096) timed in turns with the first design (both launched
    through their C entry points, each equal to the plain version), its
    decode step too, graph-launched; ``rwkv6_step`` at
    rwkv6-1.6b's heads (B 256, H 32, hd 64: a 134 MB state), at hd 16 and
    at B 1, y within rtol 1e-5 and atol 1e-5 sum_i |r_i| (|S_ij| +
    |u_i k_i v_j|), the state within ``rtol=atol=1e-6``; both must repeat
    bit for bit and are timed beside their bound and plain version (no
    single PyTorch call computes either), and at the serving paths' decode
    shapes beside the kernels' own device times and the time of a call
    launched from a CUDA graph (a graph of 64 calls, replayed from an idle
    card, over 64); then ``decode_attention`` (the port's own kernel, no
    TPU counterpart) at portbench's mixtral-decode shape (B 64, a 512-slot
    ring under a 4,096 window, 8 KV heads, G 6, hd 128, bf16) at positions
    255, 383 and 511, and at one sequence of 8,192 positions (its splits
    and combine): bit for bit twice, within one bf16 step of the plain
    version, timed from an idle card with the L2 cache flushed beside its
    bound (the valid K/V rows read once), its kernels' own device times,
    the plain version, ``scaled_dot_product_attention(enable_gqa=True)``
    (the library's yardstick, never called by the port), graph-launched,
    with its registers and spills;
13. paged serving: ``ServingEngine`` at chatglm3-6b's full width and depth
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
14. recurrent-model serving, one model after the other, each at
    full width and depth with parameters drawn on the card from the seed,
    through ``make_prefill`` and a decode step: rwkv6-1.6b, 8 prompts of
    512 seeded tokens and 64 new (exactly 24 x 63 = 1,512 ``rwkv6_step``
    launches: prefill runs the plain chunked form), and recurrentgemma-9b,
    4 prompts of 2016 tokens and 64 new with ``cache_len`` 2080, so the
    2048-slot local-attention ring wraps (exactly 26 x 64 = 1,664
    ``rglru_scan`` launches: prefill and every step; and 12 x 63 = 756
    ``decode_attention`` launches, one a local-attention layer a step).
    Run (a) decodes
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
    ``torch.profiler`` for the device operations a step and the largest of
    them, eager and graphed side by side;
15. training, three parts, each logged as ``[train]`` lines: (a)
    the ``rglru_scan`` gradient kernel at the training path's shape
    (2, 2560, 4096) and at (8, 4096, 4096), with and without ``h0``:
    dlog_a, db and dh0 equal to ``rglru_bwd_ref`` on the card
    (``torch.equal``) on two calls, the forward at the same shapes equal
    to ``rglru_ref``, timed from an idle card beside its bound and the
    plain version, and in turns with the first design; (b)
    recurrentgemma-9b at its published widths cut to 5 layers (one (rec,
    rec, local) superblock and 2 tail recurrent layers, 2.17 B
    parameters) trained 8 steps through ``launch.train.run``
    (``DataPipeline`` of 4 x 2560 tokens in 2 microbatches,
    ``cosine_warmup(3e-4, 1, 8)``, weight decay 0.01): every loss finite,
    the mean of the last three below the first, exactly 16 forward and 8
    gradient launches a step (4 recurrent layers x 2 microbatches, the
    forward again in the remat recompute) and no other kernel; the step
    wall, tokens/s, peak memory and, from one more step under
    ``torch.profiler``, the kernels' share of the card's time; (c)
    ``tests/test_system.py``'s restart scenario with recurrentgemma-9b
    smoke on the card (40 steps, a ``SimulatedFailure`` at 17,
    checkpoints every 10, ``keep_last=2``): one restart, the mean of the
    last 5 losses below the first 5, checkpoints retained, exact launches
    (the replayed steps included), the artifact catalog's usage logged,
    and the first 5 steps run again on the CPU from the same weights
    within 1e-2 of the card's losses;
16. distribution (``[dist]``): (b)'s state (full width, 5 layers) on a
    1x1 ``DeviceMesh`` of a one-rank NCCL group: 2 steps unsharded from a
    host copy of the state, then the same 2 steps from the same state
    laid out by ``state_shardings`` / ``reshard_state`` through
    ``make_train_step(grad_pspecs=opt_state_pspecs)``, deterministic
    algorithms on in both: losses and parameters equal bit for bit,
    exactly 16 forward and 8 gradient ``rglru_scan`` launches a step in
    the mesh's window; the int8 error-feedback all-reduce over the mesh's
    "data" axis on one microbatch's f32 gradients (``q`` within [-127,
    127], the result equal to ``decompress(compress(g))`` bit for bit,
    ``g_mean + new_err`` within one f32 rounding of each term of ``g +
    err``; timed, its largest tensor again warm beside its bound); the
    laid-out state saved by ``CheckpointManager`` and restored with
    ``shardings=``, every leaf equal bit for bit; partitioned serving on
    the same mesh: (b)'s recurrentgemma-9b (parameters laid out by
    ``param_pspecs``, the model's own tensors released) and rwkv6-1.6b at
    full width and depth, drawn from the seed, each through the
    partitioned ``make_prefill`` and 16 graphed steps of the partitioned
    ``make_serve_step`` against the same steps unpartitioned on the same
    parameters: logits, tokens and final caches equal bit for bit,
    exactly one ``rglru_scan`` launch a recurrent layer in the prefill
    and in each step (``rwkv6_step``: one a layer a step), every kernel
    call given plain tensors of the unpartitioned shapes; and the dry run
    of recurrentgemma-9b at ``train_4k`` and ``decode_32k`` on the 16x16
    production mesh, run on the CPU in a process of its own from before
    the builds (PyTorch's fake process group, fake tensors): the decode
    cell partitioned (collectives over "model", the model's own tensors
    released, the cache one device's shard within 1%, the state the
    shards ``param_pspecs`` gives rank 0), their per-device FLOPs, bytes,
    peak memory, collectives and roofline terms printed beside the card's
    name as data-sheet estimates;
17. the rest of the model zoo served (``[zoo-serve]``), one config after
    the other at published widths, parameters drawn on the card from the
    seed, every cross-attention gate set to 1.0 (drawn 0), MoE capacity
    dropless (E / k, as the reference's decode-consistency test): mixtral
    8x22b cut to 4 of 56 layers, 2 prompts of 4,160 tokens + 32 new (the
    4,096-slot ring wraps); llama4-maverick cut to 2 of 48 layers (one
    dense and one MoE layer), 2 x (512 + 32); llama3.2-vision-11b at its
    40 layers, 2 x (512 + 32) with (2, 1,600, 4,096) bf16 image tokens,
    then the same with ``kv_cache_dtype="int8"``; whisper-large-v3 at its
    32 + 32 layers, 4 x (64 + 64) with (4, 1,500, 1,280) bf16 frames.
    Each through ``make_prefill`` (with its ``extras``) and a decode step:
    run (a) eager, its logits within ``0.05 * scale + 0.05`` of one
    forward over prompt and generated tokens; run (b) the graphed
    ``make_serve_step``, timed: (a)'s tokens, (a)'s final caches bit for
    bit, its logits within the same bound; each launches
    ``decode_attention`` once an attention layer a decode step (and its
    combine where the shapes split) and no other repo kernel. The int8
    cache is also decoded teacher-forced over the bf16 run's tokens, its
    logits within the bound of that run's, and its K bytes a
    (token, head) printed against the bf16 cache's. Each prints decode ms
    a step eager and graphed, prefill seconds, peak memory and parameter
    bytes;
18. the rest of the model zoo trained (``[zoo-train]``):
    ``make_train_step`` with AdamW (lr 3e-4, weight decay 0.01), accum 2,
    the same batch (next-token labels) for 4 steps: whisper-large-v3 at
    its published width and depth, microbatch 2 x 448 tokens with (2,
    1,500, 1,280) frames; mixtral-8x22b at its published width cut to 1
    layer (2.9 B parameters), microbatch 1 x 2,048 at its published
    capacity factor 1.25. Every loss finite, the last below the first,
    mixtral's aux loss nonzero, no repo kernel launched; step walls,
    tokens/s and peak memory printed.

19. the examples (``[examples]``): each ``examples/torch_*.py`` loaded by
    path and its ``main(device=...)`` run in this process, once on the
    card and once on the CPU (the plain versions), stdout captured and the
    launch counts read around the card run.
    ``torch_quickstart``, ``torch_lustre_sim_hsm`` and
    ``torch_fs_profiles`` print on the card what they print on the CPU,
    line for line (wall times and temporary directory names masked), and
    launch no repo kernel: ``fs_profiles`` builds its cube with the exact
    int64 host groupby, as the reference's example does. The example's
    catalog is then rebuilt into a ``ProfileCube(use_kernel=True)`` on the
    card: one ``profile_cube`` launch a shard (4), each launch's cube
    equal to the f64 plain version cast to f32, the counts equal to the
    host cube's. ``torch_fs_top`` (2 frames) prints what the CPU run
    prints but for its rates and latencies, and its sweeps match what the
    CPU's match, with a lean store-form ``policy_scan`` launch a frame at
    least. ``torch_serve_kv_tiering`` on the card and on the CPU with the
    card's weights (the two generators draw differently): equal tokens
    and tier reports, ``paged_attention`` launched n_layers times a
    token step, the logits' largest difference printed.
    ``torch_train_lm`` at its 200 steps on the card (20 on the CPU, for
    the wall): every loss finite, the checkpoints ``--ckpt-interval 50``
    keeps, the first-10 and last-10 losses printed. One ``[examples]``
    line: the card, each example's wall on the card and the CPU, the
    launches; each kernel's entry gains ``examples_launches``.

The zoo phases' records go on a ``[zoo]`` line; the line before the last
is a JSON object with one entry per kernel; the last line is ``{"ok":
true, "device": {...}}``. Without CUDA, or without the repository beside
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import atexit
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
STORE_GROUPS = 8                # store kernel phase: ROWS in 8 groups
STORE_ENGINE_GROUPS = 4         # store engine phase: one group a shard
SCALE_ROWS = 1 << 24            # store reports phase: rows a group (the
                                # f32 envelope edge of the ord row)
SCALE_CUBE_GROUPS = 6000        # store reports phase: distinct profile
                                # groups (capacity 7,504 past the cap 4096)
CHURN = 0.01                    # store engine phase: entries changed a round
ENTRIES = 1 << 20               # engine phase: catalog entries
REPS = 10                       # timed calls per kernel and plain version
L2_FLUSH_BYTES = 256 << 20      # written before each timed attention call
CUBE_GROUPS = 4096              # cell (a): the profile_cube op's cap
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
DA_SOURCE = ("src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu")
# decode_attention at portbench's mixtral-decode shape (mixtral-8x22b-8L
# under batch-b64-p256-g256): 64 sequences, a 512-slot ring under a 4,096
# window, 8 KV heads, G 6, head_dim 128, bf16, at positions a batch's decode
# reaches; then one sequence of 8,192 positions (the splits and the combine)
DA_SHAPE = (64, 512, 8, 6, 128)          # B, L, K, G, hd
DA_POSITIONS = (255, 383, 511)
DA_WINDOW = 4096
DA_LONG = (1, 8192, 8, 6, 128)
RW_SOURCE = "src/repro_torch/kernels/rwkv6_step/csrc/rwkv6_step.cu"
# recurrent kernels: rglru_scan (B, S, R) at recurrentgemma-9b's d_rnn and
# the ragged shapes (a decode step, its prefill length, an odd width);
# rwkv6_step (B, H, hd) at rwkv6-1.6b's heads, hd 16 and B = 1
RG_SHAPE = (8, 4096, 4096)
RG_RAGGED = ((8, 1, 4096), (4, 2016, 4096), (8, 4096, 100))
RG_TRAIN = (2, 2560, 4096)      # the training path's forward and gradient
# forward shapes timed in turns with the first design: training, serving
# prefill, the kernel phase's
RG_TURN_SHAPES = (RG_TRAIN, (4, 2016, 4096), RG_SHAPE)
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
# the rest of the model zoo at published widths (src/repro/configs/), depth
# cut where one card cannot hold the model: arch, layers (None: published),
# prompts, prompt tokens, new tokens, int8 KV cache. mixtral's 4160-token
# prompt wraps its 4096-slot ring; the int8 row follows the bf16 row before
# it (its logits are held to that run's)
ZOO_SERVE = (("mixtral_8x22b", 4, 2, 4160, 32, False),
             ("llama4_maverick_400b_a17b", 2, 2, 512, 32, False),
             ("llama3p2_vision_11b", None, 2, 512, 32, False),
             ("llama3p2_vision_11b", None, 2, 512, 32, True),
             ("whisper_large_v3", None, 4, 64, 64, False))
ZOO_GATE = 1.0                  # every cross-attention gate (drawn 0)
ZOO_EXTRAS_STD = 0.1            # image tokens and encoder frames, N(0, 0.1)
# training: arch, layers, microbatch, tokens; accum 2, the same batch
# every step, mixtral at its published capacity factor (1.25)
ZOO_TRAIN = (("whisper_large_v3", None, 2, 448),
             ("mixtral_8x22b", 1, 1, 2048))
ZOO_TRAIN_STEPS = 4
ZOO_TRAIN_ACCUM = 2
ZOO_TRAIN_LR = 3e-4


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
    launches a call). Every caller's ``fn`` launches each of its kernels a
    whole number of times a call, but a trace can lose kernel records (H100
    runs showed 7-9 of 10 launches of one kernel, 78 of 80 of another, with
    every output checked and every launch counted), so launches a call is
    the trace's count over ``reps`` rounded to a whole number, and the mean
    time of a launch is taken over the records the trace kept."""
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
    return {k: (us / count / 1e3, max(1, round(count / reps)))
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


def rglru_variants():
    """``tools/rglru_variants.py`` as a module."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import rglru_variants as rv
    return rv


def build_first_rglru() -> dict:
    """The first ``rglru_scan`` design (``tools/rglru_scan_designs.cu``)
    built by ``tools/rglru_variants.py`` with ``-Xptxas -v`` under
    ``build/``: its library and ptxas report."""
    return rglru_variants().build("first", os.path.join(ROOT, "build",
                                                        "rglru_variants"))


def rglru_designs(first=None) -> dict:
    """The first design (built first unless ``first`` holds it) and the
    package's own library as ``kernel._lib()`` loaded it ("current"), each
    launched through its C entry points: name ->
    (``rglru_variants.Variant``, the first's ptxas report or None; the
    package's registers and spills are in ``kernel.ring_shape``)."""
    from repro_torch.kernels.rglru_scan import kernel as RGK
    rv = rglru_variants()
    first = first or build_first_rglru()
    return {"first": (rv.Variant("first", first["lib"]), first["ptxas"]),
            "current": (rv.Variant("current", RGK._lib()), None)}


def rglru_design_calls(torch, designs: dict, what: str, want, launch):
    """For each design, ``launch(variant, outs)`` into new outputs shaped
    as ``want`` (a tensor, or a tuple of them), which must then equal
    ``want`` bit for bit: name -> that call, with no arguments, for
    timing."""
    want = want if isinstance(want, tuple) else (want,)
    calls = {}
    for s, (v, _) in designs.items():
        outs = tuple(torch.empty_like(w) for w in want)
        launch(v, outs)
        torch.cuda.synchronize()
        check(all(torch.equal(o, w) for o, w in zip(outs, want)),
              f"rglru_scan design {s!r} {what}: differs from the plain "
              "version")
        calls[s] = lambda v=v, outs=outs: launch(v, outs)
    return calls


def rglru_turns(designs: dict, calls: dict) -> dict:
    """Each design's call timed in turns, first, current, current, first,
    ``REPS // 2`` calls from an idle card each time (CUDA events): name ->
    (median of the ``REPS`` times, the times)."""
    times = rglru_variants().in_turns(
        calls, 2, REPS // 2, lambda fn, n: cuda_times_ms(fn, n)[1])
    return {s: (statistics.median(t), t) for s, t in times.items()}


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
    store_kernel_phase(torch, K, R, cols, prog, ops, colidx, kw, results)
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


def store_bound_ms(n: int, shape: dict, ops, with_agg: bool):
    """Least time for one store-form scan of n rows: the columns its
    blocks stage (``launch_shape``: with aggregates size, blocks, valid and
    the read columns; lean valid and the read columns) read once, mask 0
    (4 B, or 1 B lean) and the rule index (4 B) written once, over the
    memory rate; or the f32 work over its peak rate."""
    staged = shape["passes"][0]["staged_cols"]
    bytes_moved = n * (4 * len(staged) + (4 if with_agg else 1) + 4)
    live = int((ops >= 0).sum())
    operations = n * (live + (16 * ops.shape[0] if with_agg else 0))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = operations / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", bytes_moved, operations)


def store_kernel_phase(torch, K, R, cols, prog, ops, colidx, kw, results):
    """The store form at device scale: the kernel phase's rows laid out as
    STORE_GROUPS shard groups, ``(8, 17, 2^24)``, ``BATCH_CRITERIA`` with
    aggregates and lean. mask 0 and rule identical to the plain version
    run one group at a time and to the 2-D kernel over the same rows; the
    aggregate counts equal to the 2-D kernel's, the sums within TOL; bit
    for bit on a second call. Each form timed (CUDA events from an idle
    card) beside its scan device time, bound and grid, in turns with the
    2-D kernel (2-D, aggregates, lean, lean, aggregates, 2-D)."""
    d = STORE_GROUPS
    n = cols.shape[1]
    rp = n // d
    t0 = time.perf_counter()
    store = cols.view(cols.shape[0], d, rp).permute(1, 0, 2).contiguous()
    torch.cuda.synchronize()
    log(f"[store-kernel] columns {tuple(store.shape)} f32 = "
        f"{store.numel() * 4 / 1e9:.2f} GB laid out in "
        f"{time.perf_counter() - t0:.2f} s")
    masks2, rule2, agg2 = K.policy_scan_batch_cuda(cols, *prog, **kw)
    mask0_2d = masks2[0].view(d, rp).clone()
    del masks2
    rule2 = rule2.view(d, rp)
    counts = [0] + list(range(3, 14))          # count, histogram, any_match
    out = {}
    calls = {}
    for with_agg in (True, False):
        form = "store" if with_agg else "store_lean"
        call = (lambda a=with_agg: K.policy_scan_store_cuda(
            store, *prog, with_agg=a, **kw))
        calls[form] = call
        mask, rule, agg = call()
        again = call()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(again, (mask, rule,
                                                            agg))),
              f"{form}: outputs differ between two calls")
        del again
        pm, pr, pa = R.policy_scan_store_ref(store, *prog, with_agg=with_agg,
                                             **kw)
        torch.cuda.synchronize()
        check(torch.equal(mask, pm) and torch.equal(rule, pr),
              f"{form}: mask 0 or rule differ from the plain version")
        del pm, pr
        want0 = mask0_2d if with_agg else mask0_2d > 0.5
        check(torch.equal(mask, want0) and torch.equal(rule, rule2),
              f"{form}: mask 0 or rule differ from the 2-D kernel's")
        del mask, rule, want0
        if with_agg:
            check(torch.equal(agg[:, counts], agg2[:, counts]),
                  f"{form}: counts differ from the 2-D kernel's:\n{agg}\n"
                  f"{agg2}")
            check(torch.allclose(agg, agg2, **TOL) and
                  torch.allclose(agg, pa, **TOL),
                  f"{form}: sums differ:\n{agg}\n{agg2}\n{pa}")
            err = max((agg.double() - pa.double()).abs().max().item(),
                      (agg.double() - agg2.double()).abs().max().item())
        else:
            check(not agg.any(), f"{form}: aggregates are not zero")
            err = 0.0
        del agg, pa
        shape = K.launch_shape(store, prog[0], prog[1], with_agg=with_agg,
                               **kw)
        bms, by, nbytes, nops = store_bound_ms(n, shape, ops, with_agg)
        kern = kernel_device_ms(torch, call, REPS)
        dev = one_kernel_ms(kern, "scan_kernel", form)
        check(with_agg == any("reduce_kernel" in k for k in kern),
              f"{form}: reduce kernel launches {sorted(kern)}")
        plain_ms, _ = cuda_times_ms(lambda a=with_agg: R.policy_scan_store_ref(
            store, *prog, with_agg=a, **kw), REPS)
        out[form] = dict(max_abs_err=err, bound_ms=bms, bound_by=by,
                         bytes=nbytes, operations=nops, scan_device_ms=dev,
                         plain_ms=plain_ms, grid=shape["grid"],
                         staged_cols=shape["passes"][0]["staged_cols"],
                         stages=shape["passes"][0]["stages"],
                         blocks_per_sm=shape["blocks_per_sm"])
    del mask0_2d, rule2
    flat = (lambda: K.policy_scan_batch_cuda(cols, *prog, **kw))
    turns = {"2d": [], "store": [], "store_lean": []}
    for who in ("2d", "store", "store_lean", "store_lean", "store", "2d"):
        turns[who].append(cuda_times_ms(flat if who == "2d" else calls[who],
                                        REPS)[0])
    for form in ("store", "store_lean"):
        o = out[form]
        o["ms"] = statistics.median(turns[form])
        log(f"[store-kernel] {form} R={ops.shape[0]} D={d} Rp={rp} {CARD}: "
            "mask 0 and rule identical to the plain version (one group at "
            "a time) and to the 2-D kernel, bit for bit on a second call"
            + (", counts equal to the 2-D kernel's, sums max abs err "
               f"{o['max_abs_err']!r}" if form == "store" else "")
            + f"; {o['ms']!r} ms (turns {turns[form]}); scan device ms "
            f"{o['scan_device_ms']!r}; plain {o['plain_ms']!r} ms; bound "
            f"{o['bound_ms']!r} ms by {o['bound_by']} ({o['bytes']} B); "
            f"{o['bound_ms'] / o['ms']:.3f} of the bound; grid {o['grid']}, "
            f"staged {o['staged_cols']}, {o['stages']} stages, "
            f"{o['blocks_per_sm']} blocks an SM")
    log(f"[store-kernel] the 2-D kernel in the same turns: {turns['2d']} ms")
    results["policy_scan_batch"]["store"] = dict(
        groups=d, rows_per_group=rp, programs=int(ops.shape[0]),
        flat_turns_ms=statistics.median(turns["2d"]), **out)
    del store
    torch.cuda.empty_cache()


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
    # the op's cap stays at 4096 (past it ProfileCube takes its host
    # groupby); the kernel takes up to KERNEL_MAX_GROUPS and refuses more
    # before it launches
    check(PK.max_groups() == PK.KERNEL_MAX_GROUPS, "the library's group "
          f"limit {PK.max_groups()} is not {PK.KERNEL_MAX_GROUPS}")
    before = PK.profile_cube_launches
    for fn in (lambda: PO.profile_cube(
                   *(torch.zeros(4).numpy(),) * 4,
                   n_groups=PO.MAX_GROUPS + 1, device=device),
               lambda: PK.profile_cube_cuda(
                   cols_c, **dict(PREBUCKETED,
                                  n_groups=PK.KERNEL_MAX_GROUPS + 1))):
        try:
            fn()
        except ValueError:
            continue
        fail("n_groups past the op's or the kernel's cap did not raise")
    check(PK.profile_cube_launches == before, "a refused call counted a "
          "launch")
    kw = dict(PREBUCKETED, n_groups=PO.MAX_GROUPS + 1)
    check(torch.equal(PK.profile_cube_cuda(cols_c, **kw),
                      PR.profile_cube_ref(cols_c.double(), **kw).float()),
          f"profile_cube at {PO.MAX_GROUPS + 1} groups differs from the f64 "
          "plain version")
    log(f"[cube] edges: empty shapes as the reference's, ragged N="
        f"{ragged.shape[1]} identical to the f64 plain version, the op "
        f"refuses n_groups={PO.MAX_GROUPS + 1}, the kernel takes it "
        f"(identical to the f64 plain version) and refuses "
        f"{PK.KERNEL_MAX_GROUPS + 1}")
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
    results["profile_cube"].setdefault("launches_by_path", {})[
        "ProfileCube.rebuild"] = counts["profile_cube"]
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
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.paged_attention import kernel as AK
    from repro_torch.kernels.policy_scan import kernel as K
    from repro_torch.kernels.profile_cube import kernel as PK
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rwkv6_step import kernel as RWK
    for mod in (K, PK, AK, RGK, RWK, DK):
        mod.reset_counters()
    out = fn()
    return out, {"policy_scan": K.policy_scan_launches,
                 "policy_scan_batch": K.policy_scan_batch_launches,
                 "policy_scan_store": K.policy_scan_store_launches,
                 "policy_scan_store_lean": K.policy_scan_store_lean_launches,
                 "policy_scan_store_scoped":
                     K.policy_scan_store_scoped_launches,
                 "policy_scan_store_scoped_lean":
                     K.policy_scan_store_scoped_lean_launches,
                 "profile_cube": PK.profile_cube_launches,
                 "profile_cube_scoped": PK.profile_cube_scoped_launches,
                 "paged_attention": AK.paged_attention_launches,
                 "rglru_scan": RGK.rglru_scan_launches,
                 "rglru_scan_bwd": RGK.rglru_scan_bwd_launches,
                 "rwkv6_step": RWK.rwkv6_step_launches,
                 "decode_attention": DK.decode_attention_launches,
                 "decode_attention_combine":
                     DK.decode_attention_combine_launches}


def only(**launches) -> dict:
    """The counts a window must show: these kernels so many times, every
    other kernel never (``policy_scan_store`` counts the store form with
    aggregates, ``policy_scan_store_lean`` the lean form, the ``_scoped``
    counts their scoped forms, ``profile_cube_scoped`` the scoped cube,
    ``rglru_scan_bwd`` the gradient of ``rglru_scan``,
    ``decode_attention_combine`` the combine of ``decode_attention``)."""
    want = dict.fromkeys(list(TPU_KERNELS) + [
        "policy_scan_store", "policy_scan_store_lean",
        "policy_scan_store_scoped", "policy_scan_store_scoped_lean",
        "profile_cube_scoped", "rglru_scan_bwd", "decode_attention",
        "decode_attention_combine"], 0)
    want.update(launches)
    return want


def decode_attn_want(torch, cfg, cache, steps: int) -> dict:
    """The ``decode_attention`` launches of ``steps`` decode steps over
    ``cache`` (a layer's blob holds ``k`` for self-attention, ``xk`` for
    cross-attention, int8 ones dequantized to bf16 first): one a layer a
    step, and a combine a step where the layer's shapes split the
    positions."""
    from repro_torch.kernels.decode_attention import kernel as DK
    n = combines = 0
    for blob in cache:
        for key in ("k", "xk"):
            if key in blob:
                B, L, K, hd = blob[key].shape
                dtype = (torch.bfloat16 if blob[key].dtype == torch.int8
                         else blob[key].dtype)
                n += 1
                combines += DK.splits(B, K, cfg.n_heads // K, L, hd,
                                      dtype) > 1
    return dict(decode_attention=n * steps,
                decode_attention_combine=combines * steps)


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


def churn_fids(rng, n_entries: int):
    """CHURN of the entries' fids (1..n_entries), distinct."""
    import numpy as np
    return rng.choice(np.arange(1, n_entries + 1),
                      size=round(n_entries * CHURN), replace=False)


def span_times(rep, names) -> dict:
    """name -> seconds of the first span of each name in a RunReport."""
    out = {}
    for name, secs in flat_spans(rep.telemetry.get("spans")):
        out.setdefault(name.lstrip("."), secs)
    return {k: out.get(k) for k in names}


def store_form_at_engine_shape(torch, store, programs) -> dict:
    """The store form, both ways, over ``store``'s resident tensor with
    the run's ``programs``, held to its plain version on the same tensor:
    mask 0 and rule identical, aggregates within TOL, zeros when lean."""
    from repro_torch.core.device_store import _VALID_COL
    from repro_torch.core.policy import KERNEL_COLUMNS, compile_programs
    from repro_torch.kernels.policy_scan import kernel as K
    from repro_torch.kernels.policy_scan import ref as R
    buf = store._buf
    prog = [torch.from_numpy(a).to(buf.device) for a in
            compile_programs(programs, store.catalog.strings, NOW)]
    kw = dict(size_col=KERNEL_COLUMNS.index("size"),
              blocks_col=KERNEL_COLUMNS.index("blocks"),
              valid_col=_VALID_COL)
    err = 0.0
    for with_agg in (False, True):
        form = "store" if with_agg else "store_lean"
        mask, rule, agg = K.policy_scan_store_cuda(buf, *prog,
                                                   with_agg=with_agg, **kw)
        pm, pr, pa = R.policy_scan_store_ref(buf, *prog, with_agg=with_agg,
                                             **kw)
        torch.cuda.synchronize()
        check(torch.equal(mask, pm), f"engine-shape {form}: mask 0 differs "
              "from the plain version")
        check(torch.equal(rule, pr), f"engine-shape {form}: rule index "
              "differs from the plain version")
        if with_agg:
            check(torch.allclose(agg, pa, **TOL), f"engine-shape {form}: "
                  f"aggregates differ:\n{agg}\n{pa}")
            err = (agg.double() - pa.double()).abs().max().item()
        else:
            check(not agg.any(), f"engine-shape {form}: aggregates are not "
                  "zero")
    log(f"[store-engine] store form R={len(programs)} over the resident "
        f"{tuple(buf.shape)} tensor, lean and with aggregates: mask 0 and "
        f"rule identical to the plain version; agg max abs err {err!r}")
    return dict(shape=list(buf.shape), programs=len(programs),
                max_abs_err=err)


def store_engine_phase(torch, cat, device, results, seed: int):
    """``PolicyEngine`` over a ``DeviceColumnStore`` on the card: cold,
    three warm rounds of in-place churn, a round of inserts and removes in
    one shard, and ``scan_catalog(store=)``; see the module docstring."""
    import numpy as np
    from repro_torch.core import (DeviceColumnStore, PolicyDefinition,
                                  PolicyEngine)
    from repro_torch.kernels.policy_scan.ops import scan_catalog
    store = DeviceColumnStore(cat, groups=STORE_ENGINE_GROUPS, device=device)
    eng = PolicyEngine(cat, clock=lambda: NOW, device=device)
    eng.attach_device_store(store)
    twin = PolicyEngine(cat, clock=lambda: NOW, device=device)
    rules = [("archive_big", "size > 16G", {"tier": "archive"}),
             ("purge_old", "last_access > 90d", {"tier": "purge"})]

    def register(engine, budget):
        rec = Recorder()
        engine.register(PolicyDefinition.from_config(
            name="lru", action=rec, scope="type == file", rules=rules,
            sort_by="atime", mutates=False, batch_size=4096,
            max_actions_per_run=budget.get("max_actions_per_run", 0)))
        return rec

    def run(engine, evaluator, budget):
        rec = register(engine, budget)
        arrays0 = cat.arrays_calls
        t1 = time.perf_counter()
        rep, counts = launch_window(lambda: engine.run(
            "lru", evaluator=evaluator,
            target_volume=budget.get("target", 0)))
        wall = time.perf_counter() - t1
        check(rep.evaluator == evaluator and rep.fallback_reason == "",
              f"run(evaluator={evaluator!r}) ran {rep.evaluator!r}, "
              f"fallback {rep.fallback_reason!r}")
        want = only(policy_scan_store_lean=1) if evaluator == "policy_scan_mesh" else only(
                policy_scan_batch=1 if evaluator == "policy_scan" else 0)
        check(counts == want, f"run(evaluator={evaluator!r}) launched "
              f"{counts}, expected {want}")
        return rep, list(rec.calls), counts, wall, \
            cat.arrays_calls - arrays0

    r = results["policy_scan_batch"]
    windows = {}
    uploads0 = store.full_uploads
    for i, budget in enumerate(({}, {"max_actions_per_run": 10_000},
                                {"target": 1 << 44})):
        tag = ",".join(f"{k}={v}" for k, v in budget.items()) or "none"
        seqs = {}
        for evaluator in ("policy_scan_mesh", "policy_scan", "numpy"):
            rep, calls, counts, wall, _ = run(eng, evaluator, budget)
            seqs[evaluator] = (rep.matched, rep.succeeded, rep.volume, calls)
            if i == 0 and evaluator == "policy_scan_mesh":
                check(store.full_uploads - uploads0 == STORE_ENGINE_GROUPS,
                      f"the cold run made {store.full_uploads - uploads0} "
                      f"full uploads, not {STORE_ENGINE_GROUPS}")
                windows["PolicyEngine.run(policy_scan_mesh)"] = counts
                r["store_engine_shape"] = store_form_at_engine_shape(
                    torch, store, eng._programs(eng.policies["lru"], None))
                log(f"[store-engine] cold run: {STORE_ENGINE_GROUPS} full "
                    f"uploads, wall {wall!r} s, spans "
                    + "; ".join(f"{n} {t!r}" for n, t in flat_spans(
                        rep.telemetry.get("spans"))))
        check(len(seqs["numpy"][3]) > 0, "the policy actioned nothing")
        check(seqs["policy_scan_mesh"] == seqs["numpy"] == seqs[
            "policy_scan"], f"actioned (fid, tier) sequences differ (budget "
            f"{tag}): " + ", ".join(f"{k} {len(v[3])}"
                                    for k, v in seqs.items()))
        log(f"[store-engine] budget {tag}: {len(seqs['numpy'][3])} actioned "
            "(fid, tier) pairs identical across policy_scan_mesh, "
            "policy_scan and numpy; the mesh run launched one lean store "
            "form and no 2-D kernel")

    rng = np.random.default_rng(seed + 20)
    span_names = ("run", "run.match", "store.refresh", "store.match",
                  "run.act")
    warm = []
    for round_i in range(3):
        fids = churn_fids(rng, ENTRIES)
        half = len(fids) // 2
        cat.update_fields_batch(fids[:half].tolist(), atime=NOW)
        cat.update_fields_batch(fids[half:].tolist(), size=1 << 35,
                                atime=NOW - 100 * 86400)
        before = (store.full_uploads, store.rows_scattered,
                  store.delta_refreshes)
        rep, calls, counts, wall, arrays = run(eng, "policy_scan_mesh", {})
        check(store.full_uploads == before[0], f"warm round {round_i}: "
              f"{store.full_uploads - before[0]} full uploads")
        check(store.rows_scattered - before[1] == len(fids),
              f"warm round {round_i}: {store.rows_scattered - before[1]} "
              f"rows scattered for {len(fids)} changed entries")
        check(arrays == 0, f"warm round {round_i}: Catalog.arrays() ran "
              f"{arrays} times")
        # the policy_scan run first: it pays the host column concat
        scan_rep, _, _, scan_wall, _ = run(twin, "policy_scan", {})
        twin_rep, twin_calls, *_ = run(twin, "numpy", {})
        check(calls == twin_calls and rep.matched == twin_rep.matched,
              f"warm round {round_i}: actions differ from the numpy twin "
              f"({len(calls)} vs {len(twin_calls)})")
        mesh_spans = span_times(rep, span_names)
        scan_spans = span_times(scan_rep, span_names)
        warm.append(dict(mesh=mesh_spans, policy_scan=scan_spans,
                         mesh_wall=wall, policy_scan_wall=scan_wall,
                         delta_refreshes=store.delta_refreshes - before[2]))
        log(f"[store-engine] warm round {round_i} {CARD}: {len(fids)} "
            f"entries changed in place; 0 full uploads, "
            f"{store.rows_scattered - before[1]} rows scattered in "
            f"{store.delta_refreshes - before[2]} groups, Catalog.arrays() "
            f"flat; actions equal to the numpy twin's ({len(calls)}); "
            f"policy_scan_mesh wall {wall!r} s spans {mesh_spans}; "
            f"policy_scan (same state) wall {scan_wall!r} s spans "
            f"{scan_spans}")

    # inserts and removes in one shard: only its group re-uploads
    shard = 1
    live = [f for f in range(1, ENTRIES + 1)
            if cat._shard_id(f) == shard][:1000]
    cat.remove_batch(live)
    new = [f for f in range(ENTRIES + 1, ENTRIES + 200_000)
           if cat._shard_id(f) == shard][:1000]
    from repro_torch.core import Entry, FsType
    cat.upsert_batch([Entry(fid=f, name=f"n{f}", path=f"/fs/new/n{f}",
                            type=FsType.FILE, size=(f % 4096) << 24,
                            atime=float(f % (1 << 24)), owner="u1")
                      for f in new])
    before = store.full_uploads
    rep, calls, counts, wall, arrays = run(eng, "policy_scan_mesh", {})
    twin_rep, twin_calls, *_ = run(twin, "numpy", {})
    check(store.full_uploads - before == 1, f"the structural round made "
          f"{store.full_uploads - before} full uploads, not 1")
    check(calls == twin_calls, "structural round: actions differ from the "
          "numpy twin")
    check(arrays == 0, "structural round: Catalog.arrays() ran")
    log(f"[store-engine] 1000 removes and 1000 inserts in shard {shard}: "
        f"1 full upload (its group), actions equal to the numpy twin's "
        f"({len(calls)}); wall {wall!r} s")

    # scan_catalog(store=): the store form with aggregates, once
    expr = eng._programs(eng.policies["lru"], None)[0]
    (fids_s, agg_s), counts = launch_window(
        lambda: scan_catalog(cat, expr, NOW, store=store))
    check(counts == only(policy_scan_store=1),
          f"scan_catalog(store=) launched {counts}, expected one store form "
          "with aggregates")
    windows["scan_catalog(store=)"] = counts
    fids_2d, agg_2d = scan_catalog(cat, expr, NOW, device=device)
    check(np.array_equal(np.sort(fids_s), np.sort(fids_2d)),
          "scan_catalog(store=) fids differ from the 2-D scan_catalog's")
    check(agg_close(agg_s, agg_2d), f"scan_catalog(store=) aggregates "
          f"differ: {agg_s} vs {agg_2d}")
    log(f"[store-engine] scan_catalog(store=): {len(fids_s)} fids and "
        f"aggregates equal to the 2-D scan_catalog's; launches per path "
        f"{json.dumps(windows)}")
    store.detach()
    r["store_launches_by_path"] = {
        path: {k: c[k] for k in ("policy_scan_store",
                                 "policy_scan_store_lean")}
        for path, c in windows.items()}
    r["store_launches"] = windows["scan_catalog(store=)"][
        "policy_scan_store"]
    r["store_lean_launches"] = windows["PolicyEngine.run(policy_scan_mesh)"][
        "policy_scan_store_lean"]
    r["store_warm_rounds"] = warm


class MovingClock:
    """A clock a phase moves by hand (``t`` seconds)."""

    def __init__(self, t: float = NOW):
        self.t = t

    def __call__(self) -> float:
        return self.t


def cube_equal(got, want) -> bool:
    """Two merged cubes agree: same shape, counts equal, volume and
    spc_used within rtol=1e-5 (the store's partials are f32, the host
    groupby's int64)."""
    import numpy as np
    return (got.shape == want.shape and np.array_equal(got[0], want[0])
            and np.allclose(got[1:], want[1:], rtol=1e-5, atol=0))


def host_cube(cat, now):
    """The exact int64 host groupby of ``cat`` at ``now``."""
    from repro_torch.core import ProfileCube
    cube = ProfileCube(cat, clock=lambda: now, device="cpu")
    cube.rebuild(now=now)
    return cube.cube(now)


def store_reports_phase(torch, cat, device, results, seed: int):
    """``Reports`` and ``ProfileCube`` served from a ``DeviceColumnStore``
    on the card, held to the host folds: cold, after 1% in-place churn,
    after a rename; then the planes' ops at device scale
    (:func:`store_scale_phase`). See the module docstring."""
    import numpy as np
    from repro_torch.core import DeviceColumnStore, ProfileCube, Reports
    clock = MovingClock()
    store = DeviceColumnStore(cat, groups=STORE_ENGINE_GROUPS, device=device)
    rs = Reports(cat, clock=clock).attach_device_store(store)
    pc = ProfileCube(cat, clock=clock, device=device) \
        .attach_device_store(store)
    rh = Reports(cat, clock=clock)
    finds = ("size > 60G and type == file",
             "last_access > 180d and owner == 'u3'")
    tops = [(by, desc) for by in ("size", "atime") for desc in (True, False)]
    prefixes = ("/fs", "/fs/d3", "/nope")
    windows, walls = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out, counts = launch_window(fn)
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        return out, counts

    def queries(tag, want_cube_launches):
        """Every store query, then the host folds; all must agree."""
        arrays0 = cat.arrays_calls
        got = {}
        for crit in finds:
            got["find", crit], counts = timed("find (store)",
                                              lambda c=crit: rs.find(c))
            check(counts == only(policy_scan_store_lean=1), f"{tag}: find "
                  f"{crit!r} launched {counts}, not one lean store form")
            windows["DeviceColumnStore.find_paths"] = counts
        for by, desc in tops:
            got["top", by, desc], counts = timed(
                "top_files (store)", lambda b=by, d=desc: rs.top_files(
                    by=b, k=10, desc=d))
            check(counts == only(), f"{tag}: top_files launched {counts}")
        for p in prefixes:
            got["du", p], counts = timed("du (store)", lambda q=p: rs.du(q))
            check(counts == only(), f"{tag}: du launched {counts}")
        got["cube"], counts = timed("analytics_cube (store)",
                                    lambda: pc.cube(clock()))
        check(counts == only(profile_cube=want_cube_launches),
              f"{tag}: the cube launched {counts}, expected "
              f"{want_cube_launches} profile_cube")
        if want_cube_launches:
            windows["DeviceColumnStore._rebuild_cube"] = counts
        check(cat.arrays_calls == arrays0, f"{tag}: the store queries "
              f"called Catalog.arrays() {cat.arrays_calls - arrays0} times")
        check(rs.last_fallback_reason is None and rs.host_served == 0,
              f"{tag}: a store query fell back: {rs.last_fallback_reason}")
        for key, val in got.items():
            t0 = time.perf_counter()
            if key[0] == "find":
                want = rh.find(key[1])
            elif key[0] == "top":
                want = rh.top_files(by=key[1], k=10, desc=key[2])
            elif key[0] == "du":
                want = rh.du(key[1])
            else:
                want = host_cube(cat, clock())
                walls.setdefault("cube (host rebuild)", []).append(
                    time.perf_counter() - t0)
                check(cube_equal(val, want), f"{tag}: the store's cube "
                      "differs from the host groupby's")
                continue
            walls.setdefault(f"{key[0]} (host)", []).append(
                time.perf_counter() - t0)
            check(val == want, f"{tag}: {key} differs from the host fold "
                  f"({len(val)} vs {len(want)})")
        return got

    # cold: 4 full uploads with paths, the cube built by 4 launches
    t0 = time.perf_counter()
    cold = queries("cold", STORE_ENGINE_GROUPS)
    check(store.full_uploads == STORE_ENGINE_GROUPS and
          store.cube_rebuilds == 1, f"cold: {store.full_uploads} full "
          f"uploads, {store.cube_rebuilds} cube rebuilds")
    n_found = [len(cold["find", c]) for c in finds]
    log(f"[store-reports] cold {CARD}: {len(finds)} finds "
        f"({n_found} paths), {len(tops)} top_files, {len(prefixes)} du and "
        f"the cube from DeviceColumnStore(groups={STORE_ENGINE_GROUPS}) "
        f"equal to the host folds in {time.perf_counter() - t0:.2f} s; "
        f"{store.full_uploads} full uploads, launches "
        f"{json.dumps(windows)}; du('/fs') {cold['du', '/fs']}")
    glob = rs.find("name == 'f12345'")
    check(glob == rh.find("name == 'f12345'") and len(glob) == 1
          and rs.last_fallback_reason is not None, "a glob find did not "
          f"fall back to the host fold: {rs.last_fallback_reason!r}")
    rs.last_fallback_reason, rs.host_served = None, 0

    # warm: 1% of the entries changed in place, at a later instant
    rng = np.random.default_rng(seed + 21)
    live = np.concatenate([g.fids for g in store._groups])
    fids = rng.choice(live, size=round(ENTRIES * CHURN), replace=False)
    half = len(fids) // 2
    cat.update_fields_batch(fids[:half].tolist(), atime=NOW - 40 * 86400)
    cat.update_fields_batch(fids[half:].tolist(), size=1 << 35)
    clock.t = NOW + 30 * 86400
    before = (store.full_uploads, store.rows_scattered, store.cube_rebuilds,
              store.rollovers)
    queries("warm", 0)
    check(store.full_uploads == before[0], f"warm: "
          f"{store.full_uploads - before[0]} full uploads")
    check(store.rows_scattered - before[1] == len(fids), f"warm: "
          f"{store.rows_scattered - before[1]} rows scattered for "
          f"{len(fids)} changed entries")
    check(store.cube_rebuilds == before[2] and store.rollovers > before[3],
          f"warm: {store.cube_rebuilds - before[2]} cube rebuilds, "
          f"{store.rollovers - before[3]} rollovers")
    log(f"[store-reports] warm {CARD}: {len(fids)} entries changed in "
        f"place, now + 30 days: 0 full uploads, "
        f"{store.rows_scattered - before[1]} rows scattered, 0 cube "
        f"rebuilds and 0 profile_cube launches (signed scatter-adds), "
        f"{store.rollovers - before[3]} age rollovers on the card, "
        f"Catalog.arrays() flat; every answer equal to the host folds")

    # rename: a few paths in one shard; only its group re-uploads
    shard = 2
    moved = [int(f) for f in live if cat._shard_id(int(f)) == shard][:5]
    import dataclasses
    cat.upsert_batch([dataclasses.replace(cat.get(f),
                                          path=f"/fs/renamed/r{f}")
                      for f in moved])
    before = store.full_uploads
    renamed = queries("rename", STORE_ENGINE_GROUPS)
    check(store.full_uploads - before == 1, f"rename: "
          f"{store.full_uploads - before} full uploads, not 1")
    check(rs.du("/fs/renamed") == rh.du("/fs/renamed")
          and rs.du("/fs/renamed")["count"] == len(moved),
          "rename: du of the new subtree differs")
    log(f"[store-reports] rename of {len(moved)} paths in shard {shard}: 1 "
        f"full upload (its group), the cube rebuilt ({STORE_ENGINE_GROUPS} "
        f"launches), every answer equal to the host folds; du('/fs') "
        f"{renamed['du', '/fs']}")
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"[store-reports] {CARD}: query walls, median s over the rounds: "
        f"{json.dumps(med)}")
    results["policy_scan_batch"].setdefault("store_launches_by_path", {})[
        "DeviceColumnStore.find_paths"] = {
            k: windows["DeviceColumnStore.find_paths"][k]
            for k in ("policy_scan_store", "policy_scan_store_lean")}
    results["policy_scan_batch"]["find_paths_launches"] = windows[
        "DeviceColumnStore.find_paths"]["policy_scan_store_lean"]
    results["profile_cube"].setdefault("launches_by_path", {})[
        "DeviceColumnStore._rebuild_cube"] = windows[
            "DeviceColumnStore._rebuild_cube"]["profile_cube"]
    results["profile_cube"]["store_query_walls_s"] = med
    store.detach()
    del store, rs, pc
    store_scoped_phase(torch, cat, device, results, seed)
    store_tiered_phase(torch, cat, device, results, seed)
    store_scale_phase(torch, device, results, seed)


SCOPED_SUBJECTS = ("u3", "staff", "tree", "mixed", "nobody")


def scoped_grants():
    """A ``GrantTable`` of the shapes a site gives its tenants: one uid
    (``u3``), one gid (``staff``: group g1), one subtree (``tree``: two of
    the 97 directories), one mixed and one that sees nothing."""
    from repro_torch.core import GrantTable
    g = GrantTable()
    g.add_subject("u3")
    g.add_subject("staff", owners=(), groups=("g1",))
    g.add_subject("tree", owners=(), subtrees=("/fs/d5", "/fs/d42"))
    g.add_subject("mixed", owners=("u6",), groups=("g1",),
                  subtrees=("/fs/d77",))
    g.add_subject("nobody", owners=("ghost",))
    return g


def store_scoped_phase(torch, cat, device, results, seed: int):
    """The permissions plane on the card: a fresh 4-group store with
    ``Reports`` and ``ProfileCube`` under :func:`scoped_grants`, every
    scoped query of every subject held to the grant-filtered host folds,
    cold, warm (1% in-place churn that flips owners and groups) and after a
    ``GrantTable`` change, with the launches and the plane's counters of
    each round checked. See the module docstring."""
    import numpy as np
    from repro_torch.core import (DeviceColumnStore, ProfileCube, Reports,
                                  parse_expr)
    rng = np.random.default_rng(seed + 22)
    t0 = time.perf_counter()
    live = np.concatenate([s.fids() for s in cat.shards]).astype(np.int64)
    g1 = rng.choice(live, size=len(live) // 8, replace=False)
    cat.update_fields_batch(g1.tolist(), group="g1")
    clock = MovingClock(NOW + 30 * 86400)
    grants = scoped_grants()
    store = DeviceColumnStore(cat, groups=STORE_ENGINE_GROUPS, device=device)
    pc = ProfileCube(cat, clock=clock, device=device) \
        .attach_device_store(store)
    pc.attach_grants(grants)
    rs = Reports(cat, clock=clock, profiles=pc).attach_device_store(store) \
        .attach_grants(grants)
    pc_h = ProfileCube(cat, clock=clock, device="cpu")
    pc_h.attach_grants(grants)
    rh = Reports(cat, clock=clock, profiles=pc_h).attach_grants(grants)
    log(f"[store-scoped] {len(g1)} entries moved to group g1, the store and "
        f"the host oracle set up in {time.perf_counter() - t0:.2f} s")
    finds = ("size > 60G and type == file",
             "last_access > 180d and owner == 'u3'")
    scan_expr = "size > 30G"
    prefixes = ("/fs", "/fs/d5", "/fs/d77")
    windows, walls = {}, {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out, counts = launch_window(fn)
        walls.setdefault(name, []).append(time.perf_counter() - t1)
        return out, counts

    def cube_reports(rep, s):
        return {"types": rep.report_types(subject=s),
                "top_users": rep.top_users(k=5, subject=s),
                "age": rep.age_profile(subject=s),
                "u6": rep.report_user("u6", subject=s)}

    def queries(tag, subjects, cube_unscoped):
        """Every scoped query of every subject on the store, each in a
        window of its own, then the host oracle; all must agree."""
        arrays0 = cat.arrays_calls
        got = {}
        for i, s in enumerate(subjects):
            for crit in finds:
                got["find", s, crit], counts = timed(
                    "find (store, scoped)",
                    lambda c=crit, q=s: rs.find(c, subject=q))
                check(counts == only(policy_scan_store_scoped_lean=1),
                      f"{tag}: scoped find {crit!r} for {s} launched "
                      f"{counts}, not one lean scoped store form")
                windows["DeviceColumnStore.find_paths(subject=)"] = counts
            (fids, agg), counts = timed(
                "scan (store, scoped)", lambda q=s: store.scan(
                    parse_expr(scan_expr), clock(), subject=q))
            check(counts == only(policy_scan_store_scoped=1), f"{tag}: "
                  f"scoped scan for {s} launched {counts}, not one scoped "
                  "store form with aggregates")
            windows["DeviceColumnStore.scan(subject=)"] = counts
            got["scan", s] = (np.sort(fids), agg["count"], agg["volume"])
            got["top", s], counts = timed(
                "top_files (store, scoped)",
                lambda q=s: rs.top_files(by="size", k=10, subject=q))
            check(counts == only(), f"{tag}: top_files launched {counts}")
            for p_ in prefixes:
                got["du", s, p_], counts = timed(
                    "du (store, scoped)",
                    lambda x=p_, q=s: rs.du(x, subject=q))
                check(counts == only(), f"{tag}: du launched {counts}")
            _, counts = timed("cube (store, scoped)",
                              lambda q=s: pc.cube(clock(), subject=q))
            want = only(profile_cube_scoped=STORE_ENGINE_GROUPS,
                        profile_cube=STORE_ENGINE_GROUPS
                        if cube_unscoped and i == 0 else 0)
            check(counts == want, f"{tag}: the scoped cube for {s} launched "
                  f"{counts}, expected {want}")
            windows["DeviceColumnStore.analytics_cube(subject=)"] = counts
            got["cube", s], counts = launch_window(
                lambda q=s: cube_reports(rs, q))
            check(counts == only(), f"{tag}: cube reports launched {counts}")
        check(cat.arrays_calls == arrays0, f"{tag}: the scoped store "
              f"queries called Catalog.arrays() "
              f"{cat.arrays_calls - arrays0} times")
        check(rs.last_fallback_reason is None and rs.host_served == 0,
              f"{tag}: a scoped query fell back: {rs.last_fallback_reason}")
        t1 = time.perf_counter()
        pc_h.rebuild(now=clock())
        arrays = cat.arrays()
        for s in subjects:
            vis = grants.visible_mask(s, arrays, cat.strings)
            for crit in finds:
                check(got["find", s, crit] == rh.find(crit, subject=s),
                      f"{tag}: scoped find {crit!r} for {s} differs from "
                      "the host fold")
            m = parse_expr(scan_expr).mask(arrays, cat.strings, clock()) & vis
            volume = float(arrays["size"][m].astype(np.float32).astype(
                np.float64).sum())
            check(np.array_equal(got["scan", s][0],
                                 np.sort(arrays["fid"][m]))
                  and got["scan", s][1] == float(m.sum())
                  and math.isclose(got["scan", s][2], volume,
                                   rel_tol=TOL["rtol"], abs_tol=TOL["atol"]),
                  f"{tag}: scoped scan for {s} differs from the host mask "
                  f"(count {got['scan', s][1]} / {m.sum()}, volume "
                  f"{got['scan', s][2]} / {volume})")
            check(got["top", s] == rh.top_files(by="size", k=10, subject=s),
                  f"{tag}: scoped top_files for {s} differs")
            for p_ in prefixes:
                check(got["du", s, p_] == rh.du(p_, subject=s),
                      f"{tag}: scoped du({p_!r}) for {s} differs")
            check(got["cube", s] == cube_reports(rh, s), f"{tag}: the "
                  f"scoped cube's reports for {s} differ from the host's")
        walls.setdefault("host oracle, every subject", []).append(
            time.perf_counter() - t1)
        return got

    # cold: 4 full uploads, the plane materialized once a group
    cold = queries("cold", SCOPED_SUBJECTS, True)
    check(store.full_uploads == STORE_ENGINE_GROUPS
          and store.perm_materializations == STORE_ENGINE_GROUPS
          and store.perm_word_scatters == 0, f"cold: "
          f"{store.full_uploads} full uploads, "
          f"{store.perm_materializations} materializations, "
          f"{store.perm_word_scatters} word scatters")
    n_found = {s: len(cold["find", s, finds[0]]) for s in SCOPED_SUBJECTS}
    check(n_found["nobody"] == 0 and min(n_found[s] for s in
                                         ("u3", "staff", "tree", "mixed"))
          > 0, f"cold: scoped finds {n_found}")
    log(f"[store-scoped] cold {CARD}: {len(SCOPED_SUBJECTS)} subjects x "
        f"({len(finds)} finds, a scan, top_files, {len(prefixes)} du, the "
        f"cube and 4 reports) equal to the host oracle; "
        f"{store.perm_materializations} materializations, launches "
        f"{json.dumps(windows)}; '{finds[0]}' paths {json.dumps(n_found)}")

    # warm: 1% of the entries changed in place: owners and groups flip
    fids = rng.choice(live, size=round(ENTRIES * CHURN), replace=False)
    half = len(fids) // 2
    cat.update_fields_batch(fids[:half].tolist(), owner="u3",
                            atime=NOW - 40 * 86400)
    cat.update_fields_batch(fids[half:].tolist(), group="g1", size=1 << 35)
    before = (store.full_uploads, store.rows_scattered,
              store.perm_materializations, store.perm_word_scatters)
    queries("warm", SCOPED_SUBJECTS, False)
    check(store.full_uploads == before[0] and store.rows_scattered
          - before[1] == len(fids), f"warm: {store.full_uploads - before[0]}"
          f" full uploads, {store.rows_scattered - before[1]} rows "
          f"scattered for {len(fids)} changed entries")
    check(store.perm_materializations == before[2]
          and store.perm_word_scatters > before[3], f"warm: "
          f"{store.perm_materializations - before[2]} materializations, "
          f"{store.perm_word_scatters - before[3]} word scatters")
    log(f"[store-scoped] warm {CARD}: {len(fids)} entries changed in place "
        f"(owner -> u3, group -> g1): 0 full uploads, 0 materializations, "
        f"{store.perm_word_scatters - before[3]} word scatters (groups "
        "whose words changed), Catalog.arrays() flat; every answer equal "
        "to the host oracle")
    # the warm scoped and unscoped find / top_files, in turns
    turn_walls = {}
    for scoped in (False, True, True, False):
        kw = dict(subject="mixed") if scoped else {}
        for name, fn in (("find", lambda: rs.find(finds[0], **kw)),
                         ("top_files", lambda: rs.top_files(
                             by="size", k=10, **kw))):
            t1 = time.perf_counter()
            fn()
            turn_walls.setdefault(f"{name} {'scoped' if scoped else ''}"
                                  .strip(), []).append(
                time.perf_counter() - t1)
    log(f"[store-scoped] warm walls in turns (unscoped, mixed, mixed, "
        f"unscoped) {CARD}: {json.dumps(turn_walls)}")

    # a GrantTable change: a subtree granted, a subject added
    grants.grant("tree", subtrees=("/fs/d13",))
    grants.add_subject("late", owners=("u1",))
    before = (store.full_uploads, store.perm_materializations,
              store.perm_word_scatters)
    queries("grants", SCOPED_SUBJECTS + ("late",), False)
    check(store.full_uploads == before[0]
          and store.perm_materializations - before[1] == STORE_ENGINE_GROUPS
          and store.perm_word_scatters == before[2], f"grants: "
          f"{store.full_uploads - before[0]} full uploads, "
          f"{store.perm_materializations - before[1]} materializations, "
          f"{store.perm_word_scatters - before[2]} word scatters")
    log(f"[store-scoped] after a grant change {CARD}: 0 full uploads, "
        f"{STORE_ENGINE_GROUPS} materializations (one a group), 0 word "
        f"scatters; every answer of 6 subjects equal to the host oracle")
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"[store-scoped] {CARD}: query walls, median s over the rounds: "
        f"{json.dumps(med)}")
    ps = results["policy_scan_batch"]
    ps.setdefault("store_launches_by_path", {}).update({
        k: {c: windows[k][c] for c in ("policy_scan_store_scoped",
                                       "policy_scan_store_scoped_lean")}
        for k in ("DeviceColumnStore.find_paths(subject=)",
                  "DeviceColumnStore.scan(subject=)")})
    ps["scoped_launches"] = {
        "policy_scan_store_scoped": windows[
            "DeviceColumnStore.scan(subject=)"]["policy_scan_store_scoped"],
        "policy_scan_store_scoped_lean": windows[
            "DeviceColumnStore.find_paths(subject=)"][
                "policy_scan_store_scoped_lean"]}
    ps["scoped_query_walls_s"] = med
    ps["scoped_turn_walls_s"] = turn_walls
    cube = results["profile_cube"]
    cube.setdefault("launches_by_path", {})[
        "DeviceColumnStore.analytics_cube(subject=)"] = windows[
            "DeviceColumnStore.analytics_cube(subject=)"][
                "profile_cube_scoped"]
    cube["scoped_launches"] = cube["launches_by_path"][
        "DeviceColumnStore.analytics_cube(subject=)"]
    store.detach()
    del store, rs, pc, pc_h, rh


TIER_SUBJECTS = ("staff", "tree")   # tiered phase (a): two of scoped_grants
TIER_ENTRIES = 2_000_000        # tiered phase (b): bench_tiering.py's full
TIER_SHARDS = 16                # setting (benchmarks/bench_tiering.py:197,
TIER_GROUPS = 8                 # :36), its 8-device mesh folded onto one
TIER_BUDGET = 200_000           # card: every group demoted
TIER_NOW = float(2 ** 20)       # bench_tiering's NOW and MATCH_EXPR
TIER_EXPR = "type == file and size > 3900k and last_access > 1000s"
TIER_REPS = 5                   # timed scans a turn


def tiering_catalog(n: int, seed: int):
    """``benchmarks/bench_tiering.py``'s ``_catalog`` recipe (its lines
    36-51): n entries over 16 shards, 64 directories, one in ten a
    directory, 4 KiB-granular sizes under 4 MiB, eight owners, four groups,
    random HSM states, access and modify times within 10,000 s of
    ``TIER_NOW``. The draws are taken a chunk at a time instead of an entry
    at a time (the same distributions and seed, not the same values):
    2,000,000 scalar draws of each column cost longer than the phase."""
    import numpy as np
    from repro_torch.core import Catalog, Entry, FsType, HsmState
    rng = np.random.default_rng(seed)
    cat = Catalog(n_shards=TIER_SHARDS)
    states = list(HsmState)
    for lo in range(0, n, 100_000):
        m = min(lo + 100_000, n) - lo
        size = (rng.integers(0, 2 ** 12, m) * 1024).tolist()
        blocks = rng.integers(0, 2 ** 10, m).tolist()
        hsm = rng.integers(0, 5, m).tolist()
        atime = (TIER_NOW - rng.integers(0, 10_000, m)).tolist()
        mtime = (TIER_NOW - rng.integers(0, 10_000, m)).tolist()
        cat.upsert_batch([Entry(
            fid=lo + j + 1, name=f"f{lo + j + 1}",
            path=f"/fs/d{(lo + j) % 64}/f{lo + j + 1}",
            type=FsType.FILE if (lo + j) % 10 else FsType.DIR,
            size=size[j], blocks=blocks[j], owner=f"user{(lo + j) % 8}",
            group=f"grp{(lo + j) % 4}", hsm_state=states[hsm[j]],
            atime=atime[j], mtime=mtime[j]) for j in range(m)])
    return cat


def store_tiered_phase(torch, cat, device, results, seed: int):
    """Tiered residency on the card: (a) the engine's catalog under a
    budget that keeps 2 of 4 groups resident, through cold, three churn
    rounds on one demoted group, an async-demotion round and a structural
    round, every answer equal to an unbudgeted store and the host folds;
    (b) bench_tiering's 2,000,000 entries at 8 groups, every group
    streamed, timed against the resident store. See the module
    docstring."""
    import numpy as np
    from repro_torch.core import (DeviceColumnStore, Entry, FsType,
                                  PolicyDefinition, PolicyEngine,
                                  ProfileCube, Reports, parse_expr)
    from repro_torch.core.device_store import _TILE
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 23)
    d = STORE_ENGINE_GROUPS
    clock = MovingClock(NOW + 30 * 86400)
    grants = scoped_grants()
    # the budget of two resident groups and the window: 2*Rp + 2*D*Rw,
    # Rp from the largest group, the default window slot of 32 tiles
    counts = [sum(cat.shards[s].count() for s in range(cat.n_shards)
                  if s % d == g) for g in range(d)]
    rp = -(-int(max(counts) * 1.25) // _TILE) * _TILE
    rw = 32 * _TILE
    budget = 2 * rp + 2 * d * rw
    tier = DeviceColumnStore(cat, groups=d, device=device,
                             hbm_budget_rows=budget)
    pc = ProfileCube(cat, clock=clock, device=device) \
        .attach_device_store(tier)
    pc.attach_grants(grants)
    rs = Reports(cat, clock=clock, profiles=pc).attach_device_store(tier) \
        .attach_grants(grants)
    ref = DeviceColumnStore(cat, groups=d, device=device)
    ref.enable_reports_plane()
    ref.enable_cube_plane(pc.groups, clock)
    ref.enable_permissions_plane(grants)
    pc_h = ProfileCube(cat, clock=clock, device="cpu")
    pc_h.attach_grants(grants)
    rh = Reports(cat, clock=clock, profiles=pc_h).attach_grants(grants)
    rules = [("archive_big", "size > 16G", {"tier": "archive"}),
             ("purge_old", "last_access > 90d", {"tier": "purge"})]
    engines = {}
    for name, store in (("mesh", tier), ("numpy", None)):
        eng = PolicyEngine(cat, clock=clock, device=device)
        if store is not None:
            eng.attach_device_store(store)
        rec = Recorder()
        eng.register(PolicyDefinition.from_config(
            name="lru", action=rec, scope="type == file", rules=rules,
            sort_by="atime", mutates=False, batch_size=4096))
        engines[name] = (eng, rec)
    crit = "size > 60G and type == file"
    prefixes = ("/fs", "/fs/d5", "/fs/d77")
    log(f"[store-tiered] (a) {len(cat)} entries in {d} groups of {counts} "
        f"rows: Rp {rp}, window slot {rw}, hbm_budget_rows {budget}; set up "
        f"in {time.perf_counter() - t_phase:.2f} s")
    tiered = dict(budget_rows=budget, rounds=[])

    def counted(fn, want_fn):
        """fn() in a launch window; want_fn(windows streamed, resident
        groups before, cube rebuilds) gives the counts it must show."""
        w0, r0 = tier.windows_streamed, tier.cube_rebuilds
        out, c = launch_window(fn)
        res = sum(g.resident for g in tier._groups)
        want = want_fn(tier.windows_streamed - w0, res,
                       tier.cube_rebuilds - r0)
        check(c == want, f"launches {c}, expected {want}")
        return out, tier.windows_streamed - w0

    def round_(tag):
        t0 = time.perf_counter()
        now = clock()
        # the engine: policy_scan_mesh over the tiered store against numpy
        eng, rec = engines["mesh"]
        rec.calls.clear()
        rep, dw = counted(lambda: eng.run("lru", evaluator="policy_scan_mesh"),
                          lambda w, r, c: only(
                              policy_scan_store_lean=int(r > 0) + w))
        check(rep.evaluator == "policy_scan_mesh" and not rep.fallback_reason,
              f"{tag}: the engine ran {rep.evaluator!r}, fallback "
              f"{rep.fallback_reason!r}")
        twin, trec = engines["numpy"]
        trec.calls.clear()
        twin.run("lru", evaluator="numpy")
        check(rec.calls == trec.calls and len(rec.calls) > 0, f"{tag}: "
              f"actioned (fid, tier) pairs differ from numpy's "
              f"({len(rec.calls)} vs {len(trec.calls)})")
        match_launches = 1 + dw
        got, want_ref, host = {}, {}, {}
        for s in (None,) + TIER_SUBJECTS:
            lean = "policy_scan_store_scoped_lean" if s else \
                "policy_scan_store_lean"
            got["find", s], _ = counted(
                lambda: rs.find(crit, subject=s),
                lambda w, r, c: only(**{lean: int(r > 0) + w}))
            want_ref["find", s] = ref.find_paths(parse_expr(crit), now,
                                                 subject=s)
            host["find", s] = rh.find(crit, subject=s)
            for desc in (True, False):
                got["top", s, desc], _ = counted(
                    lambda: rs.top_files(by="size", k=10, desc=desc,
                                         subject=s),
                    lambda w, r, c: only())
                want_ref["top", s, desc] = ref.top_files(
                    by="size", k=10, desc=desc, subject=s)
                host["top", s, desc] = rh.top_files(by="size", k=10,
                                                    desc=desc, subject=s)
            for p in prefixes:
                got["du", s, p], _ = counted(lambda: rs.du(p, subject=s),
                                             lambda w, r, c: only())
                want_ref["du", s, p] = ref.du(p, subject=s)
                host["du", s, p] = rh.du(p, subject=s)
            if s is None:
                cube, _ = counted(lambda: tier.analytics_cube(now),
                                  lambda w, r, c: only(profile_cube=r * c))
            else:
                cube, _ = counted(
                    lambda: tier.analytics_cube(now, subject=s),
                    lambda w, r, c: only(profile_cube_scoped=r + w,
                                         profile_cube=r * c))
            got["cube", s] = cube.tolist()
            want_ref["cube", s] = ref.analytics_cube(now, subject=s).tolist()
            got["reports", s] = (rs.report_types(subject=s),
                                 rs.top_users(k=5, subject=s),
                                 rs.age_profile(subject=s),
                                 rs.report_user("u6", subject=s))
        pc_h.rebuild(now=now)
        for s in (None,) + TIER_SUBJECTS:
            want_ref["reports", s] = got["reports", s]
            host["reports", s] = (rh.report_types(subject=s),
                                  rh.top_users(k=5, subject=s),
                                  rh.age_profile(subject=s),
                                  rh.report_user("u6", subject=s))
        for key in got:
            check(got[key] == want_ref[key], f"{tag}: {key} differs from "
                  "the unbudgeted store's")
            if key[0] != "cube":
                check(got[key] == host[key], f"{tag}: {key} differs from "
                      "the host fold")
        check(rs.last_fallback_reason is None and rs.host_served == 0,
              f"{tag}: a query fell back: {rs.last_fallback_reason}")
        # budget honesty: the compact tensor holds the resident groups
        tc = tier.tiering_counters()
        br = tier._block_rows()
        chunk = d * tier._window_rows()
        check(tier._buf.shape[0] == tc["resident_groups"]
              == len(tier._slots), f"{tag}: the tensor holds "
              f"{tier._buf.shape[0]} groups, {tc['resident_groups']} are "
              "resident")
        check(tier._buf.shape[0] * tier._rp + 2 * chunk <= budget,
              f"{tag}: {tier._buf.shape[0]} x {tier._rp} rows and the "
              f"window reserve exceed the budget of {budget}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rs.find(crit, subject=TIER_SUBJECTS[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        res_rows = tier._buf.shape[0] * tier._rp
        outputs = 5 * (res_rows + 2 * chunk)    # bool mask + i32 rule
        windows = 2 * chunk * (br * 4 + tier._perm_sp // 8)
        check(peak <= windows + outputs + (4 << 20), f"{tag}: a streamed "
              f"scoped find drew {peak} B on top of the store, more than "
              f"its two windows ({windows} B) and outputs ({outputs} B)")
        store_bytes = tier._buf.nbytes + tier._perm_buf.nbytes + (
            tier._cube_partials.nbytes if tier._cube_partials is not None
            else 0)
        check(tier._buf.nbytes + 2 * chunk * br * 4 <= budget * br * 4,
              f"{tag}: the column tensor and windows exceed the budget")
        wall = time.perf_counter() - t0
        log(f"[store-tiered] (a) {tag} {CARD}: actions equal to numpy's "
            f"({len(rec.calls)}); find, top_files both ways, "
            f"{len(prefixes)} du and the cube, unscoped and for "
            f"{', '.join(TIER_SUBJECTS)}, equal to the unbudgeted store "
            f"and the host folds; a match {match_launches} store-form "
            f"launches (1 + windows streamed); resident gids "
            f"{[g.gid for g in tier._groups if g.resident]}; store tensors "
            f"{store_bytes} B (columns {tier._buf.nbytes}), a streamed "
            f"scoped find {peak} B more; tiering_counters "
            f"{json.dumps(tc)}; round {wall:.2f} s")
        tiered["rounds"].append(dict(tag=tag, tiering=tc,
                                     match_launches=match_launches,
                                     store_bytes=store_bytes,
                                     streamed_peak_bytes=peak, wall_s=wall))
        return tc

    tc = round_("cold")
    check(tc["resident_groups"] == 2 and tc["demoted_groups"] == 2,
          f"cold: {tc['resident_groups']} of {d} groups resident, not 2")

    def group_fids(gid):
        live = np.concatenate([cat.shards[s].fids() for s in
                               range(cat.n_shards) if s % d == gid])
        return rng.choice(live, size=round(ENTRIES * CHURN), replace=False)

    victim = [g.gid for g in tier._groups if not g.resident][0]
    for i in range(3):
        fids = group_fids(victim)
        half = len(fids) // 2
        cat.update_fields_batch(fids[:half].tolist(), atime=NOW)
        cat.update_fields_batch(fids[half:].tolist(), size=1 << 35,
                                atime=NOW - 100 * 86400)
        round_(f"warm {i} (1% on group {victim})")
    check(tier._groups[victim].resident and tier.promotions >= 1
          and tier.demotions >= 3, f"after the churn rounds group "
          f"{victim} is not resident: {tier.tiering_counters()}")
    # async demotion: churn another demoted group; its promotion demotes
    # a resident group on a worker thread
    other = [g.gid for g in tier._groups if not g.resident][0]
    fids = group_fids(other)
    cat.update_fields_batch(fids.tolist(), atime=NOW - 7 * 86400)
    tier.demote_async = True
    d0 = tier.demotions
    tier.refresh()
    tier.drain_demotions()
    tier.demote_async = False
    check(tier.demotions + tier.demote_races > d0, "async: no demotion "
          "was committed or raced")
    round_(f"async (group {other} churned, demotions drained)")
    # structural: 1000 removes and 1000 inserts in one shard of a
    # demoted group (its segment repacks)
    shard = [g for g in tier._groups if not g.resident][0].shard_ids[0]
    live = [int(f) for f in cat.shards[shard].fids()][:1000]
    cat.remove_batch(live)
    new = [f for f in range(2 * ENTRIES + 1, 2 * ENTRIES + 200_000)
           if cat._shard_id(f) == shard][:1000]
    cat.upsert_batch([Entry(fid=f, name=f"t{f}", path=f"/fs/d5/t{f}",
                            type=FsType.FILE, size=(f % 4096) << 24,
                            atime=float(f % (1 << 24)), owner="u3")
                      for f in new])
    r0 = tier.segment_repacks + tier.full_uploads
    round_(f"structural (shard {shard})")
    check(tier.segment_repacks + tier.full_uploads > r0, "structural: "
          "no repack and no upload")
    log(f"[store-tiered] (a) {CARD}: demote_races "
        f"{tier.demote_races}, promotions {tier.promotions}, demotions "
        f"{tier.demotions}, segment_repacks {tier.segment_repacks}; phase "
        f"(a) {time.perf_counter() - t_phase:.2f} s")
    for store in (tier, ref):
        store.detach()
    del tier, ref, rs, pc, rh, pc_h, engines
    results["policy_scan_batch"]["tiered"] = tiered
    store_tiered_scale(torch, device, results, seed)
    log(f"[store-tiered] {CARD}: phase {time.perf_counter() - t_phase:.2f} s")


def store_tiered_scale(torch, device, results, seed: int):
    """Phase (b): bench_tiering's full setting, every group streamed."""
    import numpy as np
    from repro_torch.core import DeviceColumnStore, parse_expr
    t0 = time.perf_counter()
    cat = tiering_catalog(TIER_ENTRIES, seed)
    t_cat = time.perf_counter() - t0
    res = DeviceColumnStore(cat, groups=TIER_GROUPS, device=device)
    tier = DeviceColumnStore(cat, groups=TIER_GROUPS, device=device,
                             hbm_budget_rows=TIER_BUDGET)
    walls = {}
    for name, store in (("resident", res), ("tiered", tier)):
        t1 = time.perf_counter()
        store.refresh()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t1
    tc = tier.tiering_counters()
    check(tc["demoted_groups"] == TIER_GROUPS, f"(b): {tc}")
    seg_bytes = sum(g.segment.nbytes for g in tier._groups)
    expr = parse_expr(TIER_EXPR)
    (f_res, a_res), c_res = launch_window(lambda: res.scan(expr, TIER_NOW))
    check(c_res == only(policy_scan_store=1), f"(b): the resident scan "
          f"launched {c_res}")
    w0 = tier.windows_streamed
    (f_t, a_t), c_t = launch_window(lambda: tier.scan(expr, TIER_NOW))
    dw = tier.windows_streamed - w0
    check(c_t == only(policy_scan_store=dw) and dw > 0, f"(b): the "
          f"streamed scan launched {c_t} for {dw} windows")
    arrays = cat.arrays()
    mask = expr.mask(arrays, cat.strings, TIER_NOW)
    check(np.array_equal(np.sort(f_t), np.sort(f_res))
          and np.array_equal(np.sort(f_t), np.sort(arrays["fid"][mask])),
          "(b): the streamed scan's fids differ from the resident store's "
          "or the host mask's")
    for key in ("count", "size_profile", "any_match"):
        check(a_t[key] == a_res[key], f"(b): {key} {a_t[key]} differs from "
              f"the resident store's {a_res[key]}")
    check(a_t["count"] == int(mask.sum()), "(b): count differs from the "
          "host mask")
    # streamed and resident scans in turns (streamed, resident, resident,
    # streamed), each a host clock ending in a synchronize
    reg, labels = tier.telemetry, tier._tlabels
    spans = ("store.window.stage", "store.window.copy", "store.window.launch")
    hist = {n: reg.histogram("span_seconds", span=n) for n in spans}
    moved = reg.counter("store_bytes_moved", mode="window", **labels)
    for store in (tier, res):                   # one untimed scan each
        store.scan(expr, TIER_NOW)
    torch.cuda.synchronize()
    before = {n: (h.sum, h.count) for n, h in hist.items()}
    m0, s0 = moved.value, tier.window_stalls
    times = {"streamed": [], "resident": []}
    for kind in ("streamed", "resident", "resident", "streamed"):
        store = tier if kind == "streamed" else res
        for _ in range(TIER_REPS):
            t1 = time.perf_counter()
            store.scan(expr, TIER_NOW)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t1)
    n_streamed = 2 * TIER_REPS
    per_scan = {n: (hist[n].sum - before[n][0]) / n_streamed for n in spans}
    calls = {n: (hist[n].count - before[n][1]) / n_streamed for n in spans}
    bytes_scan = (moved.value - m0) / n_streamed
    stalls = tier.window_stalls - s0
    med = {k: statistics.median(v) for k, v in times.items()}
    # the link's bound: one pinned -> device copy of 256 MB, CUDA events
    host = torch.empty(1 << 26, dtype=torch.float32, pin_memory=True)
    dev = torch.empty(1 << 26, dtype=torch.float32, device=device)
    copy_ms, _ = cuda_times_ms(lambda: dev.copy_(host, non_blocking=True),
                               TIER_REPS)
    link = host.nbytes / (copy_ms * 1e-3)
    achieved = bytes_scan / med["streamed"]
    log(f"[store-tiered] (b) {CARD}: {len(cat)} entries, {TIER_SHARDS} "
        f"shards, {TIER_GROUPS} groups, hbm_budget_rows {TIER_BUDGET}: "
        f"catalog built in {t_cat:.2f} s, resident refresh "
        f"{walls['resident']!r} s, tiered refresh (placement, {TIER_GROUPS} "
        f"packs, {seg_bytes} B of segments) {walls['tiered']!r} s; "
        f"tiering_counters {json.dumps(tier.tiering_counters())}")
    log(f"[store-tiered] (b) {CARD}: scan of {TIER_EXPR!r}: {len(f_t)} fids "
        f"identical to the resident store's and the host mask's, count, "
        f"size_profile and any_match equal; {dw} windows a scan, one "
        f"store-form launch each")
    log(f"[store-tiered] (b) {CARD}: scan wall, median of {2 * TIER_REPS} "
        f"in turns (streamed, resident, resident, streamed): streamed "
        f"{med['streamed']!r} s, resident {med['resident']!r} s (ratio "
        f"{med['streamed'] / med['resident']!r}); all "
        f"{json.dumps(times)}; per streamed scan: {dw} windows, "
        f"{bytes_scan!r} B of windows (store_bytes_moved mode=window), "
        f"window_stalls {stalls} in {n_streamed} scans, host seconds "
        f"stage {per_scan[spans[0]]!r} copy {per_scan[spans[1]]!r} launch "
        f"{per_scan[spans[2]]!r} ({calls[spans[0]]:.0f} windows); achieved "
        f"H2D {achieved!r} B/s against a pinned 256 MB copy's "
        f"{link!r} B/s ({copy_ms!r} ms, CUDA events)")
    results["policy_scan_batch"]["tiered_scale"] = dict(
        entries=len(cat), groups=TIER_GROUPS, budget_rows=TIER_BUDGET,
        windows_a_scan=dw, streamed_s=med["streamed"],
        resident_s=med["resident"], window_bytes_a_scan=bytes_scan,
        window_stalls=stalls, span_s_a_scan=per_scan,
        achieved_h2d_bytes_s=achieved, pinned_copy_bytes_s=link)
    tier.detach()
    res.detach()
    del tier, res, cat, host, dev


def store_scale_columns(torch, seed: int, device):
    """The store-reports layout at device scale, ``(8, 21, 2^24)`` f32 on
    the card: each group's 16 kernel columns and validity as
    :func:`make_columns` draws them, then ``ord`` a permutation of the
    group's rows, gid uniform over SCALE_CUBE_GROUPS groups, sb the size's
    bucket and ab uniform in [0, 7)."""
    from repro_torch.core.device_store import (_AB_COL, _GID_COL, _ORD_COL,
                                               _SB_COL)
    from repro_torch.core.policy import KERNEL_COLUMNS
    from repro_torch.kernels.profile_cube import ref as PR
    d, rp = STORE_GROUPS, SCALE_ROWS
    buf = torch.empty((d, _AB_COL + 1, rp), dtype=torch.float32,
                      device=device)
    size = KERNEL_COLUMNS.index("size")
    g = torch.Generator(device=device)
    for i in range(d):
        buf[i, : _ORD_COL] = make_columns(torch, rp, seed * 100 + i, device)
        g.manual_seed(seed * 100 + 50 + i)
        buf[i, _ORD_COL] = torch.randperm(rp, generator=g, device=device)
        buf[i, _GID_COL] = torch.randint(0, SCALE_CUBE_GROUPS, (rp,),
                                         generator=g, device=device)
        buf[i, _SB_COL] = PR.size_buckets(buf[i, size])
        buf[i, _AB_COL] = torch.randint(0, PR.A_BUCKETS, (rp,),
                                        generator=g, device=device)
    return buf


def read_bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def store_scale_phase(torch, device, results, seed: int):
    """The planes' ops at device scale over ``store_scale_columns``:
    (i) the store form on ``BATCH_CRITERIA`` in turns with the 17-row
    layout of the same rows; (ii) ``mesh_profile_cube`` at 7,504 groups;
    (iii) the two-pass top-k on size; (iv) ``mesh_range_aggregate`` on
    random rank bounds. Each held to its reference, timed from an idle
    card beside the rows it reads over the memory rate."""
    from repro_torch.core.catalog import StringTable
    from repro_torch.core.device_store import (_AB_COL, _GID_COL, _ORD_COL,
                                               _SB_COL, _VALID_COL)
    from repro_torch.core.policy import (KERNEL_COLUMNS, compile_programs,
                                         parse_expr)
    from repro_torch.core.types import FsType
    from repro_torch.kernels.policy_scan import kernel as K
    from repro_torch.kernels.policy_scan import ops as PO
    from repro_torch.kernels.policy_scan import ref as R
    from repro_torch.kernels.profile_cube import ops as CO
    from repro_torch.kernels.profile_cube import ref as PR
    t0 = time.perf_counter()
    buf = store_scale_columns(torch, seed, device)
    torch.cuda.synchronize()
    d, n_rows, rp = buf.shape
    n = d * rp
    log(f"[store-scale] columns {tuple(buf.shape)} f32 = "
        f"{buf.numel() * 4 / 1e9:.2f} GB drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    size, blocks = KERNEL_COLUMNS.index("size"), KERNEL_COLUMNS.index("blocks")
    type_col = KERNEL_COLUMNS.index("type")
    valid = buf[:, _VALID_COL] > 0.5
    n_valid = int(valid.sum().item())
    out = {}

    # (i) the store form, 21 rows against the 17-row layout of the rows
    st = StringTable()
    for s in ("u0", "u1", "u2"):
        st.intern(s)
    ops, colidx, operands = compile_programs(
        [parse_expr(e) for e in BATCH_CRITERIA], st, now=NOW)
    prog = [torch.from_numpy(a).to(device) for a in (ops, colidx, operands)]
    kw = dict(size_col=size, blocks_col=blocks, valid_col=_VALID_COL)
    narrow = buf[:, : _ORD_COL].contiguous()
    calls = {}
    for with_agg in (True, False):
        form = "store" if with_agg else "store_lean"
        wide = K.policy_scan_store_cuda(buf, *prog, with_agg=with_agg, **kw)
        thin = K.policy_scan_store_cuda(narrow, *prog, with_agg=with_agg,
                                        **kw)
        plain = R.policy_scan_store_ref(buf, *prog, with_agg=with_agg, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(wide, thin)),
              f"(i) {form}: the 21-row layout differs from the 17-row one")
        check(torch.equal(wide[0], plain[0]) and torch.equal(wide[1],
                                                             plain[1]),
              f"(i) {form}: mask 0 or rule differ from the plain version")
        if with_agg:
            check(torch.allclose(wide[2], plain[2], **TOL),
                  f"(i) {form}: aggregates differ from the plain version")
        err = (wide[2].double() - plain[2].double()).abs().max().item()
        del wide, thin, plain
        shape = K.launch_shape(buf, prog[0], prog[1], with_agg=with_agg, **kw)
        bms, by, nbytes, _ = store_bound_ms(n, shape, ops, with_agg)
        out[form] = dict(bound_ms=bms, bound_by=by, bytes=nbytes,
                         max_abs_err=err,
                         staged_cols=shape["passes"][0]["staged_cols"])
        calls[form, 21] = (lambda a=with_agg: K.policy_scan_store_cuda(
            buf, *prog, with_agg=a, **kw))
        calls[form, 17] = (lambda a=with_agg: K.policy_scan_store_cuda(
            narrow, *prog, with_agg=a, **kw))
    turns = {key: [] for key in calls}
    for key in (("store", 17), ("store", 21), ("store_lean", 17),
                ("store_lean", 21), ("store_lean", 21), ("store_lean", 17),
                ("store", 21), ("store", 17)):
        turns[key].append(cuda_times_ms(calls[key], REPS)[0])
    for form in ("store", "store_lean"):
        o = out[form]
        o["ms_21_rows"] = statistics.median(turns[form, 21])
        o["ms_17_rows"] = statistics.median(turns[form, 17])
        log(f"[store-scale] (i) {form} R={ops.shape[0]} over "
            f"{tuple(buf.shape)} {CARD}: outputs identical to the 17-row layout's and mask 0 / "
            f"rule to the plain version (agg max abs err "
            f"{o['max_abs_err']!r}); 21 rows {o['ms_21_rows']!r} ms (turns "
            f"{turns[form, 21]}), 17 rows {o['ms_17_rows']!r} ms (turns "
            f"{turns[form, 17]}); bound {o['bound_ms']!r} ms by "
            f"{o['bound_by']}, staged {o['staged_cols']}")
    del narrow, calls
    torch.cuda.empty_cache()
    perm = scale_perm(torch, seed, device, d, rp)
    out.update(scoped_scale_forms(torch, K, R, buf, perm, prog, ops, kw))

    # (ii) the cube plane's rebuild: one profile_cube launch a group
    b = max(-(-int(SCALE_CUBE_GROUPS * 1.25) // 8) * 8, 8)
    ckw = dict(n_groups=b, gid_col=_GID_COL, size_col=size,
               blocks_col=blocks, sb_col=_SB_COL, ab_col=_AB_COL,
               valid_col=_VALID_COL)
    (partials, combined), counts = launch_window(
        lambda: CO.mesh_profile_cube(buf, **ckw))
    check(counts == only(profile_cube=d), f"(ii) mesh_profile_cube "
          f"launched {counts}, not {d} profile_cube")
    pkw = dict(n_groups=b, gid_col=0, size_col=1, blocks_col=2, age_col=1,
               sb_col=3, ab_col=4, valid_col=5)
    rows = [_GID_COL, size, blocks, _SB_COL, _AB_COL, _VALID_COL]
    err = 0.0
    for i in range(d):
        sub = buf[i, rows]
        want64 = PR.profile_cube_ref(sub.double(), **pkw).reshape(3, -1)
        want32 = PR.profile_cube_ref(sub, **pkw).reshape(3, -1)
        check(torch.equal(partials[i, 0], want32[0]), f"(ii) group {i}: "
              "counts differ from the plain version")
        check(torch.equal(partials[i], want64), f"(ii) group {i}: sums "
              "differ from the f64 plain version")
        err = max(err, (partials[i].double() - want32.double()).abs()
                  .max().item())
        del sub, want64, want32
    check(torch.equal(combined.reshape(3, -1), partials.sum(0)),
          "(ii) the combined cube is not the partials' sum")
    check(int(combined[0].sum().item()) == n_valid, "(ii) the counts do not "
          "sum to the valid rows")
    cube_call = lambda: CO.mesh_profile_cube(buf, **ckw)  # noqa: E731
    cube_ms, cube_turns = cuda_times_ms(cube_call, REPS)
    dev_ms = cube_device_ms(torch, cube_call)
    plain_ms = cuda_times_ms(lambda: [PR.profile_cube_ref(g, **dict(
        ckw, age_col=size)) for g in buf], REPS)[0]
    cube_bytes = 4 * n + 20 * n_valid + d * 3 * b * 70 * 4
    out["mesh_profile_cube"] = dict(
        groups=b, launches=counts["profile_cube"], ms=cube_ms,
        device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=read_bound_ms(cube_bytes), bound_by="bytes",
        bytes=cube_bytes, max_abs_err_vs_f32_plain=err)
    log(f"[store-scale] (ii) mesh_profile_cube B={b} (distinct "
        f"{SCALE_CUBE_GROUPS}, past the op's cap {CO.MAX_GROUPS}) over "
        f"{d} x {rp} rows {CARD}: {d} launches; counts equal to the plain "
        f"version, sums equal to the f64 plain version (max abs err "
        f"against the f32 plain version {err!r}); {cube_ms!r} ms (calls "
        f"{cube_turns}), the kernels' own ms {json.dumps(dev_ms)}; plain "
        f"{plain_ms!r} ms; bound {read_bound_ms(cube_bytes)!r} ms "
        f"({cube_bytes} B)")
    del partials, combined
    torch.cuda.empty_cache()
    out["mesh_scoped_cube"] = scoped_scale_cube(torch, CO, PR, buf, perm,
                                                ckw, cube_call)
    del perm
    torch.cuda.empty_cache()

    # (iii) the two-pass top-k on size, k = 10 largest
    tkw = dict(col=size, valid_col=_VALID_COL, type_col=type_col,
               file_code=float(int(FsType.FILE)))
    vals, idx = PO.mesh_column_topk(buf, k=10, desc=True, **tkw)
    merged = torch.sort(vals.flatten(), descending=True).values
    thr = float(merged[9])
    mask = PO.mesh_threshold_rows(buf, thr, ge=True, **tkw)
    files = valid & (buf[:, type_col] == float(int(FsType.FILE)))
    ref_sorted = torch.sort(buf[:, size][files], descending=True).values
    check(torch.equal(merged[:10], ref_sorted[:10]), "(iii) the top 10 "
          "sizes differ from a torch.sort of the filtered column")
    check(int(mask.sum().item()) == int((ref_sorted >= thr).sum().item()),
          "(iii) the threshold rows differ from the sorted column's")
    check(bool(torch.equal(buf[:, size].gather(1, idx), vals)),
          "(iii) the top-k indices do not point at their values")
    n_hits = int(mask.sum().item())
    del ref_sorted, files, mask
    topk_ms = cuda_times_ms(lambda: PO.mesh_column_topk(
        buf, k=10, desc=True, **tkw), REPS)[0]
    thr_ms = cuda_times_ms(lambda: PO.mesh_threshold_rows(
        buf, thr, ge=True, **tkw), REPS)[0]
    out["mesh_column_topk"] = dict(ms=topk_ms,
                                   bound_ms=read_bound_ms(12 * n),
                                   bound_by="bytes", bytes=12 * n)
    out["mesh_threshold_rows"] = dict(ms=thr_ms,
                                      bound_ms=read_bound_ms(13 * n),
                                      bound_by="bytes", bytes=13 * n,
                                      rows=n_hits)
    log(f"[store-scale] (iii) top-10 sizes over {d} x {rp} rows {CARD}: "
        f"equal to a torch.sort of the valid file rows, threshold {thr!r} "
        f"recovers the {n_hits} rows at or above it; mesh_column_topk "
        f"{topk_ms!r} ms "
        f"(bound {read_bound_ms(12 * n)!r}), mesh_threshold_rows "
        f"{thr_ms!r} ms (bound {read_bound_ms(13 * n)!r})")

    # (iv) the range aggregate on random rank bounds, against a sort
    g = torch.Generator()
    g.manual_seed(seed + 4)
    ranks = torch.randint(0, rp + 1, (d, 4), generator=g)
    bounds = torch.cat([ranks[:, :2].sort(1).values,
                        ranks[:, 2:].sort(1).values], 1).to(torch.float32)
    akw = dict(ord_col=_ORD_COL, type_col=type_col, size_col=size,
               blocks_col=blocks, valid_col=_VALID_COL,
               file_code=float(int(FsType.FILE)))
    got = PO.mesh_range_aggregate(buf, bounds.numpy(), **akw)
    want = torch.zeros(4, dtype=torch.float64, device=device)
    for i in range(d):
        perm = torch.argsort(buf[i, _ORD_COL])
        lo, hi, lo2, hi2 = (int(v) for v in bounds[i].tolist())
        m = torch.zeros(rp, dtype=torch.bool, device=device)
        m[perm[lo:hi]] = True
        m[perm[lo2:hi2]] = True
        m &= buf[i, _VALID_COL] > 0.5
        f = m & (buf[i, type_col] == float(int(FsType.FILE)))
        want += torch.stack([m.sum().double(), f.sum().double(),
                             buf[i, size][f].double().sum(),
                             buf[i, blocks][f].double().sum()])
        del perm, m, f
    check(torch.equal(got, want), f"(iv) mesh_range_aggregate {got.tolist()}"
          f" differs from the sort's {want.tolist()}")
    agg_ms = cuda_times_ms(lambda: PO.mesh_range_aggregate(
        buf, bounds.numpy(), **akw), REPS)[0]
    out["mesh_range_aggregate"] = dict(ms=agg_ms,
                                       bound_ms=read_bound_ms(20 * n),
                                       bound_by="bytes", bytes=20 * n,
                                       result=got.tolist())
    log(f"[store-scale] (iv) mesh_range_aggregate on random rank bounds "
        f"over {d} x {rp} rows {CARD}: {got.tolist()} equal to the counts "
        f"of a torch.sort on ord; {agg_ms!r} ms (bound "
        f"{read_bound_ms(20 * n)!r})")
    results["policy_scan_batch"]["store_reports_scale"] = {
        k: out[k] for k in ("store", "store_lean")}
    results["policy_scan_batch"]["store_scoped_scale"] = {
        k: out[k] for k in ("store_scoped", "store_scoped_lean")}
    results["profile_cube"]["store_scale"] = out["mesh_profile_cube"]
    results["profile_cube"]["store_scoped_scale"] = out["mesh_scoped_cube"]
    results["profile_cube"]["store_scale_ops"] = {
        k: out[k] for k in ("mesh_column_topk", "mesh_threshold_rows",
                            "mesh_range_aggregate")}
    del buf, valid
    torch.cuda.empty_cache()


SCALE_SUBJECTS = 8               # store-scale: subjects in the plane


def scale_perm(torch, seed: int, device, d: int, rp: int):
    """The permissions plane at device scale, ``(d, 8, rp / 32)`` int32 on
    the card (134 MB at 8 x 2^24 rows): subject 0 sees a random half of
    the rows, subject 1 every row, subject 7 none, the rest random."""
    g = torch.Generator(device=device)
    g.manual_seed(seed * 100 + 77)
    words = torch.randint(0, 1 << 32, (d, SCALE_SUBJECTS, rp // 32),
                          generator=g, device=device, dtype=torch.int64)
    words -= (words >= (1 << 31)).to(torch.int64) << 32
    perm = words.to(torch.int32)
    del words
    perm[:, 1] = -1
    perm[:, SCALE_SUBJECTS - 1] = 0
    return perm


def scoped_scale_forms(torch, K, R, buf, perm, prog, ops, kw) -> dict:
    """(i-s) The scoped store form (subject 0) over the store-reports
    layout, with aggregates and lean: mask 0 and rule identical to the
    plain version, aggregates within TOL; subject 1 (every row) identical
    to the unscoped form and subject 7 (none) empty; timed in turns with
    the unscoped form (unscoped, scoped, scoped, unscoped) beside its
    bound, the unscoped bytes and the plane's D * Rp / 8."""
    d, _, rp = buf.shape
    n = d * rp
    out, calls = {}, {}
    for with_agg in (True, False):
        form = "store_scoped" if with_agg else "store_scoped_lean"
        scoped = K.policy_scan_store_cuda(buf, *prog, with_agg=with_agg,
                                          perm=perm, sid=0, **kw)
        plain = R.policy_scan_store_ref(buf, *prog, with_agg=with_agg,
                                        perm=perm, sid=0, **kw)
        torch.cuda.synchronize()
        check(torch.equal(scoped[0], plain[0])
              and torch.equal(scoped[1], plain[1]), f"(i-s) {form}: mask 0 "
              "or rule differ from the plain version")
        if with_agg:
            check(torch.allclose(scoped[2], plain[2], **TOL),
                  f"(i-s) {form}: aggregates differ from the plain version")
        err = (scoped[2].double() - plain[2].double()).abs().max().item()
        visible = int((scoped[1] >= 0).sum().item())
        del scoped, plain
        every = K.policy_scan_store_cuda(buf, *prog, with_agg=with_agg,
                                         perm=perm, sid=1, **kw)
        unscoped = K.policy_scan_store_cuda(buf, *prog, with_agg=with_agg,
                                            **kw)
        check(all(torch.equal(a, b) for a, b in zip(every, unscoped)),
              f"(i-s) {form}: a subject that sees every row differs from "
              "the unscoped form")
        none = K.policy_scan_store_cuda(buf, *prog, with_agg=with_agg,
                                        perm=perm, sid=SCALE_SUBJECTS - 1,
                                        **kw)
        check(not bool(none[0].any()) and bool((none[1] == -1).all())
              and not bool(none[2][:, 0].any()), f"(i-s) {form}: a subject "
              "that sees no row matched rows")
        del every, unscoped, none
        shape = K.launch_shape(buf, prog[0], prog[1], with_agg=with_agg,
                               scoped=True, **kw)
        _, by, nbytes, operations = store_bound_ms(n, shape, ops, with_agg)
        nbytes += n // 8                     # one subject's words
        t_bytes = read_bound_ms(nbytes)
        t_ops = operations / F32_OPS_PER_S * 1e3
        out[form] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=nbytes, max_abs_err=err,
                         rows_attributed=visible,
                         blocks_per_sm=shape["blocks_per_sm"])
        calls[form, True] = (lambda a=with_agg: K.policy_scan_store_cuda(
            buf, *prog, with_agg=a, perm=perm, sid=0, **kw))
        calls[form, False] = (lambda a=with_agg: K.policy_scan_store_cuda(
            buf, *prog, with_agg=a, **kw))
    turns = {key: [] for key in calls}
    for form in ("store_scoped", "store_scoped_lean"):
        for scoped in (False, True, True, False):
            turns[form, scoped].append(cuda_times_ms(calls[form, scoped],
                                                     REPS)[0])
    for form in ("store_scoped", "store_scoped_lean"):
        o = out[form]
        o["ms"] = statistics.median(turns[form, True])
        o["ms_unscoped"] = statistics.median(turns[form, False])
        o["turns"] = turns[form, True]
        o["turns_unscoped"] = turns[form, False]
        log(f"[store-scale] (i-s) {form} R={ops.shape[0]} over "
            f"{tuple(buf.shape)} with a {tuple(perm.shape)} plane {CARD}: "
            f"mask 0 / rule identical to the plain version (agg max abs "
            f"err {o['max_abs_err']!r}), every-row subject identical to "
            f"the unscoped form, no-row subject empty; scoped "
            f"{o['ms']!r} ms (turns {o['turns']}), unscoped "
            f"{o['ms_unscoped']!r} ms (turns {o['turns_unscoped']}), "
            f"{o['ms'] / o['ms_unscoped']:.4f}x; bound {o['bound_ms']!r} ms "
            f"({o['bytes']} B)")
    return out


def scoped_scale_cube(torch, CO, PR, buf, perm, ckw, cube_call) -> dict:
    """(ii-s) ``mesh_scoped_cube`` for subject 0: counts equal to the plain
    version (the validity row masked by the subject's bits) and sums equal
    to its f64 sums; subject 1 equal to the unscoped cube; timed in turns
    with the unscoped store cube's 8 launches."""
    from repro_torch.kernels.policy_scan.ref import subject_bits
    from repro_torch.core.device_store import (_AB_COL, _GID_COL, _SB_COL,
                                               _VALID_COL)
    from repro_torch.core.policy import KERNEL_COLUMNS
    d, _, rp = buf.shape
    size, blocks = KERNEL_COLUMNS.index("size"), KERNEL_COLUMNS.index("blocks")
    (got, counts) = launch_window(lambda: CO.mesh_scoped_cube(buf, perm, 0,
                                                              **ckw))
    check(counts == only(profile_cube_scoped=d), f"(ii-s) mesh_scoped_cube "
          f"launched {counts}, not {d} scoped profile_cube")
    pkw = dict(n_groups=ckw["n_groups"], gid_col=0, size_col=1, blocks_col=2,
               age_col=1, sb_col=3, ab_col=4, valid_col=5)
    rows = [_GID_COL, size, blocks, _SB_COL, _AB_COL, _VALID_COL]
    want = None
    n_visible = 0
    for i in range(d):
        sub = buf[i, rows].double()
        sub[5] *= subject_bits(perm[i], 0).double()
        n_visible += int(sub[5].sum().item())
        cube = PR.profile_cube_ref(sub, **pkw)
        want = cube if want is None else want + cube
        del sub, cube
    check(torch.equal(got, want), "(ii-s) the scoped cube differs from the "
          "f64 plain version with the validity masked")
    check(int(got[0].sum().item()) == n_visible, "(ii-s) the scoped counts "
          "do not sum to the visible valid rows")
    every = CO.mesh_scoped_cube(buf, perm, 1, **ckw)
    _, unscoped = cube_call()
    check(torch.equal(every, unscoped), "(ii-s) a subject that sees every "
          "row differs from the unscoped cube")
    del want, every, unscoped
    scoped_call = lambda: CO.mesh_scoped_cube(buf, perm, 0, **ckw)  # noqa
    turns = {True: [], False: []}
    for scoped in (False, True, True, False):
        turns[scoped].append(cuda_times_ms(scoped_call if scoped
                                           else cube_call, REPS)[0])
    n = d * rp
    cube_bytes = 4 * n + n // 8 + 20 * n_visible + d * 3 * ckw[
        "n_groups"] * 70 * 4
    o = dict(launches=counts["profile_cube_scoped"],
             ms=statistics.median(turns[True]),
             ms_unscoped=statistics.median(turns[False]),
             turns=turns[True], turns_unscoped=turns[False],
             bound_ms=read_bound_ms(cube_bytes), bound_by="bytes",
             bytes=cube_bytes, visible_rows=n_visible)
    log(f"[store-scale] (ii-s) mesh_scoped_cube B={ckw['n_groups']} over "
        f"{d} x {rp} rows, subject 0 ({n_visible} visible valid rows) "
        f"{CARD}: {d} scoped launches; equal to the f64 plain version, the "
        f"every-row subject equal to the unscoped cube; scoped {o['ms']!r} "
        f"ms (turns {o['turns']}), unscoped {o['ms_unscoped']!r} ms (turns "
        f"{o['turns_unscoped']}), {o['ms'] / o['ms_unscoped']:.4f}x; bound "
        f"{o['bound_ms']!r} ms ({cube_bytes} B)")
    return o


def collect_phase(torch, device, results):
    """The paper's headline scenario (``tests/test_system.py``) on the
    card: a ``LustreSim`` under load mirrored by a ``Scanner`` and two
    ``EventPipeline``s, an ``HsmCoordinator`` whose policies run through
    ``policy_scan_mesh`` over a ``DeviceColumnStore``."""
    from repro_torch.core import (Catalog, DeviceColumnStore, EventPipeline,
                                  HsmCoordinator, PipelineConfig,
                                  PolicyEngine, Reports, Scanner,
                                  StatsAggregator)
    from repro_torch.fs import HsmBackend, LustreSim

    class Clock:
        t = 1_000_000.0

        def __call__(self):
            return self.t
    clock = Clock()
    fs = LustreSim(n_osts=4, ost_capacity=100_000, n_mdts=2,
                   hsm=HsmBackend(), clock=clock)
    home = fs.mkdir(fs.root_fid(), "home")
    users = {u: fs.mkdir(home, u, owner=u) for u in ("ann", "bob")}
    cat = Catalog(n_shards=4)
    stats = StatsAggregator(cat.strings)
    cat.add_delta_hook(stats.on_delta)
    Scanner(fs, cat, n_threads=2).scan()
    pipes = [EventPipeline(fs, cat, fs.changelog.stream(m),
                           PipelineConfig()) for m in range(2)]
    eng = PolicyEngine(cat, clock=clock, device=device)
    coord = HsmCoordinator(fs, cat, eng, archive_age="10s", high_wm=60.0,
                           low_wm=30.0)
    store = DeviceColumnStore(cat, groups=4, device=device)
    eng.attach_device_store(store)
    for name in ("hsm_archive", "hsm_release"):
        eng.policies[name].evaluator = "policy_scan_mesh"
    for i in range(40):
        u = "ann" if i % 2 else "bob"
        f = fs.create(users[u], f"f{i}", owner=u, uid=u, jobid=f"job{i % 3}")
        fs.write(f, 8000, uid=u)
    for p in pipes:
        p.process_once(10000)
    check(len(cat) == fs.count(), "the changelog pipelines did not mirror "
          "the file system")
    ann = [r for r in Reports(cat, stats).report_user("ann")
           if r["type"] == "file"][0]
    check(ann["count"] == 20 and ann["volume"] == 160_000,
          f"report_user('ann') gives {ann}")
    clock.t += 60
    policy = eng.policies["hsm_archive"]
    mesh = store.match(eng._programs(policy, None), clock(), with_agg=False)
    mesh_fids = sorted(mesh.plan(policy.sort_by)[0].tolist())
    mask, _rule, cols, used, _why = eng._match(policy, None, clock(),
                                               "numpy")
    check(used == "numpy" and mesh_fids == sorted(cols["fid"][mask].tolist())
          and len(mesh_fids) == 40, "the archive policy's matches through "
          "the store differ from the numpy evaluator's")
    archived, counts = launch_window(coord.archive_pass)
    check(archived.evaluator == "policy_scan_mesh"
          and not archived.fallback_reason and archived.succeeded == 40,
          f"archive pass: {archived.evaluator} {archived.fallback_reason!r} "
          f"{archived.succeeded}")
    check(counts == only(policy_scan_store_lean=1),
          f"the archive pass launched {counts}")
    purges = coord.space_check()
    check(bool(purges) and all(r.evaluator == "policy_scan_mesh"
                               and not r.fallback_reason for r in purges),
          "the watermark purges did not run through policy_scan_mesh")
    usage = [o.usage_pct for o in fs.osts]
    check(all(u <= 60.0 for u in usage), f"OSTs above the high watermark "
          f"after the purges: {usage}")
    for p in pipes:
        p.process_once(10000)
    released = stats.report_hsm().get("released", {}).get("count", 0)
    check(released > 0, "no release reached the catalog")
    log(f"[collect] headline scenario on the card: 40 files mirrored by "
        f"changelog, archive policy matches through policy_scan_mesh equal "
        f"to numpy's (40), archive pass {archived.succeeded} succeeded in "
        f"one lean store-form launch, {len(purges)} purges, OST usage "
        f"{usage}, {released} released")
    store.detach()


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
    """The kernel's ``out`` against the plain version on the same tensors.
    Returns (bit-identical, max abs err)."""
    from repro_torch.kernels.rglru_scan import ref as RGR
    la, b, h0 = args
    if h0 is None:
        h0 = torch.zeros((la.shape[0], la.shape[2]), device=la.device)
    want = RGR.rglru_ref(la, b, h0)
    if want.numel() == 0:
        return out.shape == want.shape, 0.0
    return (bool(torch.equal(out, want)),
            float((out - want).abs().max().item()))


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


def rglru_fwd_turns(torch, designs, name, shape, la, b, h0) -> dict:
    """The forward at ``shape`` (with h0) through each design's C entry
    point: equal to ``rglru_ref`` bit for bit, then timed in turns
    (``rglru_turns``) beside its bound, with the package kernel's own
    device time (``torch.profiler``)."""
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rglru_scan import ref as RGR
    turns = rglru_turns(designs, rglru_design_calls(
        torch, designs, name, RGR.rglru_ref(la, b, h0),
        lambda v, o: v.fwd(la, b, h0, *o)))
    part = ("rglru_ring_kernel" if RGK.uses_ring(shape[1], shape[2])
            else "rglru_scan_kernel")
    dev = one_kernel_ms(kernel_device_ms(
        torch, lambda: RGK.rglru_scan_cuda(la, b, h0), REPS), part,
        f"rglru_scan {name}")
    bound, by, nbytes, ops = rglru_bound_ms(shape, True)
    out = dict(turns={s: dict(ms=ms, times=t) for s, (ms, t) in
                      turns.items()},
               device_ms=dev, bound_ms=bound, bound_by=by, bytes=nbytes,
               ops=ops)
    log(f"[recurrent] rglru_scan {name} {CARD}, in turns (first, current, "
        f"current, first; C entry point, median of {REPS} each): "
        + "; ".join(f"{s} {ms!r} ms ({bound / ms:.3f} of the bound, min "
                    f"{min(t)!r}, max {max(t)!r})"
                    for s, (ms, t) in turns.items())
        + f"; bound {bound!r} ms by {by} ({nbytes} B, {ops} f32 ops); the "
        f"package kernel's own device time {dev!r} ms (torch.profiler, mean "
        f"of {REPS}); every design equal to rglru_ref bit for bit")
    return out


def recurrent_kernel_phase(torch, seed, device, results, designs=None):
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rglru_scan import ref as RGR
    from repro_torch.kernels.rwkv6_step import kernel as RWK
    from repro_torch.kernels.rwkv6_step import ref as RWR
    designs = designs or rglru_designs()
    rings = {"forward": RGK.ring_shape(False),
             "gradient": RGK.ring_shape(True)}
    log(f"[recurrent] rglru_scan first design (-Xptxas -v; its kernels are "
        f"the package's direct kernels line for line): {json.dumps(designs['first'][1])}")
    log(f"[recurrent] rglru_scan ring kernels on {CARD} (registers and "
        f"local bytes a thread from cudaFuncGetAttributes): "
        f"{json.dumps(rings)}")

    # rglru_scan at recurrentgemma-9b's width, then the ragged shapes and
    # the training path's
    configs = {}
    for i, shape in enumerate((RG_SHAPE,) + RG_RAGGED + (RG_TRAIN,)):
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
            same, err = rglru_agrees(torch, args, got)
            check(same, f"rglru_scan {name}: the kernel differs from the "
                  f"plain version: max abs err {err!r}")
            entry = dict(max_abs_err=err, bit_identical=same,
                         ring=RGK.uses_ring(shape[1], shape[2]))
            if shape == RG_SHAPE and with_h0:
                entry["ms"], times = cuda_times_ms(
                    lambda: RGK.rglru_scan_cuda(*args), REPS)
                entry["plain_ms"], _ = cuda_times_ms(
                    lambda: RGR.rglru_ref(la, b, h0), REPS)
                log(f"[recurrent] rglru_scan {name} {CARD}: kernel "
                    f"{entry['ms']!r} ms through rglru_scan_cuda (median of "
                    f"{len(times)}, min {min(times)!r}, max {max(times)!r}); "
                    f"plain {entry['plain_ms']!r} ms")
            if shape in RG_TURN_SHAPES and with_h0:
                entry.update(rglru_fwd_turns(torch, designs, name, shape, la,
                                             b, h0))
            else:
                log(f"[recurrent] rglru_scan {name}: equal to the plain "
                    f"version bit for bit, twice (ring kernel: "
                    f"{entry['ring']})")
            configs[name] = entry
            del got, again
        del la, b, h0
        torch.cuda.empty_cache()
    main = configs[f"B{RG_SHAPE[0]} S{RG_SHAPE[1]} R{RG_SHAPE[2]} h0"]
    la, b, h0 = rglru_inputs(torch, RG_PATH, seed + 25, device)
    path = path_shape_times(torch, "rglru_scan", RG_PATH,
                            lambda: RGK.rglru_scan_cuda(la, b, h0))
    # the decode step graph-launched, the first design and csrc/ in turns
    graphed = rglru_variants().in_turns(rglru_design_calls(
        torch, designs, f"decode step {RG_PATH}", RGR.rglru_ref(la, b, h0),
        lambda v, o: v.fwd(la, b, h0, *o)), 2, 1,
        lambda fn, _: [graph_call_ms(torch, fn)[0]])
    path["graph_turns"] = {s: dict(ms=statistics.median(t), each_turn=t)
                           for s, t in graphed.items()}
    log(f"[recurrent] rglru_scan decode {RG_PATH} {CARD}, in turns (first, "
        f"current, current, first), graph-launched ms a call: "
        f"{json.dumps(path['graph_turns'])}")
    del la, b, h0
    results["rglru_scan"] = {
        "name": "rglru_scan", "route": "cuda", "source": RG_SOURCE,
        "replaces": TPU_KERNELS["rglru_scan"], "launches": None,
        "max_abs_err": max(c["max_abs_err"] for c in configs.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "error_against": "the plain version on the same tensors "
                         "(torch.equal)",
        "first_design": designs["first"][1], "rings": rings,
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


def decode_attn_bound_ms(B: int, K: int, G: int, hd: int, L: int,
                         rows: int, elt: int = 2):
    """The valid K and V rows read once, q, kv_pos and q_pos read once and
    the output written once, over the memory rate; or 4 * hd f32
    operations (two products, two sums) a valid position and query head
    over the f32 peak. Returns (ms, by, bytes, ops)."""
    nbytes = (2 * B * rows * K * hd * elt + 2 * B * K * G * hd * elt
              + 8 * (L + 1))
    ops = 4 * B * rows * K * G * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def decode_attn_case(torch, shape, pos: int, seed: int, device,
                     flush) -> dict:
    """The kernel at ``shape`` = (B, L, K, G, hd), bf16, the ring's
    positions at ``pos`` under DA_WINDOW: equal to itself bit for bit on a
    second call and to the plain version within one bf16 step (the card
    test's tolerance), then timed from an idle card with the L2 cache
    flushed (CUDA events, median of REPS) beside its kernels' own device
    times, its bound, the plain version and
    ``scaled_dot_product_attention(enable_gqa=True)`` (the library's
    yardstick, which the port never calls); graph-launched too."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    B, L, K, G, hd = shape
    g = torch.Generator(device=device)
    g.manual_seed(seed + pos)
    q = torch.randn((B, 1, K * G, hd), generator=g, device=device).to(
        torch.bfloat16)
    k = torch.randn((B, L, K, hd), generator=g, device=device).to(
        torch.bfloat16)
    v = torch.randn((B, L, K, hd), generator=g, device=device).to(
        torch.bfloat16)
    q_pos = torch.tensor([pos], device=device)
    idx = torch.arange(L, device=device)
    kv_pos = q_pos - torch.remainder(q_pos - idx, L)
    kv_pos = torch.where(kv_pos >= 0, kv_pos, -1)
    kw = dict(causal=True, window=DA_WINDOW)

    def call():
        return DK.decode_attention_cuda(q, k, v, q_pos, kv_pos, **kw)
    out, again = call(), call()
    want = DR.decode_attention_ref(q, k, v, q_pos, kv_pos, **kw)
    torch.cuda.synchronize()
    name = f"B{B} L{L} K{K} G{G} hd{hd} pos {pos}"
    check(torch.equal(out, again), f"decode_attention {name}: the kernel "
          "differs from run to run")
    o, w = out.float(), want.float()
    err = float((o - w).abs().max().item())
    check(bool(((o - w).abs() <= 2.0 ** -7 * torch.maximum(o.abs(), w.abs())
                + 1e-6).all()), f"decode_attention {name}: the kernel "
          f"differs from the plain version by up to {err!r}")
    mask = (kv_pos >= 0) & (kv_pos <= pos) & (kv_pos > pos - DA_WINDOW)
    rows = int(mask.sum().item())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[None, None, None, :], enable_gqa=True)
    lib_err = float((library().transpose(1, 2).float() - w).abs().max()
                    .item())
    ms, times = cuda_times_ms(call, REPS, flush=flush)
    plain_ms, _ = cuda_times_ms(
        lambda: DR.decode_attention_ref(q, k, v, q_pos, kv_pos, **kw), REPS,
        flush=flush)
    lib_ms, _ = cuda_times_ms(library, REPS, flush=flush)
    kern = {k2: v2 for k2, v2 in kernel_device_ms(
        torch, call, REPS, flush=flush).items() if "decode_attention::" in k2}
    check(len(kern) == (2 if DK.splits(B, K, G, L, hd, torch.bfloat16) > 1
                        else 1), f"decode_attention {name}: the profile "
          f"shows the kernels {sorted(kern)}")
    dev = sum(t * n for t, n in kern.values())
    graph_ms, _ = graph_call_ms(torch, call)
    bound, by, nbytes, ops = decode_attn_bound_ms(B, K, G, hd, L, rows)
    shape_info = DK.launch_shape(B, K, G, L, hd, torch.bfloat16)
    entry = dict(shape=list(shape), pos=pos, rows=rows, ms=ms,
                 device_ms=dev, kernels={k2: list(v2) for k2, v2 in
                                         kern.items()},
                 graph_call_ms=graph_ms, plain_ms=plain_ms,
                 library_ms=lib_ms, library_max_abs_err=lib_err,
                 bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
                 max_abs_err=err, launch_shape=shape_info)
    log(f"[decode_attention] {name} bf16 {CARD}: kernel {ms!r} ms from an "
        f"idle card, L2 flushed (median of {len(times)}, min {min(times)!r},"
        f" max {max(times)!r}); own device time {dev!r} ms "
        f"({json.dumps(entry['kernels'])}; torch.profiler); graph-launched "
        f"{graph_ms!r} ms a call; bound {bound!r} ms by {by} ({nbytes} B: "
        f"{rows} valid positions, {ops} f32 ops): {bound / ms:.3f} of it by "
        f"the call, {bound / dev:.3f} by the device time; plain "
        f"{plain_ms!r} ms; scaled_dot_product_attention(enable_gqa=True) "
        f"{lib_ms!r} ms (max abs err {lib_err!r}, not held); max abs err "
        f"{err!r} against the plain version, bit for bit twice; launch "
        f"{json.dumps(shape_info)}")
    return entry


def decode_attn_phase(torch, seed, device, own: dict) -> None:
    """``decode_attention`` (a kernel of the port's own: it counterparts no
    TPU kernel) at mixtral-decode's shape at each of DA_POSITIONS, then at
    DA_LONG's last position; recorded in ``own``."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    cases = {f"pos {pos}": decode_attn_case(torch, DA_SHAPE, pos, seed,
                                            device, flush)
             for pos in DA_POSITIONS}
    cases["long"] = decode_attn_case(torch, DA_LONG, DA_LONG[1] - 1, seed,
                                     device, flush)
    del flush
    main = cases[f"pos {DA_POSITIONS[1]}"]
    own["decode_attention"] = {
        "name": "decode_attention", "route": "cuda", "source": DA_SOURCE,
        "replaces": None, "launches": None,
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "scaled_dot_product_attention(enable_gqa=True) with a "
                   "boolean mask over the cache as it lies",
        "error_against": "the plain version on the same tensors",
        "configs": cases}


def profile_steps(torch, step, cache, nxt, pos: int, n: int) -> dict:
    """``n`` decode steps from ``cache`` under ``torch.profiler``: the wall
    seconds, the count of CUDA operations and the five largest by device
    time."""
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
    return dict(wall_s=wall, kernels=sum(r[2] for r in rows),
                top=[[k[:60], us, c] for k, us, c in rows[:5]])


class OpChecker:
    """Stands in for a kernel op the model calls. It always returns the
    kernel's result; for the first ``first`` calls (the layers call the op
    in order, so one a layer) and every ``every``-th call after, it also
    runs the plain version on the same device tensors and fails the run on
    a mismatch (``agrees``: (ok, max abs err, ...), its last value whether
    the outputs were bit-identical where ok is not that already)."""

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
            self.bit_identical += bool(rest[-1] if rest else ok)
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
        want = only(**{name: want_launches}, **decode_attn_want(
            torch, cfg, times["cache"], new - 1))
        check(counts == want, f"{arch} serving ("
              f"{'graphed' if graphed else 'eager'}) launched {counts}, "
              f"expected {want}")
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
    # a few more steps of each under the profiler: the device operations
    prof = {"graphed": profile_steps(torch, step, b.pop("cache"),
                                     b.pop("next"), pos, PROFILED_STEPS),
            "eager": profile_steps(torch, eager, cache_e, nxt_e,
                                   pos + 1 + EAGER_STEPS, PROFILED_STEPS)}
    del cache_e, nxt_e
    for kind, pr in prof.items():
        log(f"[{arch}] profiled {PROFILED_STEPS} {kind} decode steps "
            f"(torch.profiler): {pr['kernels']} device operations (profiled "
            f"wall {pr['wall_s'] / PROFILED_STEPS * 1e3!r} ms a step); top by "
            f"device time (us) {json.dumps(pr['top'])}")
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
        f"({EAGER_STEPS} steps after the graphed run), "
        f"{ops_a_step['eager']!r} device operations a step; graphed "
        f"{decode_ms!r} ms ({new - 1} steps of run (b)), "
        f"{ops_a_step['graphed']!r} device operations a step; "
        f"{eager_ms / decode_ms:.2f}x")
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
                          rounding_floor=floor,
                          device_ops_a_step=ops_a_step,
                          final_cache_bit_equal=states_equal,
                          peak_bytes=b["peak_bytes"])
    del model, step, a, b
    torch.cuda.empty_cache()


# the training phase: the gradient kernel at the training path's shape
# (microbatch 2 x 2560 tokens of recurrentgemma-9b's d_rnn) and at the
# kernel phase's; recurrentgemma-9b at full width cut to 5 layers (one
# (rec, rec, local) superblock and 2 tail recurrent layers, the smoke
# twin's layout) trained 8 steps through launch/train; then
# tests/test_system.py's restart scenario with recurrentgemma-9b smoke
RG_BWD_SHAPES = ((2, 2560, 4096), (8, 4096, 4096))
TRAIN_LAYERS = 5
TRAIN_ARGV = ["--arch", "recurrentgemma-9b", "--steps", "8", "--batch", "4",
              "--seq", "2560", "--accum", "2", "--lr", "3e-4",
              "--log-interval", "1", "--ckpt-interval", "50"]
RESTART_STEPS = 40
RESTART_FAIL_AT = 17
RESTART_CPU_STEPS = 5
RESTART_LOSS_TOL = 1e-2         # card vs CPU, first 5 losses (absolute)


def rglru_bwd_bound_ms(shape, with_h0: bool):
    """log_a, h and gh read once, dlog_a and db written once (20 B an
    element; h0 read and dh0 written once, 8 B a (b, r)) over the memory
    rate; or 4 f32 operations an element (exp, an add, two multiplies) over
    the f32 peak. Returns (ms, by, bytes, ops)."""
    B, S, R = shape
    nbytes = 20 * B * S * R + (8 * B * R if with_h0 else 0)
    ops = 4 * B * S * R
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def train_kernel_phase(torch, seed, device, results, designs=None):
    """The gradient kernel at RG_BWD_SHAPES, with and without h0: dlog_a,
    db and dh0 equal to ``rglru_bwd_ref`` on the card (``torch.equal``) and
    again on a second call; the forward at the same shape equal to
    ``rglru_ref`` too; timed from an idle card beside its bound and the
    plain version, and in turns with the first design (``rglru_turns``,
    each design's C entry point, each equal to ``rglru_bwd_ref``)."""
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.kernels.rglru_scan import ref as RGR
    designs = designs or rglru_designs()
    configs = {}
    for i, shape in enumerate(RG_BWD_SHAPES):
        la, b, h0 = rglru_inputs(torch, shape, seed + 50 + i, device)
        g = torch.Generator(device=device)
        g.manual_seed(seed + 60 + i)
        gh = torch.randn(shape, generator=g, device=device)
        zeros = torch.zeros_like(h0)
        for with_h0 in (True, False):
            h0_arg = h0 if with_h0 else None
            name = f"B{shape[0]} S{shape[1]} R{shape[2]} " + (
                "h0" if with_h0 else "no h0")
            h = RGK.rglru_scan_cuda(la, b, h0_arg)
            check(torch.equal(h, RGR.rglru_ref(la, b, h0 if with_h0
                                               else zeros)),
                  f"rglru_scan {name}: the forward differs from the plain "
                  "version")
            got = RGK.rglru_scan_bwd_cuda(la, h, gh, h0_arg)
            again = RGK.rglru_scan_bwd_cuda(la, h, gh, h0_arg)
            want = RGR.rglru_bwd_ref(la, h, gh, h0 if with_h0 else zeros)
            torch.cuda.synchronize()
            for part, x, y, w in zip(("dlog_a", "db", "dh0"), got, again,
                                     want):
                check(bool(torch.isfinite(x).all()), f"rglru_scan backward "
                      f"{name}: a non-finite {part}")
                check(torch.equal(x, y), f"rglru_scan backward {name}: "
                      f"{part} differs from run to run")
                check(torch.equal(x, w), f"rglru_scan backward {name}: "
                      f"{part} differs from rglru_bwd_ref: max abs err "
                      f"{float((x - w).abs().max())!r}")
            entry = dict(max_abs_err=0.0, bit_identical=True)
            if with_h0:
                entry["ms"], times = cuda_times_ms(
                    lambda: RGK.rglru_scan_bwd_cuda(la, h, gh, h0), REPS)
                entry["plain_ms"], _ = cuda_times_ms(
                    lambda: RGR.rglru_bwd_ref(la, h, gh, h0), 3, warmup=1)
                (entry["bound_ms"], entry["bound_by"], entry["bytes"],
                 entry["ops"]) = rglru_bwd_bound_ms(shape, True)
                turns = rglru_turns(designs, rglru_design_calls(
                    torch, designs, f"backward {name}", tuple(want),
                    lambda v, o: v.bwd(la, h, gh, h0, *o)))
                entry["turns"] = {s: dict(ms=ms, times=t)
                                  for s, (ms, t) in turns.items()}
                log(f"[train] rglru_scan backward {name} {CARD}, in turns "
                    f"(first, current, current, first; C entry point, "
                    f"median of {REPS} each): " + "; ".join(
                        f"{s} {ms!r} ms ({entry['bound_ms'] / ms:.3f} of the "
                        f"bound, min {min(t)!r}, max {max(t)!r})"
                        for s, (ms, t) in turns.items()))
                log(f"[train] rglru_scan backward {name} {CARD}: kernel "
                    f"{entry['ms']!r} ms (median of {len(times)}, min "
                    f"{min(times)!r}, max {max(times)!r}); plain "
                    f"{entry['plain_ms']!r} ms (median of 3); bound "
                    f"{entry['bound_ms']!r} ms by {entry['bound_by']} "
                    f"({entry['bytes']} B, {entry['ops']} f32 ops); "
                    f"{entry['bound_ms'] / entry['ms']:.3f} of the bound; "
                    "dlog_a, db, dh0 equal to rglru_bwd_ref bit for bit, "
                    "twice; the forward equal to rglru_ref")
            else:
                log(f"[train] rglru_scan backward {name}: dlog_a, db equal "
                    "to rglru_bwd_ref bit for bit, twice; the forward "
                    "equal to rglru_ref")
            configs[name] = entry
            del h, got, again, want
        del la, b, h0, gh, zeros
        torch.cuda.empty_cache()
    path = configs[f"B{RG_BWD_SHAPES[0][0]} S{RG_BWD_SHAPES[0][1]} "
                   f"R{RG_BWD_SHAPES[0][2]} h0"]
    results["rglru_scan"]["backward"] = {
        "name": "rglru_scan_bwd", "route": "cuda", "source": RG_SOURCE,
        "replaces": TPU_KERNELS["rglru_scan"] + " (its gradient: XLA's "
                    "autodiff of jax.lax.associative_scan in the reference)",
        "launches": None, "max_abs_err": 0.0,
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "error_against": "rglru_bwd_ref on the same tensors (torch.equal)",
        "shape": list(RG_BWD_SHAPES[0]), "configs": configs}


def train_full_phase(torch, seed, device, results):
    """recurrentgemma-9b at its published widths, cut to TRAIN_LAYERS
    layers, trained through ``launch.train.run`` (TRAIN_ARGV): every loss
    finite, the mean of the last three below the first, each step exactly
    16 forward and 8 gradient launches of ``rglru_scan`` and no other
    kernel; the step wall, tokens/s, peak memory and, from one profiled
    step, the kernels' share of the card's time."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.rglru_scan import kernel as RGK
    from repro_torch.launch import train as LT
    from repro_torch.models.config import MIX_RGLRU
    from repro_torch.optim import AdamW, cosine_warmup
    from repro_torch.train import make_train_step
    from torch.profiler import ProfilerActivity, profile
    full = get_config("recurrentgemma_9b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    n_rec = sum(s.mix == MIX_RGLRU for s in cfg.layers)
    per_step = []               # (forward, gradient) launches of each step

    def counted_step(model, opt):
        """The launcher's train step, its launches read around each call
        (a wrapper counts on the host as it launches)."""
        step = make_train_step(model, opt)

        def call(state, batch):
            before = (RGK.rglru_scan_launches, RGK.rglru_scan_bwd_launches)
            out = step(state, batch)
            per_step.append((RGK.rglru_scan_launches - before[0],
                             RGK.rglru_scan_bwd_launches - before[1]))
            return out
        return call
    with tempfile.TemporaryDirectory() as ck:
        args = LT.parse_args(TRAIN_ARGV + ["--device", "cuda", "--seed",
                                           str(seed), "--ckpt-dir", ck])
        accum, steps = args.accum, args.steps
        want_fwd = n_rec * accum * 2 * steps    # forward + remat recompute
        want_bwd = n_rec * accum * steps
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        LT.make_train_step = counted_step
        try:
            out, counts = launch_window(lambda: LT.run(args, cfg))
        finally:
            LT.make_train_step = make_train_step
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
    hist, step_s = out["history"], out["step_s"]
    check(out["restarts"] == 0 and len(hist) == steps,
          f"full-width training: {len(hist)} losses, {out['restarts']} "
          "restarts")
    check(all(math.isfinite(x) for x in hist), f"full-width training: a "
          f"non-finite loss in {hist}")
    check(statistics.mean(hist[-3:]) < hist[0], f"full-width training: the "
          f"last three losses {hist[-3:]} do not fall below the first "
          f"{hist[0]!r}")
    check(counts == only(rglru_scan=want_fwd, rglru_scan_bwd=want_bwd),
          f"full-width training launched {counts}, expected {want_fwd} "
          f"rglru_scan and {want_bwd} rglru_scan_bwd ({n_rec} recurrent "
          f"layers x {accum} microbatches x {steps} steps)")
    check(per_step == [(want_fwd // steps, want_bwd // steps)] * steps,
          f"full-width training: launches a step {per_step}, expected "
          f"{want_fwd // steps} forward and {want_bwd // steps} gradient "
          "in each")
    model, state = out["model"], out["state"]
    n_params = sum(p.numel() for p in model.parameters())
    med = statistics.median(step_s[1:])
    tokens = args.batch * args.seq
    # one more step under the profiler: the kernels' share of the card
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=args.seq,
                        global_batch=args.batch, seed=args.seed)
    opt = AdamW(lr=cosine_warmup(args.lr, steps // 10 + 1, steps),
                weight_decay=0.01)
    step = make_train_step(model, opt)
    b = pipe.batch_for(steps)
    batch = {k: torch.from_numpy(v).to(device).reshape(
        accum, args.batch // accum, args.seq) for k, v in b.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    dev_us = sum(r[1] for r in rows)
    kern = {k: (us, c) for k, us, c in rows if "rglru_scan" in k}
    kern_us = sum(us for us, _ in kern.values())
    share = kern_us / dev_us if dev_us else None
    log(f"[train] recurrentgemma-9b full width {CARD}: {cfg.n_layers} of "
        f"{full.n_layers} layers (d_model {cfg.d_model}, d_rnn "
        f"{cfg.rnn_width}, {cfg.n_heads} heads x {cfg.head_dim}, n_kv "
        f"{cfg.n_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
        f"{cfg.window}), {n_params} parameters; {steps} steps of "
        f"{args.batch} x {args.seq} tokens in {accum} microbatches through "
        f"launch.train.run: losses {hist}; step walls {step_s} s, median of "
        f"steps 2-{steps} {med!r} s, {tokens / med!r} tokens/s; peak memory "
        f"{peak} B (torch.cuda.max_memory_allocated); {wall!r} s for the "
        f"run (init included); launches {json.dumps(counts)}, (forward, "
        f"gradient) a step {per_step}")
    log(f"[train] one profiled step {CARD}: {sum(r[2] for r in rows)} device "
        f"operations, {dev_us / 1e3!r} ms of device time; rglru_scan "
        f"kernels {json.dumps(kern)} (us, count) = {kern_us / 1e3!r} ms, "
        f"{share!r} of the device time; top by device time (us) "
        f"{json.dumps([[k[:60], us, c] for k, us, c in rows[:6]])}")
    entry = results["rglru_scan"]
    entry["train"] = dict(
        arch="recurrentgemma_9b", layers=cfg.n_layers,
        reduced="n_layers 38 -> 5", params=n_params, steps=steps,
        batch=args.batch, seq=args.seq, accum=accum, losses=hist,
        step_s=step_s, median_step_s=med, tokens_per_s=tokens / med,
        peak_bytes=peak, launches_per_step={
            "rglru_scan": counts["rglru_scan"] // steps,
            "rglru_scan_bwd": counts["rglru_scan_bwd"] // steps},
        kernel_share=share, profiled_device_ms=dev_us / 1e3)
    entry["backward"]["launches"] = counts["rglru_scan_bwd"]
    entry.setdefault("launches_by_path", {})[
        f"recurrentgemma-9b training, {steps} steps (forward)"] = \
        counts["rglru_scan"]
    del out, step, metrics, prof
    torch.cuda.empty_cache()
    # the [dist] phase goes on from this state (one more step was taken)
    return dict(cfg=cfg, model=model, state=state, args=args,
                next_step=steps + 1)


def train_restart_phase(torch, seed, device, results):
    """``tests/test_system.py::test_train_loop_end_to_end`` on the card with
    recurrentgemma-9b smoke (its RG-LRU layers run both kernels):
    RESTART_STEPS steps, a ``SimulatedFailure`` at RESTART_FAIL_AT,
    checkpoints every 10 with ``keep_last=2``; one restart, the mean of the
    last 5 losses below the first 5, checkpoints retained, exact launches;
    then the first RESTART_CPU_STEPS steps on the CPU (plain versions) from
    the same weights, each loss within RESTART_LOSS_TOL of the card's."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models import Model
    from repro_torch.models.config import MIX_RGLRU
    from repro_torch.optim import AdamW, cosine_warmup
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.fault import SimulatedFailure, run_with_restarts
    from repro_torch.train import init_train_state, make_train_step
    cfg = get_config("recurrentgemma_9b", smoke=True)
    n_rec = sum(s.mix == MIX_RGLRU for s in cfg.layers)

    def drawn():
        """The initial weights, drawn on the CPU from the seed."""
        m = Model(cfg).init(torch.Generator().manual_seed(seed), "cpu")
        return {k: p.detach() for k, p in m.named_parameters()}

    def loop(dev, n_steps, failures, ck):
        model = Model(cfg, kv_chunk=16)
        opt = AdamW(lr=cosine_warmup(3e-3, 10, 60), weight_decay=0.0)
        pipe = DataPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8,
                            seed=3)
        step_fn = make_train_step(model, opt)
        cm = CheckpointManager(ck, keep_last=2)
        losses = []
        weights = drawn()

        def init_state():
            pipe.state.next_step = 0
            gen = torch.Generator(device=dev)
            state = init_train_state(model, opt, gen)
            model.bind_params(weights)
            return state

        def step(state, i):
            if i in failures:
                failures.discard(i)
                raise SimulatedFailure(host=1, step=i)
            b = pipe.batch_for(i)
            batch = {k: torch.from_numpy(v).to(dev)[None]
                     for k, v in b.items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            return state

        final, restarts, replayed = run_with_restarts(
            train_steps=n_steps, step_fn=step, init_state=init_state,
            ckpt=cm, ckpt_interval=10)
        return dict(losses=losses, restarts=restarts, replayed=replayed,
                    steps=cm.steps(), cold=cm.steps(True),
                    usage=cm.store.usage(), final_step=int(final["step"]))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck:
        card, counts = launch_window(lambda: loop(
            device, RESTART_STEPS, {RESTART_FAIL_AT}, ck))
    card_s = time.perf_counter() - t0
    losses = card["losses"]
    ran = RESTART_STEPS + card["replayed"]
    check(card["restarts"] == 1 and card["final_step"] == RESTART_STEPS,
          f"restart loop: {card['restarts']} restarts, final step "
          f"{card['final_step']}")
    check(all(math.isfinite(x) for x in losses), f"restart loop: a "
          f"non-finite loss in {losses}")
    check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          f"restart loop: the last 5 losses {losses[-5:]} do not fall below "
          f"the first 5 {losses[:5]}")
    check(bool(card["steps"]), "restart loop: no checkpoint retained")
    check(counts == only(rglru_scan=2 * n_rec * ran,
                         rglru_scan_bwd=n_rec * ran),
          f"restart loop launched {counts}, expected {2 * n_rec * ran} "
          f"rglru_scan and {n_rec * ran} rglru_scan_bwd ({ran} steps run)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck:
        cpu = loop(torch.device("cpu"), RESTART_CPU_STEPS, set(), ck)
    cpu_s = time.perf_counter() - t0
    diffs = [abs(a - b) for a, b in zip(losses, cpu["losses"])]
    check(len(diffs) == RESTART_CPU_STEPS and max(diffs) <= RESTART_LOSS_TOL,
          f"restart loop: the card's first losses {losses[:5]} differ from "
          f"the CPU's {cpu['losses']} by {diffs} (> {RESTART_LOSS_TOL})")
    log(f"[train] restart loop, recurrentgemma-9b smoke on the card {CARD}: "
        f"{RESTART_STEPS} steps, a failure at {RESTART_FAIL_AT}, "
        f"{card['restarts']} restart, {card['replayed']} steps replayed, "
        f"{card_s!r} s; first 5 losses {losses[:5]}, last 5 "
        f"{losses[-5:]}; checkpoints {card['steps']} (+cold "
        f"{card['cold']}); artifact catalog {json.dumps(card['usage'])}; "
        f"launches {json.dumps(counts)}; the CPU's first {RESTART_CPU_STEPS} "
        f"losses {cpu['losses']} ({cpu_s!r} s), max abs difference "
        f"{max(diffs)!r} <= {RESTART_LOSS_TOL}")
    results["rglru_scan"]["restart_loop"] = dict(
        losses=losses, restarts=card["restarts"], replayed=card["replayed"],
        checkpoints=card["steps"], usage=card["usage"], launches=counts,
        cpu_losses=cpu["losses"], max_cpu_diff=max(diffs))


def train_phase(torch, seed, device, results, designs=None):
    """Returns the full-width phase's model and state, for ``dist_phase``."""
    t0 = time.perf_counter()
    train_kernel_phase(torch, seed, device, results, designs)
    trained = train_full_phase(torch, seed, device, results)
    train_restart_phase(torch, seed, device, results)
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    return trained


# the [dist] phase: the training phase's recurrentgemma-9b state (full
# width, 5 layers) on a 1x1 mesh of a one-rank NCCL group; the dry run of
# recurrentgemma-9b at train_4k on the 16x16 production mesh in a process
# of its own (PyTorch's fake process group, fake tensors: no card)
DIST_STEPS = 2
DRYRUN_ARGV = ["--arch", "recurrentgemma-9b", "--shape",
               "train_4k,decode_32k"]
DRYRUN_CACHE_TOL = 0.01         # decode_32k's cache against a 256th of it
# the decode_32k cell's FLOPs a device at commit d25180a (the PR 28 tree),
# whose serving cells ran the whole batch on one device (python -m
# repro_torch.launch.dryrun --arch recurrentgemma-9b --shape decode_32k;
# fake tensors on the CPU)
DRYRUN_WHOLE_DECODE_FLOPS = 2456721293312.0
# the partitioned serving steps on the 1x1 mesh: arch, prompts, prompt
# tokens, graphed steps, cache_len (recurrentgemma-9b: the training
# phase's 5 layers, its 2048-slot ring)
MESH_SERVE = (("recurrentgemma_9b", 4, 2016, 16, 2048),
              ("rwkv6_1p6b", 8, 512, 16, 528))
DRYRUN_TIMEOUT = 900
DRYRUN_MIN_MODEL_FLOPS = 0.4    # model_vs_counted_flops of the partitioned
DRYRUN_MAX_PEAK = 80e9          # step, and its peak within one card (B)
CHUNK = 1 << 26                 # elements a check takes at once


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_dryrun(out_dir: str):
    """``launch/dryrun.py`` on the CPU in a process of its own (a process
    has one default group: the fake one cannot share the NCCL one's)."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGV,
         "--out-dir", out_dir, "--tag", "chip_smoke"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_dryrun(proc, out_dir: str, card: str) -> dict:
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"[dist] the dry run outlived {DRYRUN_TIMEOUT} s")
    check(proc.returncode == 0, f"[dist] the dry run failed:\n{out[-2000:]}"
          f"\n{err[-3000:]}")
    recs = {}
    for shape in ("train_4k", "decode_32k"):
        name = f"recurrentgemma_9b__{shape}__16x16__chip_smoke.json"
        with open(os.path.join(out_dir, name)) as f:
            recs[shape] = json.load(f)
    rec = recs["train_4k"]
    check(rec["status"] == "ok" and rec["flops_per_device"] > 0 and
          rec["devices"] == 256, f"[dist] dry-run record {rec}")
    # the partitioned step: one device's share of the model's FLOPs, and
    # its peak within one card
    ratio, peak = rec["model_vs_counted_flops"], \
        rec["memory"]["peak_estimate_bytes"]
    check(ratio >= DRYRUN_MIN_MODEL_FLOPS and peak <= DRYRUN_MAX_PEAK,
          f"[dist] dry run: model_vs_counted_flops {ratio!r} (at least "
          f"{DRYRUN_MIN_MODEL_FLOPS}), peak_estimate_bytes {peak} (at most "
          f"{DRYRUN_MAX_PEAK:.0f})")
    # the step ran with the model's own tensors released (tracked, 0 B)
    check(rec["memory"]["model_bytes"] == 0, f"[dist] dry run: the model "
          f"holds {rec['memory']['model_bytes']} B beside the shards")
    colls = {k: {kk: v[kk] for kk in ("count", "bytes", "wire_bytes")}
             for k, v in rec["collectives"].items()}
    log(f"[dist] dry run recurrentgemma-9b train_4k on the 16x16 mesh "
        f"(fake process group, fake tensors; {rec['wall_s']:.1f} s), "
        f"data-sheet estimate beside {card}: per device "
        f"{rec['flops_per_device']!r} FLOPs, "
        f"{rec['bytes_accessed_per_device']!r} B accessed, peak "
        f"{rec['memory']['peak_estimate_bytes']} B (state shards "
        f"{rec['memory']['state_bytes']} B, the model's own tensors "
        f"{rec['memory']['model_bytes']} B); collectives "
        f"{json.dumps(colls)}; roofline compute {rec['compute_s']!r} s, "
        f"memory {rec['memory_s']!r} s, collective {rec['collective_s']!r}"
        f" s, bottleneck {rec['bottleneck']}; model FLOPs a device "
        f"{rec['model_flops_per_device']!r}, model_vs_counted_flops "
        f"{rec['model_vs_counted_flops']!r}")
    keys = ("flops_per_device", "bytes_accessed_per_device", "memory",
            "collectives", "compute_s", "memory_s", "collective_s",
            "bottleneck", "model_flops_per_device", "model_vs_counted_flops",
            "wall_s", "estimate")
    return {"train_4k": {k: rec[k] for k in keys},
            "decode_32k": check_dryrun_decode(recs["decode_32k"], card,
                                              keys)}


def dryrun_decode_want():
    """What recurrentgemma-9b's decode_32k cell on 16x16 must hold a
    device, worked out here from the configuration (no dry run): the
    bytes of the shards ``param_pspecs`` gives rank 0 (the parameters'
    shapes under ``FakeTensorMode``) and a 256th of the whole cache's
    bytes (``init_layer_cache`` on the meta device)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.config import DECODE_32K
    from repro_torch.models.transformer import init_layer_cache
    from repro_torch.runtime.sharding import ShardingRules, profile_for

    class Mesh16:                   # the rules read names and sizes only
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}
    cfg = get_config("recurrentgemma_9b")
    with FakeTensorMode():
        params = dict(Model(cfg).init(torch.Generator().manual_seed(0),
                                      "cpu").named_parameters())
    specs = ShardingRules(cfg, Mesh16(), profile_for(cfg)).param_pspecs(
        params)
    state = 0
    for k, p in params.items():
        n = p.numel()
        for e in specs[k]:
            for axis in (e if isinstance(e, tuple) else (e,)):
                n //= Mesh16.shape.get(axis, 1) if axis else 1
        state += n * p.element_size()
    meta = torch.device("meta")
    cache = sum(t.numel() * t.element_size() for spec in cfg.layers
                for t in init_layer_cache(cfg, spec, DECODE_32K.global_batch,
                                          DECODE_32K.seq_len, meta).values())
    return state, cache / 256


def check_dryrun_decode(rec: dict, card: str, keys) -> dict:
    """The partitioned decode_32k cell: collectives over "model", the
    model's own tensors released, the state and cache one device's
    shards."""
    check(rec["status"] == "ok" and rec["flops_per_device"] > 0,
          f"[dist] dry-run decode record {rec}")
    model_axis = rec["collectives_by_axis"].get("model", {})
    check(model_axis.get("all-reduce", {}).get("count", 0) > 0,
          f"[dist] dry run decode_32k: no all-reduce over 'model' "
          f"({rec['collectives_by_axis']})")
    mem = rec["memory"]
    check(mem["model_bytes"] == 0, f"[dist] dry run decode_32k: the model "
          f"holds {mem['model_bytes']} B beside the shards")
    state, cache = dryrun_decode_want()
    check(mem["state_bytes"] == state, f"[dist] dry run decode_32k: state "
          f"{mem['state_bytes']} B, param_pspecs gives rank 0 {state} B")
    check(abs(mem["cache_bytes"] - cache) <= DRYRUN_CACHE_TOL * cache,
          f"[dist] dry run decode_32k: cache {mem['cache_bytes']} B, a "
          f"256th of the whole is {cache!r} B")
    whole = DRYRUN_WHOLE_DECODE_FLOPS
    log(f"[dist] dry run recurrentgemma-9b decode_32k on the 16x16 mesh, "
        f"partitioned ({rec['wall_s']:.1f} s), data-sheet estimate beside "
        f"{card}: per device {rec['flops_per_device']!r} FLOPs against "
        f"{whole!r} in the PR 28 tree (the whole step on one device; "
        f"{whole / rec['flops_per_device']!r}x), "
        f"{rec['bytes_accessed_per_device']!r} B accessed, state "
        f"{mem['state_bytes']} B (param_pspecs' shards), cache "
        f"{mem['cache_bytes']} B (a 256th: {cache!r}), peak "
        f"{mem['peak_estimate_bytes']} B, model's own tensors 0 B; "
        f"collectives by axis {json.dumps(rec['collectives_by_axis'])}; "
        f"rglru_scan stand-in calls {json.dumps(rec.get('rglru_scan_calls'))}"
        f"; roofline compute {rec['compute_s']!r} s, memory "
        f"{rec['memory_s']!r} s, collective {rec['collective_s']!r} s, "
        f"bottleneck {rec['bottleneck']}")
    return {k: rec[k] for k in keys} | {
        "collectives_by_axis": rec["collectives_by_axis"],
        "rglru_scan_calls": rec.get("rglru_scan_calls"),
        "whole_step_flops_pr28": whole}


def chunks(t):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def host_copy(tree):
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def stop_dryrun(proc, work: str) -> None:
    """Leaves no process and no file behind (the phase may have failed)."""
    import shutil
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    shutil.rmtree(work, ignore_errors=True)


def mesh_serve(torch, device, mesh, model, batch: int, prompt_len: int,
               steps: int, cache_len: int, seed: int, results) -> dict:
    """``model`` (holding its parameters) served unpartitioned, then
    partitioned on the 1x1 ``mesh`` (parameters laid out by
    ``param_pspecs``, the model's own tensors released after): each run a
    ``make_prefill`` of ``batch`` prompts and ``steps`` graphed steps of
    ``make_serve_step``, the prefill's and the steps' launches read in
    windows of their own (the graph captured ahead), each kernel call's
    argument types and shapes recorded. The two runs' logits, tokens and
    final caches must be equal bit for bit, the launches exact (one
    ``rglru_scan`` a recurrent layer in the prefill and a step; one
    ``rwkv6_step`` a layer a step), every call of plain tensors of the
    unpartitioned shapes."""
    import repro_torch.kernels.rglru_scan.ops as RGO
    import repro_torch.kernels.rwkv6_step.ops as RWO
    from repro_torch.models.config import MIX_RGLRU, MIX_RWKV6
    from repro_torch.runtime.partition import Partition
    from repro_torch.runtime.sharding import lay_out_params, profile_for
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.serve.serve_step import GraphedServeStep
    cfg = model.cfg
    n_rec = sum(s.mix == MIX_RGLRU for s in cfg.layers)
    n_rwkv = sum(s.mix == MIX_RWKV6 for s in cfg.layers)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 41)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=device)
    calls = []                  # (op, first argument's shape)
    kinds = set()               # the arguments' types

    def seen(name, op):
        def call(*args, **kw):
            calls.append((name, tuple(args[0].shape)))
            kinds.update(type(t) for t in args if t is not None)
            return op(*args, **kw)
        return call

    def run(params=None, part=None):
        prefill = make_prefill(model, cache_len, params, part)
        step = make_serve_step(model, params, part)
        check(isinstance(step, GraphedServeStep), f"[dist] {cfg.name}: the "
              "serving step on the card is not the graphed step")
        calls.clear()
        kinds.clear()
        plain = RGO.rglru_scan, RWO.rwkv6_step
        RGO.rglru_scan = seen("rglru_scan", plain[0])
        RWO.rwkv6_step = seen("rwkv6_step", plain[1])
        try:
            step.capture(batch, cache_len)      # ahead, as the reference
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (last, cache), pre = launch_window(lambda: prefill(prompt))
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        finally:
            RGO.rglru_scan, RWO.rwkv6_step = plain
        tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        toks, logits = [], []

        def decode():
            nonlocal tok, cache
            for i in range(steps):
                tok, cache = step(cache, tok, prompt_len + i)
                toks.append(tok.clone())
                logits.append(step.logits.clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, dec = launch_window(decode)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        final = [{k: t.clone() for k, t in cb.items()} for cb in cache]
        del step, prefill, cache
        return dict(last=last, toks=toks, logits=logits, cache=final,
                    pre=pre, dec=dec, calls=list(calls), kinds=set(kinds),
                    prefill_s=prefill_s, step_ms=step_ms)

    plain = run()
    params, placements = lay_out_params(
        cfg, mesh, dict(model.named_parameters()), profile_for(cfg))
    model.release_params()          # the steps read the shards only
    part = Partition(mesh, placements, rows_split=True)
    check(part.trivial, "[dist] the 1x1 partition calls collectives")
    laid = run(params, part)
    what = f"[dist] {cfg.name} served on the 1x1 mesh"
    check(torch.equal(laid["last"], plain["last"]) and all(
        torch.equal(a, b) for a, b in zip(laid["logits"], plain["logits"])),
          f"{what}: logits differ from the unpartitioned steps'")
    check(all(torch.equal(a, b) for a, b in zip(laid["toks"],
                                                 plain["toks"])),
          f"{what}: tokens differ from the unpartitioned steps'")
    differ = [(n, k) for n, (a, b) in enumerate(zip(laid["cache"],
                                                    plain["cache"]))
              for k in b if not torch.equal(a[k], b[k])]
    check(not differ, f"{what}: final caches differ {differ[:5]}")
    attn = decode_attn_want(torch, cfg, plain["cache"], steps)
    if n_rec:
        want_pre, want_dec = only(rglru_scan=n_rec), only(
            rglru_scan=n_rec * steps, **attn)
        want_calls = [("rglru_scan", (batch, prompt_len, cfg.rnn_width))] \
            * n_rec + [("rglru_scan", (batch, 1, cfg.rnn_width))] * (
                2 * n_rec)
    else:
        want_pre, want_dec = only(), only(rwkv6_step=n_rwkv * steps, **attn)
        want_calls = [("rwkv6_step", (batch, cfg.n_heads, cfg.head_dim))] \
            * (2 * n_rwkv)
    for r in (plain, laid):
        check(r["pre"] == want_pre and r["dec"] == want_dec,
              f"{what}: launches prefill {r['pre']}, {steps} steps "
              f"{r['dec']}; expected {want_pre} and {want_dec}")
        # the capture's warm-up and capture calls, then the prefill's, of
        # plain tensors (the unpartitioned run's weights are the model's
        # nn.Parameters; no DTensor)
        check(sorted(r["calls"]) == sorted(want_calls),
              f"{what}: kernel calls {sorted(set(r['calls']))}, expected "
              f"{sorted(set(want_calls))}")
        check(r["kinds"] <= {torch.Tensor, torch.nn.Parameter},
              f"{what}: kernel arguments of types {r['kinds']}")
    name = "rglru_scan" if n_rec else "rwkv6_step"
    entry = results[name]
    entry.setdefault("launches_by_path", {})[
        f"[dist] {cfg.name} partitioned serving on a 1x1 mesh ({batch} x "
        f"{prompt_len} prefill + {steps} graphed steps)"] = \
        laid["pre"][name] + laid["dec"][name]
    log(f"{what} {CARD}: {cfg.n_layers} layers, {batch} x {prompt_len} "
        f"prompt tokens + {steps} graphed steps through make_prefill / "
        f"make_serve_step(params=, part=) on param_pspecs' shards (the "
        f"model's own tensors released), logits, tokens and final caches "
        f"equal to the unpartitioned steps' bit for bit; launches prefill "
        f"{laid['pre'][name]}, decode {laid['dec'][name]} "
        f"({laid['dec'][name] // steps} a step); every {name} call of "
        f"plain tensors ({sorted(t.__name__ for t in laid['kinds'])}), "
        f"shapes {sorted({c[1] for c in laid['calls']})}; "
        f"prefill {laid['prefill_s']!r} s (unpartitioned "
        f"{plain['prefill_s']!r}), decode {laid['step_ms']!r} ms a step "
        f"graphed (unpartitioned {plain['step_ms']!r}); tokens of step 16 "
        f"{laid['toks'][-1][:, 0].tolist()}")
    out = {"layers": cfg.n_layers, "batch": batch, "prompt": prompt_len,
           "steps": steps, "launches_prefill": laid["pre"][name],
           "launches_decode": laid["dec"][name],
           "prefill_s": laid["prefill_s"], "step_ms": laid["step_ms"],
           "prefill_s_unpartitioned": plain["prefill_s"],
           "step_ms_unpartitioned": plain["step_ms"]}
    del plain, laid, params
    torch.cuda.empty_cache()
    return out


def dist_phase(torch, device, results, trained, dry, work):
    """The training phase's state (recurrentgemma-9b at full width, 5
    layers) laid out on a 1x1 mesh of a one-rank NCCL group:

    (1) DIST_STEPS unsharded steps (``make_train_step``) from a host copy
    of the state, then the same steps from the same state through
    ``state_shardings`` / ``reshard_state`` and ``make_train_step(
    grad_pspecs=opt_state_pspecs)``, the partitioned step (each rank's
    rows over its shards, the model's own tensors released; on 1x1 every
    collective skipped): losses and
    parameters equal bit for bit (deterministic algorithms on in both, so
    the scatter-adds of the embedding and CE gradients sum in one order),
    exactly 16 forward and 8 gradient ``rglru_scan`` launches a step in
    the mesh's window, every ``rglru_scan`` call given plain tensors (no
    ``DTensor``); (2) the
    int8 error-feedback all-reduce over the group's "data" axis on one
    microbatch's real gradients (f32): ``q`` within [-127, 127], the
    result equal bit for bit to ``decompress_int8(compress_int8(g))`` (one
    rank: the shared scale is the local one), ``g_mean + new_err`` within
    one f32 rounding of each term of ``g + err``; (3) the laid-out state
    saved by ``CheckpointManager`` and restored with ``shardings=`` onto
    the 1x1 mesh: every leaf equal bit for bit; (4) partitioned serving
    on the mesh (``mesh_serve``, MESH_SERVE): the trained model, then
    rwkv6-1.6b drawn from the seed; (5) the dry run ``dry`` (started
    before the builds, on the CPU in a process of its own, writing into
    ``work``) read and printed: the partitioned train step's
    ``model_vs_counted_flops`` at least DRYRUN_MIN_MODEL_FLOPS and its
    ``peak_estimate_bytes`` at most DRYRUN_MAX_PEAK; the partitioned
    decode_32k cell's checks (``check_dryrun_decode``)."""
    t_phase = time.perf_counter()
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import MIX_RGLRU
    from repro_torch.optim import (AdamW, compress_int8, cosine_warmup,
                                   init_error_state,
                                   make_compressed_allreduce)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.elastic import reshard_state, state_shardings
    from repro_torch.runtime.sharding import ShardingRules, profile_for
    from repro_torch.train import make_train_step
    cfg, model, state, args = (trained[k] for k in ("cfg", "model", "state",
                                                    "args"))
    n_rec = sum(s.mix == MIX_RGLRU for s in cfg.layers)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=args.seq,
                        global_batch=args.batch, seed=args.seed)
    opt = AdamW(lr=cosine_warmup(args.lr, args.steps // 10 + 1, args.steps),
                weight_decay=0.01)
    batches = []
    for i in range(DIST_STEPS):
        b = pipe.batch_for(trained["next_step"] + i)
        batches.append({k: torch.from_numpy(v).to(device).reshape(
            args.accum, args.batch // args.accum, args.seq)
            for k, v in b.items()})
    snap = {"params": host_copy(state["params"]),
            "m": host_copy(state["opt"]["m"]),
            "v": host_copy(state["opt"]["v"]),
            "count": state["opt"]["count"].clone(),
            "step": state["step"].clone()}

    def put_back(st):
        with torch.no_grad():
            for part, tree in (("params", st["params"]),
                               ("m", st["opt"]["m"]),
                               ("v", st["opt"]["v"])):
                for k, t in tree.items():
                    t.copy_(snap[part][k])
        st["opt"]["count"] = snap["count"].clone()
        st["step"] = snap["step"].clone()
        return st

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # (1) unsharded, then the same from the same state on the mesh
        step = make_train_step(model, opt)
        plain_losses = []
        for b in batches:
            state, m = step(state, b)
            plain_losses.append(float(m["loss"]))
        plain_params = host_copy(state["params"])
        state = put_back(state)
        torch.cuda.synchronize()
        dist.init_process_group("nccl", init_method="tcp://localhost:"
                                f"{free_port()}", rank=0, world_size=1)
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        rules = ShardingRules(cfg, mesh, profile_for(cfg))
        sh = state_shardings(cfg, mesh, state, rules.profile)
        laid = reshard_state(state, sh)
        model.release_params()      # the partitioned step reads the shards
        step = make_train_step(model, opt, grad_pspecs=rules.opt_state_pspecs(
            laid["params"]))
        mesh_losses = []
        scan_args = []          # (types, shape) of each rglru_scan call
        plain_scan = rglru_ops.rglru_scan

        def seen_scan(log_a, b, h0=None, use_kernel=None):
            scan_args.append((sorted({type(t).__name__ for t in (log_a, b, h0)
                                      if t is not None}),
                              tuple(log_a.shape)))
            return plain_scan(log_a, b, h0, use_kernel)
        t0 = time.perf_counter()

        def run_steps():
            nonlocal laid
            for b in batches:
                laid, m = step(laid, b)
                mesh_losses.append(float(m["loss"]))
        rglru_ops.rglru_scan = seen_scan
        try:
            _, counts = launch_window(run_steps)
        finally:
            rglru_ops.rglru_scan = plain_scan
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    check(all(isinstance(t, DTensor) for t in laid["params"].values()),
          "[dist] the state on the mesh is not DTensors")
    check(mesh_losses == plain_losses, f"[dist] losses on the 1x1 mesh "
          f"{mesh_losses} differ from the unsharded steps' {plain_losses}")
    differ = [k for k, t in laid["params"].items()
              if not torch.equal(t.full_tensor(),
                                 plain_params[k].to(device))]
    check(not differ, f"[dist] parameters on the 1x1 mesh differ from the "
          f"unsharded steps': {differ[:5]}")
    want_fwd, want_bwd = n_rec * args.accum * 2, n_rec * args.accum
    check(counts == only(rglru_scan=want_fwd * DIST_STEPS,
                         rglru_scan_bwd=want_bwd * DIST_STEPS),
          f"[dist] the mesh steps launched {counts}, expected {want_fwd} "
          f"forward and {want_bwd} gradient launches a step")
    scan_shapes = sorted({shape for _, shape in scan_args})
    check(len(scan_args) == want_fwd * DIST_STEPS and all(
        types == ["Tensor"] for types, _ in scan_args),
          f"[dist] rglru_scan calls on the mesh: {len(scan_args)}, given "
          f"{sorted({tuple(t) for t, _ in scan_args})}, expected "
          f"{want_fwd * DIST_STEPS} of plain tensors only")
    del plain_params, snap
    log(f"[dist] recurrentgemma-9b full width, {cfg.n_layers} layers, on a "
        f"1x1 mesh of a one-rank NCCL group {CARD}: {DIST_STEPS} steps "
        f"through state_shardings / reshard_state and make_train_step("
        f"grad_pspecs=opt_state_pspecs), the partitioned step, in "
        f"{mesh_s!r} s, losses {mesh_losses} equal to the unsharded steps' "
        f"bit for bit, every parameter equal bit for bit; launches "
        f"{json.dumps(counts)} ({want_fwd} forward and {want_bwd} gradient "
        f"a step); every rglru_scan call given plain tensors, shapes "
        f"{scan_shapes}")

    # (2) the compressed all-reduce on one microbatch's real gradients
    params = model.bind_params({k: p.to_local()     # held again (copies)
                                for k, p in laid["params"].items()})
    names = list(params)
    loss, _ = model.loss({"tokens": batches[0]["tokens"][0],
                          "labels": batches[0]["labels"][0]})
    grads = dict(zip(names, torch.autograd.grad(
        loss, [params[k] for k in names])))
    del loss
    reduce_tree = make_compressed_allreduce(mesh, "data")
    grads_shape = {k: tuple(g.shape) for k, g in grads.items()}
    big = max(grads_shape, key=lambda k: math.prod(grads_shape[k]))
    worst = dict(q=0, sum_err=0.0, elements=0)
    reduce_ms = 0.0
    for k in names:
        g = {k: grads.pop(k).float()}
        err = init_error_state(g)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        mean, new_err = reduce_tree(g, err)
        end.record()
        torch.cuda.synchronize()
        reduce_ms += start.elapsed_time(end)
        q, scale = compress_int8(g[k] + err[k])
        check(bool((q.abs() <= 127).all()), f"[dist] {k}: q out of range")
        check(torch.equal(mean[k], q.float() * scale / 1),
              f"[dist] {k}: the one-rank all-reduce differs from "
              "compress/decompress")
        for gm, ne, gf in zip(chunks(mean[k]), chunks(new_err[k]),
                              chunks(g[k] + err[k])):
            ulps = (torch.abs(gm).nextafter(torch.tensor(
                float("inf"), device=device)) - torch.abs(gm)) + \
                (torch.abs(ne).nextafter(torch.tensor(
                    float("inf"), device=device)) - torch.abs(ne))
            gap = (gm.double() + ne.double() - gf.double()).abs()
            check(bool((gap <= ulps.double()).all()), f"[dist] {k}: "
                  "g_mean + new_err is not g + err within one f32 "
                  "rounding of each term")
            worst["sum_err"] = max(worst["sum_err"], float(gap.max()))
        worst["q"] = max(worst["q"], int(q.abs().max()))
        worst["elements"] += q.numel()
        if k == big:                # kept for the warm, profiled call
            big_g = g
        del g, err, mean, new_err, q
    # the largest tensor once more, warm, under the profiler: where the
    # time goes (the first calls include the allocator's growth)
    from torch.profiler import ProfilerActivity, profile
    err = init_error_state(big_g)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        reduce_tree(big_g, err)
        end.record()
        torch.cuda.synchronize()
    big_ms = start.elapsed_time(end)
    rows = device_rows(prof)
    big_bound = 16 * big_g[big].numel() / HBM_BYTES_PER_S * 1e3
    del big_g, err, prof
    log(f"[dist] compressed all-reduce over the mesh's data axis (NCCL, one "
        f"rank) {CARD}: {worst['elements']} gradient elements of one "
        f"microbatch in {len(names)} tensors, {reduce_ms!r} ms on the card "
        f"(CUDA events, summed over the tensors, first calls); max |q| "
        f"{worst['q']}; the result equal to decompress(compress(g)) bit for "
        f"bit; max |g_mean + new_err - (g + err)| {worst['sum_err']!r} "
        f"(within one f32 rounding of each term); the largest tensor "
        f"({big}, {math.prod(grads_shape[big])} elements) again, warm: "
        f"{big_ms!r} ms against {big_bound!r} ms to read g and err and "
        f"write g_mean and new_err once (16 B an element), "
        f"{sum(r[1] for r in rows) / 1e3!r}"
        f" ms of device time in {sum(r[2] for r in rows)} operations, top "
        f"(us) {json.dumps([[n[:50], us, c] for n, us, c in rows[:6]])}")

    # (3) elastic restore onto the 1x1 mesh
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=work) as ck:
        cm = CheckpointManager(ck)
        cm.save(laid, DIST_STEPS)
        restored, at = cm.restore(like=laid, shardings=state_shardings(
            cfg, mesh, laid, rules.profile))
    elastic_s = time.perf_counter() - t0
    bad = []

    def same(got, want, path=""):
        if isinstance(want, dict):
            for k in want:
                same(got[k], want[k], f"{path}.{k}")
            return
        if not (isinstance(got, DTensor) and got.dtype == want.dtype and
                torch.equal(got.full_tensor(), want.full_tensor())):
            bad.append(path)
    same(restored, laid)
    check(at == DIST_STEPS and not bad, f"[dist] elastic restore: step {at},"
          f" leaves that differ {bad[:5]}")
    n_leaves = 2 + 3 * len(names)
    del restored
    torch.cuda.empty_cache()
    log(f"[dist] CheckpointManager.save of the laid-out state and restore("
        f"shardings=state_shardings(1x1 mesh)): {n_leaves} leaves equal bit "
        f"for bit, {elastic_s!r} s for both")

    # (4) partitioned serving on the mesh: the trained model (its
    # parameters, not the optimizer's moments), then rwkv6-1.6b drawn
    del laid, state, grads
    torch.cuda.empty_cache()
    serving = {}
    for arch, batch, prompt_len, steps, cache_len in MESH_SERVE:
        t0 = time.perf_counter()
        if arch == cfg.name:
            served = model
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed)
            served = Model(get_config(arch)).init(gen, device)
        serving[arch] = mesh_serve(torch, device, mesh, served, batch,
                                   prompt_len, steps, cache_len, args.seed,
                                   results)
        del served
        serving[arch]["s"] = time.perf_counter() - t0
        log(f"[dist] partitioned serving of {arch}: "
            f"{serving[arch]['s']:.1f} s")
    dist.destroy_process_group()

    # (5) the dry run
    dry_rec = finish_dryrun(dry, work, CARD)
    entry = results["rglru_scan"]
    entry.setdefault("launches_by_path", {})[
        f"[dist] recurrentgemma-9b on a 1x1 mesh, {DIST_STEPS} steps "
        "(forward)"] = counts["rglru_scan"]
    entry["backward"].setdefault("launches_by_path", {})[
        f"[dist] recurrentgemma-9b on a 1x1 mesh, {DIST_STEPS} steps"] = \
        counts["rglru_scan_bwd"]
    log("[dist] " + json.dumps({
        "card": CARD, "losses": mesh_losses, "steps_s": mesh_s,
        "launches": counts, "compressed_allreduce_ms": reduce_ms,
        "compressed_allreduce_warm_ms": {big: big_ms},
        "max_q": worst["q"], "elastic_s": elastic_s, "serving": serving,
        "dryrun": dry_rec}))
    del model, params
    torch.cuda.empty_cache()
    log(f"[dist] phase {time.perf_counter() - t_phase:.1f} s (the dry run "
        f"started before the builds)")


ROUTE_TIE = 2.0 ** -4           # a routing flip's gap: 8 bf16 steps of
                                # the k-th logit at most


class RouteRecorder:
    """Wraps the models' MoE dispatch (``transformer.moe_forward``) and
    keeps each call's routing, recomputed from the call's own inputs with
    the dispatch's own operations: the top-k experts of every token (T, k)
    and the gap between the k-th and the (k+1)-th router logit (T,), with
    the k-th logit's magnitude (T,)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import transformer as T
        self.mod, self.real = T, T.moe_forward

        def dispatch(x, router_w, *args, **kw):
            k = args[3].top_k                      # (w1, w3, w2, moe, ...)
            logits = (x.reshape(-1, x.shape[-1]) @ router_w).float()
            vals, idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
            self.calls.append((idx[:, :k].clone(),
                               (vals[:, k - 1] - vals[:, k]).clone(),
                               vals[:, k - 1].abs().clone()))
            return self.real(x, router_w, *args, **kw)
        T.moe_forward = dispatch
        return self

    def __exit__(self, *exc):
        self.mod.moe_forward = self.real


def route_flips(decode_calls, forward_calls, n_moe: int, batch: int,
                prompt_len: int, seq_len: int) -> dict:
    """Decode step i (i >= 1, the token at position prompt_len + i - 1)
    against the consistency forward's routing of that position, MoE layer
    by layer: step -> [(layer, row, forward gap, decode gap, |k-th
    logit|)] for every token routed to another set of experts (the order
    within the top k does not change the output: each weight follows its
    expert), in layer order (a row's first flip moves its hidden state, so
    its later layers may route it otherwise by any margin).
    ``decode_calls`` are the decode steps' calls in order (n_moe a step),
    ``forward_calls`` the forward's n_moe calls over (batch, seq_len)
    tokens."""
    flips = {}
    for c, (idx, gap, mag) in enumerate(decode_calls):
        i, layer = divmod(c, n_moe)
        fidx, fgap, _ = forward_calls[layer]
        for b in range(batch):
            row = b * seq_len + prompt_len + i
            if not bool((idx[b].sort().values
                         == fidx[row].sort().values).all()):
                flips.setdefault(i + 1, []).append(
                    (layer, b, float(fgap[row]), float(gap[b]),
                     float(mag[b])))
    return flips


def zoo_config(arch: str, layers, int8: bool = False, dropless=False):
    """The published config of ``arch``, cut to ``layers`` layers, with an
    int8 KV cache or a dropless MoE capacity (E / k) if asked."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if dropless and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def zoo_extras(torch, cfg, batch: int, gen, device):
    """Image tokens or encoder frames, N(0, ZOO_EXTRAS_STD) in bf16."""
    n = cfg.n_img_tokens or (cfg.encoder.n_frames if cfg.encoder else 0)
    if not n:
        return None
    x = (torch.randn((batch, n, cfg.d_model), generator=gen, device=device)
         * ZOO_EXTRAS_STD).to(torch.bfloat16)
    return {"img" if cfg.n_img_tokens else "frames": x}


def set_gates(torch, model, value: float) -> int:
    """Every cross-attention gate to ``value``; returns how many."""
    gates = [p for name, p in model.named_parameters()
             if name.endswith("xattn.gate")]
    with torch.no_grad():
        for p in gates:
            p.fill_(value)
    return len(gates)


def zoo_serve_arch(torch, seed, device, arch, layers, batch, prompt_len,
                   new, int8, bf16_run=None) -> dict:
    """Serve one config of ZOO_SERVE through ``make_prefill`` and a decode
    step: run (a) eager (``make_eager_serve_step``, its logits recorded),
    held to one forward over prompt and generated tokens within the
    decode-consistency bound; run (b) the graphed ``make_serve_step``,
    timed: (a)'s tokens, (a)'s final caches bit for bit, its logits within
    the bound; each launches ``decode_attention`` alone
    (``decode_attn_want``). With ``bf16_run`` (the bf16 row's result) the
    int8 cache is also driven teacher-forced over that run's tokens and its
    logits held to that run's within the bound."""
    from repro_torch.models import Model
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.serve.serve_step import (GraphedServeStep,
                                              make_eager_serve_step)
    cfg = zoo_config(arch, layers, int8, dropless=True)
    tag = f"{arch}{' int8 KV' if int8 else ''}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = Model(cfg).init(gen, device)
    n_gates = set_gates(torch, model, ZOO_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    g = torch.Generator(device=device)
    g.manual_seed(seed + 70)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=device)
    extras = zoo_extras(torch, cfg, batch, g, device)
    cache_len = prompt_len + new
    prefill = make_prefill(model, cache_len)
    out = dict(arch=arch, int8=int8, layers=cfg.n_layers,
               published_layers=zoo_config(arch, None).n_layers,
               batch=batch, prompt=prompt_len, new=new, params=n_params,
               param_bytes=param_bytes, init_s=init_s, gates=n_gates)

    routes = RouteRecorder()

    def serve(step, graphed: bool):
        toks = torch.empty((batch, new), dtype=torch.int32, device=device)
        logits = torch.empty((new, batch, cfg.vocab), dtype=torch.float32,
                             device=device)
        rec = LogitRecorder(model)
        times = {}

        def run():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            last, cache = prefill(prompt, extras)
            nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            toks[:, :1].copy_(nxt)
            logits[0].copy_(last)
            for i in range(new - 1):
                nxt, cache = step(cache, nxt, prompt_len + i)
                toks[:, i + 1:i + 2].copy_(nxt)
                if graphed:
                    logits[i + 1].copy_(step.logits)
            torch.cuda.synchronize()
            times["prefill_s"] = t2 - t1
            times["decode_ms"] = (time.perf_counter() - t2) / (new - 1) * 1e3
            return cache

        if graphed:
            cache, counts = launch_window(run)
        else:
            with rec, routes:
                cache, counts = launch_window(run)
            for i, lg in enumerate(rec.logits[1:]):
                logits[i + 1].copy_(lg)
        want = only(**decode_attn_want(torch, cfg, cache, new - 1))
        check(counts == want, f"[zoo-serve] {tag}: the run launched "
              f"{counts}; the model zoo's decode steps launch {want}")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"[zoo-serve] {tag}: tokens outside [0, vocab)")
        return toks, logits, cache, times

    a_toks, a_logits, a_cache, a_times = serve(
        make_eager_serve_step(model), graphed=False)
    # decode consistency: one forward over the prompt and the generated
    # tokens, against the served logits
    seq = torch.cat([prompt, a_toks.long()], dim=1)
    n_moe = sum(s.ffn == "moe" for s in cfg.layers)
    decode_calls = routes.calls[n_moe:]            # after prefill's
    routes.calls = []
    with torch.no_grad(), routes:
        full = model(seq, extras)[0]
    scale = float(torch.maximum(full.amax(), -full.amin()).item()) + 1e-6
    want = full[:, prompt_len - 1:prompt_len - 1 + new].transpose(0, 1)
    del full
    bound = 0.05 * scale + 0.05
    errs = (a_logits - want).abs().amax(dim=(1, 2)).tolist()
    # an MoE token whose decode step routes it to other experts than the
    # forward does (its bf16 router logits tie within the two paths'
    # rounding) is not held to the bound; a row's first flip must be a
    # near tie in both paths, and at most a quarter of the steps may have
    # one
    flips = route_flips(decode_calls, routes.calls, n_moe, batch,
                        prompt_len, seq.shape[1]) if n_moe else {}
    for i, fl in flips.items():
        for b in {row for _, row, *_ in fl}:
            layer, _, fgap, dgap, mag = next(f for f in fl if f[1] == b)
            check(max(fgap, dgap) <= ROUTE_TIE * mag, f"[zoo-serve] {tag}: "
                  f"step {i} routes row {b} of MoE layer {layer} (its first "
                  f"flip) to other experts than the forward, with router "
                  f"logit gaps {fgap!r} (forward) and {dgap!r} (decode) > "
                  f"{ROUTE_TIE} x {mag!r}: not a near tie; the step's flips "
                  f"{fl}")
    check(len(flips) <= new // 4, f"[zoo-serve] {tag}: {len(flips)} of "
          f"{new} steps route a token to other experts than the forward")
    held = [e for i, e in enumerate(errs) if i not in flips]
    check(max(held) < bound, f"[zoo-serve] {tag}: decode consistency "
          f"failed: max err {max(held)!r} >= {bound!r} (scale {scale!r}); "
          f"per step {errs}; steps with a routing flip {sorted(flips)}")
    del decode_calls, routes.calls
    step = make_serve_step(model)
    check(isinstance(step, GraphedServeStep), f"[zoo-serve] {tag}: "
          "make_serve_step on the card is not the graphed step")
    t0 = time.perf_counter()
    step.capture(batch, cache_len)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    b_toks, b_logits, b_cache, b_times = serve(step, graphed=True)
    check(torch.equal(a_toks, b_toks), f"[zoo-serve] {tag}: the graphed run "
          "gave other tokens than the eager run")
    caches_equal = all(torch.equal(x[k], y[k]) for x, y in
                       zip(a_cache, b_cache) for k in x)
    check(caches_equal, f"[zoo-serve] {tag}: the graphed run's final caches "
          "differ from the eager run's")
    errs_b = (b_logits - want).abs().amax(dim=(1, 2)).tolist()
    held_b = [e for i, e in enumerate(errs_b) if i not in flips]
    check(max(held_b) < bound, f"[zoo-serve] {tag}: the graphed run's "
          f"decode consistency failed: max err {max(held_b)!r} >= "
          f"{bound!r}")
    del want, b_logits
    full_layer = next(i for i, s in enumerate(cfg.layers)
                      if s.mix in ("full", "bidir")) if any(
        s.mix in ("full", "bidir") for s in cfg.layers) else None
    kv_bytes = None
    if full_layer is not None:
        c = a_cache[full_layer]
        kv_bytes = c["k"].element_size() * cfg.head_dim + (
            c["kscale"].element_size() if "kscale" in c else 0)
    out.update(a_prefill_s=a_times["prefill_s"],
               eager_decode_ms=a_times["decode_ms"],
               prefill_s=b_times["prefill_s"],
               graphed_decode_ms=b_times["decode_ms"], capture_s=capture_s,
               decode_consistency_err=max(held),
               graphed_decode_consistency_err=max(held_b),
               route_flips={i: dict(err=errs[i], flips=fl)
                            for i, fl in flips.items()},
               bound=bound, kv_bytes_a_token_head=kv_bytes,
               weights_read_ms=param_bytes / HBM_BYTES_PER_S * 1e3,
               tokens=a_toks[0, :8].tolist())
    if bf16_run is not None:
        # teacher-forced over the bf16 run's tokens: its logits within the
        # bound of that run's
        ref_toks, ref_logits = bf16_run["tok_tensor"], bf16_run["logits"]
        ref_scale = float(ref_logits.abs().max().item()) + 1e-6
        ref_bound = 0.05 * ref_scale + 0.05
        with torch.no_grad():
            last, cache = prefill(prompt, extras)
            tf = [float((last - ref_logits[0]).abs().max().item())]
            for i in range(new - 1):
                lg, cache = model.decode_step(
                    cache, ref_toks[:, i:i + 1], prompt_len + i)
                tf.append(float((lg[:, -1] - ref_logits[i + 1]).abs()
                                .max().item()))
        check(max(tf) < ref_bound, f"[zoo-serve] {tag}: the int8 cache's "
              f"logits differ from the bf16 run's by {max(tf)!r} >= "
              f"{ref_bound!r}; per step {tf}")
        out.update(int8_vs_bf16_err=max(tf), int8_vs_bf16_bound=ref_bound,
                   bf16_kv_bytes_a_token_head=bf16_run[
                       "kv_bytes_a_token_head"])
        del cache
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    log(f"[zoo-serve] {tag} {CARD}: {cfg.n_layers} of "
        f"{out['published_layers']} layers (d {cfg.d_model}, "
        f"{cfg.n_heads} heads x {cfg.head_dim}, n_kv {cfg.n_kv}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}"
        + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
           f"{' + shared' if cfg.moe.shared_expert else ''}, capacity "
           f"factor {cfg.moe.capacity_factor} (dropless)" if cfg.moe else "")
        + (f", {n_gates} cross-attention gates at {ZOO_GATE}"
           if n_gates else "")
        + (f", encoder {cfg.encoder.n_layers} layers" if cfg.encoder
           else "")
        + f"), {n_params} parameters ({param_bytes} B) drawn on the card in "
        f"{init_s!r} s; {batch} prompts x ({prompt_len} + {new} new) tokens"
        + (f", extras {next(iter(extras))} "
           f"{tuple(next(iter(extras.values())).shape)} bf16"
           if extras else "")
        + f": prefill {b_times['prefill_s']!r} s (eager run "
        f"{a_times['prefill_s']!r} s), decode {a_times['decode_ms']!r} ms a "
        f"step eager, {b_times['decode_ms']!r} ms graphed (capture "
        f"{capture_s!r} s before the run), against reading the weights once "
        f"{out['weights_read_ms']!r} ms at {HBM_BYTES_PER_S / 1e12} TB/s; "
        f"peak memory {out['peak_bytes']} B")
    log(f"[zoo-serve] {tag}: decode consistency against one forward over "
        f"{seq.shape[1]} tokens: eager max err {max(held)!r}, graphed "
        f"{max(held_b)!r} < {bound!r} (scale {scale!r})"
        + (f"; {sum(len(f) for f in flips.values())} routing flips in "
           f"steps {sorted(flips)} (layer, row, forward gap, decode gap, "
           f"|k-th logit|: {json.dumps(flips)}; their errs "
           f"{[errs[i] for i in sorted(flips)]}, not held)" if n_moe else "")
        + "; tokens equal, final caches equal bit for bit; decode_attention "
        "alone launched" + (f"; KV {kv_bytes} B a (token, head) for k"
                      if kv_bytes else "") + (
            f"; teacher-forced over the bf16 run's tokens the int8 cache's "
            f"logits within {max(tf)!r} < {ref_bound!r} of the bf16 "
            f"run's; KV {kv_bytes} B a (token, head) against "
            f"{bf16_run['kv_bytes_a_token_head']} B in bf16"
            if bf16_run is not None else "")
        + f"; first prompt's tokens {out['tokens']}")
    out["tok_tensor"], out["logits"] = a_toks, a_logits
    del model, step, a_cache, b_cache, prefill
    torch.cuda.empty_cache()
    return out


def zoo_serve_phase(torch, seed, device, zoo: dict):
    """Every ZOO_SERVE row through ``zoo_serve_arch``; an int8 row holds
    its logits to the bf16 row of the same arch before it."""
    t0 = time.perf_counter()
    runs = []
    for arch, layers, batch, prompt_len, new, int8 in ZOO_SERVE:
        prev = runs[-1] if runs and int8 else None
        check(not int8 or (prev is not None and prev["arch"] == arch
                           and not prev["int8"]),
              f"[zoo-serve] the int8 row of {arch} needs its bf16 row first")
        runs.append(zoo_serve_arch(torch, seed, device, arch, layers, batch,
                                   prompt_len, new, int8, prev))
    for r in runs:
        del r["tok_tensor"], r["logits"]
    zoo["serve"] = runs
    torch.cuda.empty_cache()
    log(f"[zoo-serve] phase {time.perf_counter() - t0:.1f} s")


def zoo_train_phase(torch, seed, device, zoo: dict):
    """``make_train_step`` with AdamW (weight decay 0.01) at accum
    ZOO_TRAIN_ACCUM on each ZOO_TRAIN config, the same batch (next-token
    labels; whisper's frames too) for ZOO_TRAIN_STEPS steps: every loss
    finite, the last below the first, mixtral's aux loss nonzero at its
    published capacity, no repo kernel launched."""
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.train import init_train_state, make_train_step
    t0 = time.perf_counter()
    runs = []
    for arch, layers, mb, seq in ZOO_TRAIN:
        cfg = zoo_config(arch, layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        model = Model(cfg)
        opt = AdamW(lr=ZOO_TRAIN_LR, weight_decay=0.01)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        state = init_train_state(model, opt, gen)
        n_gates = set_gates(torch, model, ZOO_GATE)
        n_params = sum(p.numel() for p in model.parameters())
        g = torch.Generator(device=device)
        g.manual_seed(seed + 80)
        tokens = torch.randint(0, cfg.vocab, (ZOO_TRAIN_ACCUM, mb, seq),
                               generator=g, device=device)
        labels = torch.full_like(tokens, -100)
        labels[..., :-1] = tokens[..., 1:]
        batch = {"tokens": tokens, "labels": labels}
        ex = zoo_extras(torch, cfg, ZOO_TRAIN_ACCUM * mb, g, device)
        if ex is not None:
            batch["extras"] = {k: v.reshape(ZOO_TRAIN_ACCUM, mb,
                                            *v.shape[1:])
                               for k, v in ex.items()}
        step = make_train_step(model, opt)
        losses, auxes, walls = [], [], []

        def train():
            nonlocal state
            for _ in range(ZOO_TRAIN_STEPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                auxes.append(float(metrics["aux"]))
                walls.append(time.perf_counter() - t1)
        _, counts = launch_window(train)
        peak = torch.cuda.max_memory_allocated(device)
        tag = f"[zoo-train] {arch}"
        check(counts == only(), f"{tag}: the run launched {counts}; the "
              "model zoo's path has no repo kernel")
        check(all(math.isfinite(x) for x in losses), f"{tag}: a non-finite "
              f"loss in {losses}")
        check(losses[-1] < losses[0], f"{tag}: the losses {losses} do not "
              "fall")
        if cfg.moe is not None:
            check(all(a > 0 for a in auxes), f"{tag}: an aux loss of 0 in "
                  f"{auxes}")
        med = statistics.median(walls[1:])
        n_tok = ZOO_TRAIN_ACCUM * mb * seq
        runs.append(dict(arch=arch, layers=cfg.n_layers,
                         published_layers=zoo_config(arch, None).n_layers,
                         params=n_params, microbatch=mb, seq=seq,
                         accum=ZOO_TRAIN_ACCUM, losses=losses, aux=auxes,
                         step_s=walls, median_step_s=med,
                         tokens_per_s=n_tok / med, peak_bytes=peak))
        log(f"{tag} {CARD}: {cfg.n_layers} of "
            f"{runs[-1]['published_layers']} layers (d {cfg.d_model}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}"
            + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} at "
               f"capacity factor {cfg.moe.capacity_factor}" if cfg.moe
               else "")
            + (f", encoder {cfg.encoder.n_layers} layers over "
               f"{cfg.encoder.n_frames} frames, {n_gates} gates at "
               f"{ZOO_GATE}" if cfg.encoder else "")
            + f"), {n_params} parameters; {ZOO_TRAIN_STEPS} steps of "
            f"{ZOO_TRAIN_ACCUM} microbatches x {mb} x {seq} tokens, AdamW lr "
            f"{ZOO_TRAIN_LR} weight decay 0.01, the same batch: losses "
            f"{losses}, aux {auxes}; step walls {walls} s, median of steps "
            f"2-{ZOO_TRAIN_STEPS} {med!r} s, {n_tok / med!r} tokens/s; peak "
            f"memory {peak} B; no repo kernel launched")
        del model, state, step, batch, opt
        torch.cuda.empty_cache()
    zoo["train"] = runs
    log(f"[zoo-train] phase {time.perf_counter() - t0:.1f} s")


EXAMPLES_DIR = os.path.join(ROOT, "examples")
# what differs between two runs of an example and is not its result: wall
# times, rates and latencies (fs_top's per-second counters and serve
# percentiles), the names of temporary directories, and the five paths
# quickstart's rbh-find lists first: its catalog's fids are the inode
# numbers the OS gives each run's temporary tree, and they order the hits
EXAMPLE_MASKS = (
    (r" *\d+(\.\d+)? ?ms\b", " <ms>"),
    (r" *\d+(\.\d+)? (ev|rows|store queries)/s", r" <rate> \2/s"),
    (r"bytes +\S+ \S+/s", "bytes <rate>/s"),
    (r"rbh_quickstart_\w+", "rbh_quickstart_<tmp>"),
    (r"(?m)^   \S*/rbh_quickstart_<tmp>/\S+$", "   <find hit>"),
)
EXAMPLE_FS_TOP_FRAMES = 2
EXAMPLE_TRAIN_CPU_STEPS = 20    # the CPU's training run, for its wall only


def mask_stdout(text: str) -> str:
    import re
    for pattern, repl in EXAMPLE_MASKS:
        text = re.sub(pattern, repl, text)
    return text


def load_example(name: str, tag: str):
    """A fresh module of ``examples/<name>.py`` (so a patch made for one
    run never reaches another)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_{tag}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, **kw):
    """``mod.main(**kw)`` with stdout captured: (stdout, what main
    returned, wall seconds)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(**kw)
    return buf.getvalue(), out, time.perf_counter() - t0


def serving_recorder(mod, weights=None):
    """Swap ``mod.ServingEngine`` for a subclass that loads ``weights``
    (a state dict) after its own draw and records every step's logits;
    returns the list the engines it makes are appended to."""
    made = []
    base = mod.ServingEngine

    class Recorded(base):
        def __init__(self, cfg, seed=0, device=None):
            super().__init__(cfg, seed=seed, device=device)
            if weights is not None:
                self.model.load_state_dict(weights)
            self.seen = []
            made.append(self)

        def _logits(self, req, token):
            out = super()._logits(req, token)
            self.seen.append(out.detach().float().cpu())
            return out

    mod.ServingEngine = Recorded
    return made


def fs_profiles_kernel_rebuild(torch, device, mod) -> int:
    """The example's catalog rebuilt into a ``ProfileCube(use_kernel=True)``
    on the card: each launch's cube equal to the f64 plain version cast to
    f32 and the counts to the exact host cube's. Returns the launches."""
    from repro_torch.core import ProfileCube
    from repro_torch.kernels.profile_cube import ops as PO
    from repro_torch.kernels.profile_cube import ref as PR
    cat = mod.build_catalog()
    now = time.time()
    calls = []
    launch = PO.profile_cube_cuda

    def recording(cols, **kw):
        out = launch(cols, **kw)
        calls.append((cols, kw, out))
        return out
    PO.profile_cube_cuda = recording
    try:
        cube = ProfileCube(cat, use_kernel=True, device=device)
        _, counts = launch_window(lambda: cube.rebuild(now=now))
    finally:
        PO.profile_cube_cuda = launch
    check(counts == only(profile_cube=cat.n_shards), f"[examples] the "
          f"fs_profiles kernel rebuild launched {counts}, not profile_cube "
          f"once a shard ({cat.n_shards})")
    for cols, kw, out in calls:
        f64 = PR.profile_cube_ref(cols.double(), **kw).float()
        check(torch.equal(out, f64), "[examples] a profile_cube launch of "
              "the fs_profiles rebuild differs from the f64 plain version")
    host = ProfileCube(cat, device="cpu")
    host.rebuild(now=now)
    got, want = cube.report_types(), host.report_types()
    check({k: v["count"] for k, v in got.items()}
          == {k: v["count"] for k, v in want.items()},
          "[examples] the kernel-built cube's counts differ from the host "
          "cube's")
    return counts["profile_cube"]


def examples_phase(torch, device, results):
    """[examples]: every examples/torch_*.py on the card against the CPU."""
    walls, launched, notes = {}, {}, {}

    def both_runs(name, cpu_kw=None, **kw):
        mod = load_example(name, "card")
        (card, out, secs), counts = launch_window(
            lambda: run_example(mod, device=device, **kw))
        cpu_mod = load_example(name, "cpu")
        cpu, cpu_out, cpu_secs = run_example(cpu_mod, device="cpu",
                                             **(cpu_kw or kw))
        walls[name] = {"card_s": secs, "cpu_s": cpu_secs}
        launched[name] = {k: v for k, v in counts.items() if v}
        return mod, card, out, counts, cpu_mod, cpu, cpu_out

    for name in ("torch_quickstart", "torch_lustre_sim_hsm",
                 "torch_fs_profiles"):
        _, card, _, counts, _, cpu, _ = both_runs(name)
        check(mask_stdout(card) == mask_stdout(cpu), f"[examples] {name} "
              "printed on the card what it did not print on the CPU")
        check(counts == only(), f"[examples] {name} launched {counts}")
    launched["torch_fs_profiles (kernel rebuild)"] = {
        "profile_cube": fs_profiles_kernel_rebuild(
            torch, device, load_example("torch_fs_profiles", "rebuild"))}

    name = "torch_fs_top"
    _, card, sweeps, counts, _, cpu, cpu_sweeps = both_runs(
        name, n_frames=EXAMPLE_FS_TOP_FRAMES)
    check(mask_stdout(card) == mask_stdout(cpu), "[examples] torch_fs_top "
          "printed on the card what it did not print on the CPU")
    check([(r.matched, r.matched_volume, r.evaluator) for r in sweeps]
          == [(r.matched, r.matched_volume, r.evaluator)
              for r in cpu_sweeps], "[examples] torch_fs_top's sweeps "
          "matched on the card what they did not match on the CPU")
    check(all(r.evaluator == "policy_scan_mesh" for r in sweeps),
          "[examples] a torch_fs_top sweep left the store")
    check(counts["policy_scan_store_lean"] >= EXAMPLE_FS_TOP_FRAMES,
          f"[examples] torch_fs_top launched the lean store form "
          f"{counts['policy_scan_store_lean']} times in "
          f"{EXAMPLE_FS_TOP_FRAMES} frames")
    notes[name] = {"matched": [r.matched for r in sweeps]}

    name = "torch_serve_kv_tiering"
    card_mod = load_example(name, "card")
    made = serving_recorder(card_mod)
    (card, _, secs), counts = launch_window(
        lambda: run_example(card_mod, device=device))
    (eng,) = made
    weights = {k: v.cpu() for k, v in eng.model.state_dict().items()}
    cpu_mod = load_example(name, "cpu")
    cpu_made = serving_recorder(cpu_mod, weights)
    cpu, _, cpu_secs = run_example(cpu_mod, device="cpu")
    walls[name] = {"card_s": secs, "cpu_s": cpu_secs}
    launched[name] = {k: v for k, v in counts.items() if v}
    steps = len(eng.seen)
    logits, cpu_logits = torch.stack(eng.seen), torch.stack(cpu_made[0].seen)
    if card != cpu:
        flips = (logits.argmax(-1) != cpu_logits.argmax(-1)).nonzero()
        gap = (torch.topk(cpu_logits[int(flips[0, 0])], 2).values.tolist()
               if flips.numel() else "no argmax differs")
        fail(f"[examples] torch_serve_kv_tiering's tokens or tier reports "
             f"differ on the card from the CPU's; the CPU's top-2 logits "
             f"at the first differing step: {gap}")
    check(counts == only(paged_attention=eng.cfg.n_layers * steps),
          f"[examples] torch_serve_kv_tiering launched {counts}, not "
          f"paged_attention {eng.cfg.n_layers} x {steps} token steps")
    notes[name] = {"token_steps": steps, "logits_max_abs_diff": float(
        (logits - cpu_logits).abs().max())}

    name = "torch_train_lm"
    _, _, out, counts, _, _, cpu_out = both_runs(
        name, cpu_kw={"argv": ["--steps", str(EXAMPLE_TRAIN_CPU_STEPS)]},
        argv=[])
    hist = out["history"]
    steps = len(hist)
    check(steps == 200 and all(math.isfinite(x) for x in hist),
          f"[examples] torch_train_lm: {steps} losses, finite: "
          f"{all(math.isfinite(x) for x in hist)}")
    check(all(math.isfinite(x) for x in cpu_out["history"]),
          "[examples] torch_train_lm on the CPU gave a loss that is not "
          "finite")
    want = list(range(50, steps + 1, 50))[-out["ckpt"].keep_last:]
    check(out["ckpt"].steps() == want, f"[examples] torch_train_lm kept "
          f"checkpoints {out['ckpt'].steps()}, not {want}")
    check(counts == only(), f"[examples] torch_train_lm launched {counts}")
    first, last = statistics.fmean(hist[:10]), statistics.fmean(hist[-10:])
    notes[name] = {"steps": steps, "checkpoints": want,
                   "first10_loss": first, "last10_loss": last,
                   "cpu_steps": len(cpu_out["history"])}
    for o in (out, cpu_out):
        shutil.rmtree(o["ckpt"].dir, ignore_errors=True)

    totals = {k: 0 for k in TPU_KERNELS}
    for counts in launched.values():
        for k, v in counts.items():
            base = ("policy_scan_batch" if k.startswith("policy_scan_store")
                    else "profile_cube" if k.startswith("profile_cube")
                    else "rglru_scan" if k.startswith("rglru_scan") else k)
            totals[base] += v
    for k, r in results.items():
        r["examples_launches"] = totals[k]
    check(totals["policy_scan_batch"] > 0 and totals["profile_cube"] > 0
          and totals["paged_attention"] > 0, f"[examples] launches {totals}")
    log("[examples] " + json.dumps({"card": CARD, "wall_s": walls,
                                    "launches": launched, **notes}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

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
    from repro_torch.kernels.decode_attention import kernel as DK
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

    # the dry run on the CPU from here, beside the builds and the kernel
    # phases (timed on the card, not by the host's clock), read by [dist];
    # at exit, whatever the outcome, its process and files go
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dry = start_dryrun(work)
    atexit.register(stop_dryrun, dry, work)

    # 2. build: one nvcc per library, started together
    def timed_build(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=8) as pool:
        first_fut = pool.submit(timed_build, build_first_scan)
        rg_fut = pool.submit(timed_build, build_first_rglru)
        builds = list(pool.map(timed_build, (K.build, PK.build, AK.build,
                                             RGK.build, RWK.build,
                                             DK.build)))
        (first, first_ptxas), first_secs = first_fut.result()
        rg_first, rg_secs = rg_fut.result()
    for lib, secs in builds:
        log(f"[build] {os.path.relpath(lib, ROOT)} in {secs:.2f} s")
    log(f"[build] the first policy_scan design (tools/policy_scan_designs.cu"
        f" v0) in {first_secs:.2f} s: {json.dumps(first_ptxas)}")
    log(f"[build] the first rglru_scan design (tools/rglru_scan_designs.cu)"
        f" in {rg_secs:.2f} s")
    rg_designs = rglru_designs(rg_first)

    # 3.-5. kernels at device scale, 6. the engine's main path, 7. the
    # store engine, 8. the store's reports, 9. collect, 10. reports, 11.
    # paged attention and 12. the recurrent kernels and decode_attention at
    # device scale, 13.
    # paged serving, 14. recurrent-model serving, 15. training, 16.
    # distribution, 17. the rest of the model zoo served, 18. and trained
    results: dict = {}
    own: dict = {}              # kernels that counterpart no TPU kernel
    kernel_phase(torch, args.seed, device, results, first)
    cube_phase(torch, args.seed, device, results)
    attn_phase(torch, args.seed, device, results)
    recurrent_kernel_phase(torch, args.seed, device, results, rg_designs)
    decode_attn_phase(torch, args.seed, device, own)
    t0 = time.perf_counter()
    cat = build_catalog(ENTRIES, args.seed)
    log(f"[engine] catalog of {len(cat)} entries built in "
        f"{time.perf_counter() - t0:.2f} s")
    engine_phase(torch, cat, device, results)
    store_engine_phase(torch, cat, device, results, args.seed)
    store_reports_phase(torch, cat, device, results, args.seed)
    collect_phase(torch, device, results)
    reports_phase(torch, cat, device, results)
    del cat
    serve_phase(torch, args.seed, device, results)
    for arch, batch, prompt_len, new, cache_len in RECURRENT_SERVE:
        recurrent_serve_phase(torch, args.seed, device, results, arch, batch,
                              prompt_len, new, cache_len)
    trained = train_phase(torch, args.seed, device, results, rg_designs)
    dist_phase(torch, device, results, trained, dry, work)
    del trained
    zoo: dict = {}
    zoo_serve_phase(torch, args.seed, device, zoo)
    zoo_train_phase(torch, args.seed, device, zoo)
    examples_phase(torch, device, results)
    check(sorted(results) == sorted(TPU_KERNELS), f"kernels {sorted(results)}"
          f" are not those of {sorted(TPU_KERNELS)}")
    for r in results.values():
        check(r["launches"] is not None and r["launches"] > 0,
              f"{r['name']} was not launched on the main path")
    check(results["policy_scan_batch"]["store_lean_launches"] == 1,
          "the store form was not launched on the policy_scan_mesh path")
    check(results["policy_scan_batch"]["scoped_launches"] == {
        "policy_scan_store_scoped": 1, "policy_scan_store_scoped_lean": 1},
          "the scoped store forms were not launched once on the scoped "
          "scan / find paths")
    check(results["profile_cube"]["scoped_launches"] == STORE_ENGINE_GROUPS,
          "the scoped cube was not launched once a group")
    check(results["rglru_scan"]["backward"]["launches"] > 0,
          "the rglru_scan gradient was not launched on the training path")
    log(f"[total] {card}: every phase held, "
        f"{time.perf_counter() - t_start:.1f} s")
    log("[zoo] " + json.dumps({"card": card, **zoo}))
    log(json.dumps({"card": card, "kernels": list(results.values()),
                    "own_kernels": list(own.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
