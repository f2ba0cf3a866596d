"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell
on PyTorch's fake process group (the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell for 256 or 512 fake XLA
devices and reads XLA's analyses. The port has no compiler to ask, so it
runs the cell's step for rank 0 of a ``"fake"`` process group of 512
ranks (collectives return at once) under ``FakeTensorMode`` (tensors
carry shapes and dtypes, no data): no memory is touched, so full configs
run on the CPU. Per cell:

* the parameters (and a train cell's optimizer moments) placed by
  ``ShardingRules`` on the production mesh (the reference's
  ``BF16_MOMENTS`` and ``ACCUM_OVERRIDES`` kept), the batch by
  ``batch_pspecs`` and a decode cell's cache by ``cache_pspecs``, as the
  reference's ``in_shardings`` place them;
* one step for rank 0 under ``FlopCounterMode``, ``CommDebugMode``
  (:class:`roofline.CollectiveCounter`), :class:`roofline.BytesMode` and
  ``torch.distributed._tools.mem_tracker.MemTracker``: a train step
  (``make_train_step`` with ``grad_pspecs``), a prefill
  (``make_prefill``) or a decode step (``make_serve_step``), each
  partitioned;
* per-device memory from the local shards' sizes (the state, a decode
  cell's cache) and the tracker's peak inside the step (activations,
  gradients, parameters gathered over the data axes, and the model's own
  tensors: ``model_bytes``, 0 in every cell, which releases them once the
  state is laid out, as ``launch/train.py`` does);
* the roofline terms with NVIDIA H100 SXM5 data-sheet constants: an
  estimate, not a measurement.

What the figures mean for the port. Every cell's step is partitioned
(``runtime/partition.py``): rank 0 runs its rows of the batch over its
parameter shards (a decode cell over its cache shard too), so its FLOPs,
bytes and peak are one device's share, as the reference's are; its
collectives are the step's own (the row-parallel and vocab all-reduces,
the gathers of split heads and of the RG-LRU input; in training the
gradients' reduce-scatters over the data axes, ``fsdp``'s gathers, the
sharded optimizer's and the clip norm's; in decoding the partial
attention scores of a cache split over head_dim and the vocab-parallel
argmax). They still differ from XLA's: the bytes are an unfused count of
every operation's operands, and ``FlopCounterMode`` counts matrix
products and attention only. The hand-written kernels (``rglru_scan``)
cannot run on fake tensors: the dry run puts a shape-preserving stand-in
of one elementwise operation in their place (their work is not counted as
FLOPs, as it would not be on the card either) and records its calls'
shapes, each rank's ``(B/dp, S, R/tp)``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod both
"""
import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model, shapes_for
from repro_torch.models.config import ALL_SHAPES, ShapeSpec
from repro_torch.optim import AdamW
from repro_torch.runtime.elastic import reshard_state, state_shardings
from repro_torch.runtime.partition import Partition
from repro_torch.runtime.sharding import (ShardingRules, lay_out_cache,
                                          lay_out_params, profile_for)
from repro_torch.serve import make_prefill, make_serve_step
from repro_torch.train import init_train_state, make_train_step

FAKE_WORLD = 512
DEFAULT_ACCUM = 4
ACCUM_OVERRIDES = {
    "mixtral_8x22b": 8,
    "llama4_maverick_400b_a17b": 8,
    "deepseek_coder_33b": 8,
}
# bf16 adam moments for the 400B model (single-pod memory fit)
BF16_MOMENTS = {"llama4_maverick_400b_a17b"}
ESTIMATE = ("data-sheet estimate (NVIDIA H100 SXM5: bf16 989 TFLOP/s, "
            "HBM3 3.35 TB/s, NVLink 450 GB/s each way), not a measurement")


def _canon(arch: str) -> str:
    return ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")


def start_fake_world(world: int = FAKE_WORLD) -> None:
    """The default process group on PyTorch's ``"fake"`` backend (one
    process, ``world`` ranks, this one rank 0), unless one exists."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def batch_specs(cfg, shape: ShapeSpec, accum: int,
                train: bool = False) -> Dict[str, Any]:
    """Fake batch tensors (call under ``FakeTensorMode``): tokens and
    labels ``(accum, B/accum, S)`` for training, ``(B, S)`` otherwise."""
    B, S = shape.global_batch, shape.seq_len
    mb = B // accum
    lead = (accum,) if (train or accum > 1) else ()
    out: Dict[str, Any] = {
        "tokens": torch.zeros(lead + (mb, S), dtype=torch.int32),
        "labels": torch.zeros(lead + (mb, S), dtype=torch.int32),
    }
    extras = {}
    if cfg.encoder is not None:
        extras["frames"] = torch.zeros(
            lead + (mb, cfg.encoder.n_frames, cfg.d_model),
            dtype=torch.bfloat16)
    if cfg.n_img_tokens:
        extras["img"] = torch.zeros(
            lead + (mb, cfg.n_img_tokens, cfg.d_model), dtype=torch.bfloat16)
    if extras:
        out["extras"] = extras
    return out


@contextlib.contextmanager
def _stand_ins():
    """The ``rglru_scan`` op's place taken by its shapes and dependencies
    in one elementwise operation (fake tensors cannot reach a ``ctypes``
    launch); yields the shape of each call (each forward launch the step
    would make, its remat recomputes included)."""
    calls = []

    def stand_in(log_a, b, h0=None, use_kernel=None):
        calls.append(tuple(log_a.shape))
        return torch.addcmul(b, log_a, torch.zeros((), dtype=b.dtype))
    saved = rglru_ops.rglru_scan
    rglru_ops.rglru_scan = stand_in
    try:
        yield calls
    finally:
        rglru_ops.rglru_scan = saved


def _local_bytes(tree) -> int:
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            t = node.to_local() if isinstance(node, DTensor) else node
            total += t.numel() * t.element_size()
    return total


def run_cell(cfg, shape: ShapeSpec, mesh, accum: int = 1,
             kv_chunk: int = 1024, profile: Optional[str] = None,
             moment_dtype=torch.float32) -> Dict[str, Any]:
    """Trace one step of ``cfg`` at ``shape`` for rank 0 of ``mesh`` (the
    default group must hold the mesh's ranks). Returns the counts: FLOPs,
    bytes, collectives, memory."""
    from torch.distributed._tools.mem_tracker import MemTracker
    rules = ShardingRules(cfg, mesh, profile or profile_for(cfg))
    rec: Dict[str, Any] = {"profile": rules.profile, "accum": accum}
    with FakeTensorMode(), _stand_ins() as scans:
        model = Model(cfg, kv_chunk=kv_chunk).init(
            torch.Generator().manual_seed(0), "cpu")
        if shape.kind == "train":
            opt = AdamW(moment_dtype=moment_dtype)
            state = init_train_state(model, opt,
                                     torch.Generator().manual_seed(0))
            state = reshard_state(state, state_shardings(
                cfg, mesh, state, rules.profile))
            batch = batch_specs(cfg, shape, accum, train=True)
            step = make_train_step(model, opt, grad_pspecs=rules.
                                   opt_state_pspecs(state["params"]))
            model.release_params()      # as the launcher does
            rec["state_bytes"] = _local_bytes(state)

            def run():
                step(state, batch)
        else:
            params, placements = lay_out_params(
                cfg, mesh, dict(model.named_parameters()), rules.profile)
            model.release_params()      # the steps read the shards only
            rec["state_bytes"] = _local_bytes(params)
            B = shape.global_batch
            part = Partition(mesh, placements,
                             rows_split=rules._dp_if(B) is not None)
            if shape.kind == "prefill":
                # the whole batch, each rank's rows taken by batch_pspecs
                batch = batch_specs(cfg, shape, accum=1)
                prefill = make_prefill(model, shape.seq_len, params, part)

                def run():
                    prefill(batch["tokens"], batch.get("extras"))
            else:
                cache, _ = lay_out_cache(cfg, mesh, model.init_cache(
                    B, shape.seq_len))
                rec["cache_bytes"] = _local_bytes(cache)
                serve = make_serve_step(model, params, part)
                tok = torch.zeros((part.local_rows(B), 1),
                                  dtype=torch.int32)

                def run():
                    serve(cache, tok, shape.seq_len - 1)
        flops = FlopCounterMode(display=False)
        comms = roofline.CollectiveCounter()
        nbytes = roofline.BytesMode()
        mem = MemTracker()
        mem.track_external(model)
        t0 = time.perf_counter()
        with mem, flops, comms, nbytes:
            run()
        rec["step_trace_s"] = time.perf_counter() - t0
        if scans:
            rec["rglru_scan_calls"] = {"calls": len(scans),
                                       "shapes": sorted(set(scans))}
        # a released model's parameters sit on "meta": no memory
        peak = mem.get_tracker_snapshot("peak")
        peak = max((v["Total"] for dev, v in peak.items()
                    if torch.device(dev).type != "meta"), default=0)
        model_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters() if p.device.type != "meta")
    rec["flops_per_device"] = float(flops.get_total_flops())
    rec["bytes_accessed_per_device"] = float(nbytes.bytes)
    rec["collectives"] = roofline.parse_collectives(comms)
    rec["collectives_by_axis"] = roofline.collectives_by_axis(comms, mesh)
    rec["collective_tensor_bytes"] = sum(
        d["bytes"] for d in rec["collectives"].values())
    rec["collective_wire_bytes"] = sum(
        d["wire_bytes"] for d in rec["collectives"].values())
    rec["memory"] = {"state_bytes": rec.pop("state_bytes"),
                     "model_bytes": model_bytes,
                     "step_peak_bytes": peak,
                     "peak_estimate_bytes": 0}
    if "cache_bytes" in rec:
        rec["memory"]["cache_bytes"] = rec.pop("cache_bytes")
    # the state's shards live beside the step's peak (which holds the
    # gathered parameters, the gradients and the activations)
    rec["memory"]["peak_estimate_bytes"] = (rec["memory"]["state_bytes"]
                                            + peak)
    rec.update(roofline.roofline_terms(rec["flops_per_device"],
                                       rec["bytes_accessed_per_device"],
                                       rec["collective_wire_bytes"]))
    return rec


def build_cell(arch: str, shape: ShapeSpec, multi_pod: bool,
               accum: Optional[int] = None, kv_chunk: int = 1024,
               profile: Optional[str] = None, moe_groups: int = 0,
               kv_int8: bool = False) -> Dict[str, Any]:
    arch = _canon(arch)
    cfg = get_config(arch)
    if moe_groups:
        cfg = dataclasses.replace(cfg, moe_groups=moe_groups)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    devices = 512 if multi_pod else 256
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16", "devices": devices,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    acc = (accum or ACCUM_OVERRIDES.get(arch, DEFAULT_ACCUM)) \
        if shape.kind == "train" else 1
    t0 = time.perf_counter()
    rec.update(run_cell(cfg, shape, mesh, accum=acc, kv_chunk=kv_chunk,
                        profile=profile,
                        moment_dtype=torch.bfloat16 if arch in BF16_MOMENTS
                        else torch.float32))
    rec["build_s"] = time.perf_counter() - t0
    rec.update(roofline.model_flops(cfg, shape, devices))
    if rec["flops_per_device"]:
        rec["model_vs_counted_flops"] = (rec["model_flops_per_device"]
                                         / rec["flops_per_device"])
    rec["estimate"] = ESTIMATE
    return rec


def iter_cells(archs, shapes, pods):
    for arch in archs:
        cfg = get_config(arch)
        arch_shapes = [s.name for s in shapes_for(cfg)]
        for sname in shapes:
            if sname not in arch_shapes:
                continue
            for multi_pod in pods:
                yield arch, ALL_SHAPES[sname], multi_pod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    help="a shape, a comma-separated list of them, or all")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--accum", type=int, default=0)
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--profile", default=None, choices=[None, "tp", "fsdp"])
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="MoE dispatch groups (0 = config default; set to "
                         "the dp degree for local dispatch)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized decode KV cache")
    ap.add_argument("--remat", default="full", choices=["full", "dots"],
                    help="the reference's remat policy; the port's model "
                         "rematerializes whole blocks (full) either way")
    ap.add_argument("--no-analysis", action="store_true",
                    help="the reference's switch for its loop-unrolled "
                         "compile; the port traces one step either way")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [_canon(args.arch)]
    shapes = list(ALL_SHAPES) if args.shape == "all" else \
        args.shape.split(",")
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]

    start_fake_world()
    os.makedirs(args.out_dir, exist_ok=True)
    ok = fail = 0
    for arch, shape, multi_pod in iter_cells(archs, shapes, pods):
        mesh_tag = "2x16x16" if multi_pod else "16x16"
        name = f"{arch}__{shape.name}__{mesh_tag}"
        if args.tag:
            name += f"__{args.tag}"
        out_path = os.path.join(args.out_dir, name + ".json")
        t0 = time.perf_counter()
        try:
            rec = build_cell(arch, shape, multi_pod,
                             accum=args.accum or None,
                             kv_chunk=args.kv_chunk, profile=args.profile,
                             moe_groups=args.moe_groups,
                             kv_int8=args.kv_int8)
            rec["status"] = "ok"
            ok += 1
            print(f"[OK]   {name}: trace={rec['step_trace_s']:.1f}s"
                  f" peak_mem="
                  f"{rec['memory']['peak_estimate_bytes'] / 2**30:.2f}GiB"
                  f" flops/dev={rec['flops_per_device']:.3e}"
                  f" bottleneck={rec['bottleneck']} ({ESTIMATE})",
                  flush=True)
        except Exception as e:    # one cell's failure is its record
            rec = {"arch": arch, "shape": shape.name, "mesh": mesh_tag,
                   "status": "fail", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            fail += 1
            print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
        rec["wall_s"] = time.perf_counter() - t0
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    print(f"dry-run complete: {ok} ok, {fail} failed", flush=True)
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
