"""Production training launcher (the reference's ``launch/train.py``).

Wires mesh -> sharding rules -> model -> data pipeline -> train step ->
Robinhood-managed checkpoints -> restart loop, from one process (mesh
1x1, no process group) up to a ``DxM`` or ``PxDxM`` mesh over that many
ranks (the same code path the dry run builds).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
        --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir ck
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --smoke --mesh 2x2 --device cpu --ckpt-dir ck      # gloo, 4 ranks

A mesh other than 1x1, any run under ``torchrun`` (``WORLD_SIZE`` set) and
any run in a process whose default group exists trains over a mesh. It
joins the default process group from the environment where none exists
(NCCL on the card, gloo on the CPU; each rank on card ``LOCAL_RANK``),
builds the mesh
(``launch/mesh.py``), the rules with ``profile_for``, and lays the state
out through ``runtime.elastic.state_shardings``; the step lays its
gradient accumulator out by ``opt_state_pspecs`` and partitions its
compute (``train/train_step.py``): every rank draws the step's batch from
the reference's stream (one synthetic int32 batch), the step takes its
rows of each microbatch (``batch_pspecs``) and runs them over its
parameter shards, so the losses are the 1x1 run's up to the order of the
partitioned sums. Once the state is laid out the model's own tensors are
released (``Model.release_params``): a rank holds only its shards. Rank 0
prints and writes the checkpoints.

``--device`` defaults to the card; ``--device cpu`` runs the plain
versions. :func:`run` takes the parsed arguments and, optionally, a config
in place of ``--arch``/``--smoke`` (a depth-cut config, for instance).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_warmup
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import reshard_state, state_shardings
from repro_torch.runtime.fault import run_with_restarts
from repro_torch.runtime.sharding import ShardingRules, profile_for
from repro_torch.train import init_train_state, make_train_step


def mesh_dims(shape_str: str):
    """``"DxM"`` -> ((D, M), ("data", "model")); ``"PxDxM"`` adds "pod"."""
    dims = tuple(int(x) for x in shape_str.split("x"))
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"--mesh {shape_str}: one to three dims")
    return dims, ("pod", "data", "model")[-len(dims):]


def join_group(device: torch.device) -> None:
    """Join the default process group from the ``torchrun`` environment
    (a caller may have joined it already)."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("a mesh needs its ranks: start them with torchrun "
                           "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1",
                    help='mesh shape, e.g. "2x2" or "2x16x16"')
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help='"cuda" (the default) or "cpu"')
    return ap.parse_args(argv)


def run(args: argparse.Namespace, cfg=None) -> dict:
    """Train as the arguments say and print the reference's lines. Returns
    the final state, the model, the loss history, the restarts, the
    checkpoint manager and the wall seconds of each step run."""
    device = resolve_device(args.device)
    dims, axes = mesh_dims(args.mesh)
    mesh = None
    if int(np.prod(dims)) > 1 or "WORLD_SIZE" in os.environ or \
            dist.is_initialized():
        join_group(device)
        if dist.get_world_size() != int(np.prod(dims)):
            raise RuntimeError(f"--mesh {args.mesh} needs "
                               f"{int(np.prod(dims))} ranks, the group has "
                               f"{dist.get_world_size()}")
        mesh = make_mesh(dims, axes, device=device)
    talk = mesh is None or dist.get_rank() == 0
    cfg = get_config(args.arch, smoke=args.smoke) if cfg is None else cfg
    model = Model(cfg, kv_chunk=min(1024, args.seq))
    opt = AdamW(lr=cosine_warmup(args.lr, args.steps // 10 + 1, args.steps),
                weight_decay=0.01)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=args.seq,
                        global_batch=args.batch, seed=args.seed)
    cm = CheckpointManager(args.ckpt_dir, keep_last=3, archive_every=0)
    rules = (ShardingRules(cfg, mesh, profile_for(cfg)) if mesh is not None
             else None)
    # over a mesh the step takes the specs of the state's parameters
    step_fn = make_train_step(model, opt) if rules is None else None

    def lay_out(state):
        """The state on the mesh (the reference's in_shardings)."""
        nonlocal step_fn
        if rules is None:
            return state
        if step_fn is None:
            step_fn = make_train_step(model, opt, grad_pspecs=rules.
                                      opt_state_pspecs(state["params"]))
        laid = reshard_state(state, state_shardings(cfg, mesh, state,
                                                    rules.profile))
        model.release_params()      # the step reads the shards only
        return laid
    t_start = time.time()
    tokens_per_step = args.batch * args.seq
    history: List[float] = []
    step_s: List[float] = []

    def init_state():
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        return lay_out(init_train_state(model, opt, gen))

    def one_step(state, step):
        t0 = time.perf_counter()
        b = pipe.batch_for(step)
        toks = torch.from_numpy(b["tokens"]).to(device).reshape(
            args.accum, args.batch // args.accum, args.seq)
        labels = torch.from_numpy(b["labels"]).to(device).reshape(
            args.accum, args.batch // args.accum, args.seq)
        state, metrics = step_fn(state, {"tokens": toks, "labels": labels})
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        history.append(loss)
        if talk and step % args.log_interval == 0:
            dt = time.time() - t_start
            print(f"step {step:5d} loss {loss:7.4f} "
                  f"({(step + 1) * tokens_per_step / dt:.0f} tok/s)",
                  flush=True)
        return state

    final, restarts, _ = run_with_restarts(
        train_steps=args.steps, step_fn=one_step,
        init_state=init_state, ckpt=cm,
        ckpt_interval=args.ckpt_interval)
    if talk:
        print(f"done: {args.steps} steps, restarts={restarts}, "
              f"first-10 loss {np.mean(history[:10]):.4f} -> "
              f"last-10 loss {np.mean(history[-10:]):.4f}")
        print(f"checkpoints: {cm.steps()} (+cold {cm.steps(True)})")
        print(f"artifact catalog: {cm.store.usage()}")
    return {"state": final, "history": history, "restarts": restarts,
            "ckpt": cm, "model": model, "step_s": step_s}


def main(argv: Optional[List[str]] = None) -> dict:
    joined = dist.is_initialized()
    out = run(parse_args(argv))
    if dist.is_initialized() and not joined:     # run() joined the group
        dist.barrier()              # no rank leaves while another works
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
