"""Production training launcher (the reference's ``launch/train.py``).

Wires config -> model -> optimizer -> data pipeline -> train step ->
Robinhood-managed checkpoints -> restart loop, on one card (mesh 1x1;
the reference's larger meshes wait for ``launch/mesh.py`` and
``runtime/sharding.py``, ROADMAP.md queue 1 item 12).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
        --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir ck

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

from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_warmup
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import run_with_restarts
from repro_torch.train import init_train_state, make_train_step


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
                    help='mesh shape; one card: "1x1" only')
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
    if args.mesh != "1x1":
        raise ValueError(f"--mesh {args.mesh}: the port runs on one card "
                         "(1x1); meshes wait for launch/mesh.py and "
                         "runtime/sharding.py (ROADMAP.md queue 1 item 12)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke) if cfg is None else cfg
    model = Model(cfg, kv_chunk=min(1024, args.seq))
    opt = AdamW(lr=cosine_warmup(args.lr, args.steps // 10 + 1, args.steps),
                weight_decay=0.01)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=args.seq,
                        global_batch=args.batch, seed=args.seed)
    cm = CheckpointManager(args.ckpt_dir, keep_last=3, archive_every=0)

    step_fn = make_train_step(model, opt)
    t_start = time.time()
    tokens_per_step = args.batch * args.seq
    history: List[float] = []
    step_s: List[float] = []

    def init_state():
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        return init_train_state(model, opt, gen)

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
        if step % args.log_interval == 0:
            dt = time.time() - t_start
            print(f"step {step:5d} loss {loss:7.4f} "
                  f"({(step + 1) * tokens_per_step / dt:.0f} tok/s)",
                  flush=True)
        return state

    final, restarts, _ = run_with_restarts(
        train_steps=args.steps, step_fn=one_step,
        init_state=init_state, ckpt=cm,
        ckpt_interval=args.ckpt_interval)
    print(f"done: {args.steps} steps, restarts={restarts}, "
          f"first-10 loss {np.mean(history[:10]):.4f} -> "
          f"last-10 loss {np.mean(history[-10:]):.4f}")
    print(f"checkpoints: {cm.steps()} (+cold {cm.steps(True)})")
    print(f"artifact catalog: {cm.store.usage()}")
    return {"state": final, "history": history, "restarts": restarts,
            "ckpt": cm, "model": model, "step_s": step_s}


def main(argv: Optional[List[str]] = None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
