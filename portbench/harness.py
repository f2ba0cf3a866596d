"""One cell of the benchmark: set-up, the measured window, the check.

:class:`Session` holds the port's model for a cell (``BENCHMARK.json``'s
entry, its configuration and traffic files): it draws the weights from a
seed and binds them, captures the decode step, warms the cell's shapes,
runs the closed loop of :mod:`portbench.traffic` for a window, and judges
the served tokens by the family's float32 reference. ``run.py`` drives one
session a process; ``calibrate.py`` drives one over many seeds.

The served path is the port's: ``serve.serve_step.make_prefill`` and
``make_serve_step`` (on the card ``GraphedServeStep``, captured once) over
``repro_torch.models.Model``. The benchmark adds the client: the prompts,
the first token's argmax over the prefill's logits, and reading every
token back to the host as a streaming server delivers it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import traffic as traffic_mod
from . import weights
from .trace import Tracer, span

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str, smoke: bool = False) -> Dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    return {**cfg, **cfg["smoke"]} if smoke else cfg


def load_limits(cell: str) -> Dict[str, float]:
    with open(HERE / "workloads" / f"{cell}.json") as f:
        return json.load(f)["limits"]


@dataclasses.dataclass
class Batch:
    """A batch that finished in the window: its prompts (B, P) and the
    tokens served to each sequence (B, G)."""

    prompts: np.ndarray
    served: np.ndarray


@dataclasses.dataclass
class Window:
    """What the measured window recorded. Samples taken while a traced
    run's profiler was on are left out of the lists (their tokens count)."""

    seconds: float = 0.0
    attempted: int = 0                 # requests submitted
    prompt_tokens: int = 0             # prefilled
    gen_tokens: int = 0                # delivered
    prefill_s: List[float] = dataclasses.field(default_factory=list)
    prefill_batch: int = 0             # sequences a prefill
    prefill_len: int = 0               # prompt tokens a sequence
    step_s: List[float] = dataclasses.field(default_factory=list)
    step_pos: List[int] = dataclasses.field(default_factory=list)
    launch_s: List[float] = dataclasses.field(default_factory=list)
    #     (a step's host time from the last delivery to the step call's return)
    finished: List[Batch] = dataclasses.field(default_factory=list)
    trace: Optional[Dict] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    steps: int = 0                     # decode steps, traced ones too
    prefills: int = 0


def _launch_counters() -> Dict[str, int]:
    """Every launch counter of the port's kernel modules loaded so far
    (a kernel the cell never reaches is never imported)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch.kernels.") and \
                name.endswith(".kernel"):
            for k, v in vars(mod).items():
                if k.endswith("_launches") and isinstance(v, int):
                    out[k] = v
    return out


class Session:
    """The port's model for one cell on ``device``; ``smoke``: the
    configuration's and the traffic's small sizes (CPU tests)."""

    def __init__(self, cell: str, device: torch.device, smoke: bool = False,
                 bench: Optional[Dict] = None) -> None:
        bench = bench or load_benchmark()
        self.cell = next(c for c in bench["workloads"] if c["name"] == cell)
        self.config = load_config(self.cell["config"], smoke)
        self.traffic = traffic_mod.load(self.cell["traffic"], smoke)
        self.limits = load_limits(cell)
        family = self.config["family"]
        self.family = importlib.import_module(f"portbench.models.{family}")
        self.reference = importlib.import_module(
            f"portbench.reference.{family}")
        self.count = importlib.import_module(f"portbench.count.{family}")
        self.device = device
        self.groups = self.family.layout(self.config)

        from repro_torch.models import Model
        from repro_torch.serve import serve_step
        t = self.traffic
        self.B, self.P, self.G = t["batch"], t["prompt"], t["generate"]
        self.cache_len = self.P + self.G
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        self.model = Model(self.family.port_config(self.config)).init(
            gen, device)
        self.prefill = serve_step.make_prefill(self.model, self.cache_len)
        self.step = serve_step.make_serve_step(self.model)

    # -- set-up ---------------------------------------------------------------
    def load_weights(self, seed: int) -> None:
        weights.bind(self.model, self.groups, seed)

    def warm(self, seed: int, trace: bool = False) -> None:
        """Captures the step and runs the cell's shapes once: a prefill of
        a batch and a step from its cache."""
        if hasattr(self.step, "capture"):
            self.step.capture(self.B, self.cache_len)
        prompts = traffic_mod.prompts(self.traffic, self.config["vocab"],
                                      seed, -1)
        tok = torch.from_numpy(prompts).to(self.device)
        logits, cache = self.prefill(tok)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        nxt, cache = self.step(cache, nxt, self.P)
        nxt.cpu()
        if trace:
            Tracer.warm(self.device)
        del logits, cache, nxt

    # -- the window -----------------------------------------------------------
    @torch.no_grad()
    def window(self, seed: int, seconds: float, trace: bool = False,
               batches: Optional[int] = None) -> Window:
        """The closed loop for ``seconds`` (the window closes at the first
        delivery at or past it, or with the traffic's ``close: batch`` at
        the end of the batch then in flight) or, with ``batches``, for that
        many whole batches."""
        B, P, G = self.B, self.P, self.G
        spec = self.traffic["trace"]
        tracer = Tracer() if trace else None
        w = Window(prefill_batch=B, prefill_len=P)
        counters = _launch_counters()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        whole = batches is not None or self.traffic.get("close") == "batch"
        n, done, tracing, t = 0, False, False, t0
        while not done:
            prompts = traffic_mod.prompts(self.traffic, self.config["vocab"],
                                          seed, n)
            if tracer and n == 0 and spec["phase"] == "batch":
                tracer.start()
                tracing = True
            t_sub = time.perf_counter()
            with span("prefill"):
                tok = torch.from_numpy(prompts).to(self.device)
                logits, cache = self.prefill(tok)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                del logits
            with span("deliver"):
                host = nxt.cpu().numpy()
            t = time.perf_counter()
            w.attempted += B
            w.prefills += 1
            w.prompt_tokens += B * P
            w.gen_tokens += B
            if not tracing:
                w.prefill_s.append(t - t_sub)
            served = np.empty((B, G), dtype=np.int64)
            served[:, 0] = host[:, 0]
            last, i = t, 1
            while i < G and not (t >= deadline and not whole):
                if tracer and n == 0 and spec["phase"] == "decode" and \
                        i == spec["from_step"]:
                    tracer.start()
                    tracing = True
                with span("step"):
                    nxt, cache = self.step(cache, nxt, P + i - 1)
                t_launched = time.perf_counter()
                with span("deliver"):
                    host = nxt.cpu().numpy()
                t = time.perf_counter()
                w.steps += 1
                w.gen_tokens += B
                if not tracing:
                    w.step_s.append(t - last)
                    w.step_pos.append(P + i - 1)
                    w.launch_s.append(t_launched - last)
                served[:, i] = host[:, 0]
                last = t
                i += 1
                if tracing and spec["phase"] == "decode" and \
                        i == spec["from_step"] + spec["steps"]:
                    tracer.stop()
                    tracing = False
                    last = time.perf_counter()  # no step waited on it
            if tracing:
                tracer.stop()
                tracing = False
            del cache
            if i == G:
                w.finished.append(Batch(prompts, served))
            n += 1
            done = (n >= batches) if batches is not None else t >= deadline
        w.seconds = t - t0
        after = _launch_counters()
        w.launches = {k: v - counters.get(k, 0) for k, v in after.items()}
        if tracer and tracer.prof is not None:
            w.trace = tracer.summary()
        return w

    def free(self) -> None:
        """Drops the program's state (model, captured step, prefill)."""
        del self.model, self.step, self.prefill
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    @property
    def check_batches(self) -> int:
        """Whole batches that hold as many requests as a run judges."""
        return -(-self.traffic["check"]["sequences"] // self.B)

    def picks(self, seed: int, w: Window) -> List[Tuple[int, int]]:
        """(finished batch, row) of the requests the reference judges, no
        two alike, drawn from the seed: ``check.sequences`` of them (at most
        every finished request), the j-th from the (j mod k)-th of k equal
        slices of a batch's rows, k the lesser of that number and B (so
        every part of a batch is judged), each from a finished batch drawn
        at random."""
        if not w.finished:
            return []
        B, F = self.B, len(w.finished)
        n = min(self.traffic["check"]["sequences"], F * B)
        rng = np.random.Generator(np.random.Philox(
            weights.subseed(seed, "check")))
        k = min(n, B)
        edges = np.linspace(0, B, k + 1).astype(np.int64)
        out: List[Tuple[int, int]] = []
        for j in range(n):
            lo, hi = edges[j % k], edges[j % k + 1]
            while True:
                pick = (int(rng.integers(F)),
                        int(rng.integers(lo, max(hi, lo + 1))))
                if pick not in out:
                    break
            out.append(pick)
        return out

    @torch.no_grad()
    def judge(self, seed: int, w: Window, controls: Sequence[str] = (),
              diagnose: bool = False) -> Dict[str, float]:
        """The float32 reference over each judged request's prompt and
        served tokens: ``token_gap``, the widest gap by which a served
        token's logit lies below the reference's best at its position
        (0 where the reference agrees); ``mean_gap`` and ``mismatch``
        (share of served tokens not the reference's best) beside it. For
        each precision in ``controls`` the reference in that precision is
        put in the program's place: ``token_gap.<precision>`` reads the
        same gap for the token it puts first. ``diagnose`` (a family whose
        reference records router margins): where the large gaps fall
        against each token's least router margin."""
        picks = self.picks(seed, w)
        if not picks:
            return {}
        P, G = self.P, self.G
        toks = np.stack([np.concatenate([w.finished[b].prompts[r],
                                         w.finished[b].served[r, :G - 1]])
                         for b, r in picks])
        served = torch.from_numpy(np.stack(
            [w.finished[b].served[r] for b, r in picks])).to(self.device)
        tokens = torch.from_numpy(toks).to(self.device)
        get = weights.reference_weights(self.groups, seed, self.device)
        record: Dict = {}
        extra = {"record": record} if diagnose else {}
        ref = self.reference.logits(self.config, get, tokens, P - 1, **extra)
        best = ref.max(dim=-1).values
        gap = best - ref.gather(-1, served[..., None])[..., 0]
        out = {"token_gap": float(gap.max()),
               "sequence_gaps": gap.max(dim=1).values.tolist(),
               "mean_gap": float(gap.mean()),
               "mismatch": float((gap > 0).float().mean()),
               "judged_tokens": int(gap.numel())}
        if "router_margin" in record:
            near = record["router_margin"][:, P - 1:] < 0.05
            big = gap > 0.5
            out["share_near_tie"] = float(near.float().mean())
            out["big_gaps"] = int(big.sum())
            out["big_gaps_near_tie"] = int((big & near).sum())
            out["widest_at_near_tie"] = bool(near.reshape(-1)[
                gap.reshape(-1).argmax()])
        for precision in controls:
            low = self.reference.logits(self.config, get, tokens, P - 1,
                                        precision)
            first = low.argmax(dim=-1, keepdim=True)
            del low
            cgap = best - ref.gather(-1, first)[..., 0]
            out[f"token_gap.{precision}"] = float(cgap.max())
            out[f"mean_gap.{precision}"] = float(cgap.mean())
        return out
