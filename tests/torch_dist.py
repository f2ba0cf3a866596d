"""Several CPU processes as the ranks of one ``torch.distributed`` gloo
group, for the port's distribution tests (the reference's tests fake XLA
devices in one subprocess, ``conftest.run_subprocess``).

``run_ranks(code, world)`` starts ``world`` Python processes with the
``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on localhost), each running ``code`` after a prelude that
joins the gloo group; ``code`` prints what the test reads. Returns each
rank's stdout, in rank order; a rank that fails or outlives ``timeout``
fails the test with its stderr.

``PARTITION_LOSS`` and :func:`within_adam_reach` are the bounds a bf16
partitioned step is held to against an unsharded one, ``F32_ACCUM`` and
:func:`accum_close` those of an f32 step's gradient accumulators
(``tests/test_torch_partition.py`` gives their reasons);
:func:`accumulators` captures the accumulators of the steps it wraps.
"""
import contextlib
import importlib
import os
import socket
import subprocess
import sys

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

PRELUDE = """
import os
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
RANK, WORLD = dist.get_rank(), dist.get_world_size()
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return env


def run_ranks(code: str, world: int, timeout: int = 120, argv=None,
              prelude: bool = True) -> list:
    """``code`` on ``world`` ranks (or ``argv``, a command, on each rank
    with the same environment). Returns the ranks' stdouts."""
    port = free_port()
    cmd = argv or [sys.executable, "-c",
                   (PRELUDE if prelude else "") + code
                   + (EPILOGUE if prelude else "")]
    procs = [subprocess.Popen(cmd, env=rank_env(r, world, port),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


# a bf16 partitioned step's losses against an unsharded step's, relative
PARTITION_LOSS = 5e-4


def within_adam_reach(got: dict, want: dict, lr, steps: int,
                      what: str = "") -> float:
    """bf16 parameters ``steps`` AdamW steps apart by at most the flips of
    a gradient near 0 (``2 * lr`` a step, plus 1% for ``m / sqrt(v)``
    past 1) and one bf16 step of their value; ``lr`` the schedule
    (count -> rate). Returns the share of elements that differ."""
    import torch
    reach = 2 * 1.01 * sum(float(lr(torch.tensor(c, dtype=torch.int32)))
                           for c in range(1, steps + 1))
    total = diff = 0
    for k, w in want.items():
        g = got[k].detach()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        step = torch.finfo(torch.bfloat16).eps * torch.maximum(
            g.float().abs(), w.float().abs())
        d = (g.float() - w.float()).abs()
        assert bool((d <= reach + step).all()), (what, k, float(d.max()))
        total += w.numel()
        diff += int((g != w).sum())
    return diff / total


# an f32 partitioned step's gradient accumulators against the shards of
# the unsharded step's: relative L2 a tensor, plus a floor relative to the
# largest accumulator's norm for a gradient that is rounding noise
F32_ACCUM, F32_ACCUM_FLOOR = 2.0 ** -12, 2.0 ** -20


def accum_close(got, want, floor: float, what="") -> None:
    """Each tensor of ``got`` within ``F32_ACCUM`` relative (L2) of
    ``want``'s, plus ``floor`` (absolute)."""
    assert set(got) == set(want), what
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        err = float((g - w).norm())
        assert err <= F32_ACCUM * float(w.norm()) + floor, (
            what, k, err, float(w.norm()))


@contextlib.contextmanager
def accumulators():
    """Within: a copy of every train step's f32 gradient accumulators
    (``train_step._microbatches``' sums: this rank's shards) appended to
    the list yielded."""
    ts = importlib.import_module("repro_torch.train.train_step")
    accs, inner = [], ts._microbatches

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        accs.append({k: v.clone() for k, v in out[0].items()})
        return out
    ts._microbatches = wrapped
    try:
        yield accs
    finally:
        ts._microbatches = inner
