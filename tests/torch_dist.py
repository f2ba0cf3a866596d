"""Several CPU processes as the ranks of one ``torch.distributed`` gloo
group, for the port's distribution tests (the reference's tests fake XLA
devices in one subprocess, ``conftest.run_subprocess``).

``run_ranks(code, world)`` starts ``world`` Python processes with the
``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on localhost), each running ``code`` after a prelude that
joins the gloo group; ``code`` prints what the test reads. Returns each
rank's stdout, in rank order; a rank that fails or outlives ``timeout``
fails the test with its stderr.
"""
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
