"""Fault tolerance: failure detection, checkpoint/restart, stragglers.

On a 1000+-node cluster the runtime must assume hosts fail mid-step. The
JAX SPMD model restarts the whole job from the last checkpoint when a host
is lost; what the framework owns is (a) detecting the loss fast
(heartbeats), (b) making restarts cheap (frequent, atomic checkpoints,
restored elastically onto the surviving mesh — runtime/elastic.py), and
(c) not letting one slow host starve the input pipeline (redundant data
shards).

Hosts are simulated in-process (threads + injected failures) so the full
detect -> restore -> replay path is exercised by tests on CPU.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional

from .checkpoint import CheckpointManager


class SimulatedFailure(RuntimeError):
    """Raised inside the train loop when a 'host' dies."""

    def __init__(self, host: int, step: int) -> None:
        super().__init__(f"host {host} failed at step {step}")
        self.host = host
        self.step = step


class HeartbeatMonitor:
    """Tracks per-host heartbeats; declares hosts dead after a timeout."""

    def __init__(self, n_hosts: int, timeout: float = 1.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.n_hosts = n_hosts
        self.timeout = timeout
        self.clock = clock
        self._lock = threading.Lock()
        now = clock()
        self._last: Dict[int, float] = {h: now for h in range(n_hosts)}
        self._dead: set = set()

    def beat(self, host: int) -> None:
        with self._lock:
            if host not in self._dead:
                self._last[host] = self.clock()

    def mark_dead(self, host: int) -> None:
        with self._lock:
            self._dead.add(host)

    def revive(self, host: int) -> None:
        with self._lock:
            self._dead.discard(host)
            self._last[host] = self.clock()

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        with self._lock:
            return sorted(self._dead | {
                h for h, t in self._last.items() if now - t > self.timeout})

    def healthy(self) -> bool:
        return not self.dead_hosts()


def run_with_restarts(train_steps: int,
                      step_fn: Callable[[object, int], object],
                      init_state: Callable[[], object],
                      ckpt: CheckpointManager,
                      ckpt_interval: int = 10,
                      max_restarts: int = 5,
                      on_restart: Optional[Callable[[int, int], None]] = None
                      ) -> tuple:
    """Drive a train loop to completion across simulated failures.

    ``step_fn(state, step)`` may raise :class:`SimulatedFailure`; the driver
    restores the last checkpoint and replays from there. Returns
    (final_state, restarts, steps_replayed).
    """
    state = init_state()
    step = 0
    restarts = 0
    replayed = 0
    while step < train_steps:
        try:
            state = step_fn(state, step)
            step += 1
            if step % ckpt_interval == 0:
                ckpt.save(state, step)
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError("restart budget exhausted") from e
            try:
                state, restored_step = ckpt.restore(like=state)
            except FileNotFoundError:
                state, restored_step = init_state(), 0
            replayed += step - restored_step
            if on_restart is not None:
                on_restart(step, restored_step)
            step = restored_step
    return state, restarts, replayed


class RedundantShardRouter:
    """Straggler mitigation for the input pipeline.

    Every data shard is assigned to ``replication`` hosts; a global step
    consumes each shard from whichever replica responds first, so one slow
    host delays nothing as long as a replica is healthy. (This is the
    standard backup-request trick applied to data loading; compute-side
    stragglers are lockstep in SPMD and are handled by restart instead.)
    """

    def __init__(self, n_shards: int, n_hosts: int,
                 replication: int = 2) -> None:
        self.n_shards = n_shards
        self.n_hosts = n_hosts
        self.replication = min(replication, n_hosts)
        self.assignment: Dict[int, List[int]] = {
            s: [(s + r) % n_hosts for r in range(self.replication)]
            for s in range(n_shards)}

    def hosts_for(self, shard: int) -> List[int]:
        return self.assignment[shard]

    def pick(self, shard: int, latency: Callable[[int], float]) -> int:
        """The replica that answers first under the given latency model."""
        return min(self.hosts_for(shard), key=latency)

    def coverage_without(self, dead: List[int]) -> float:
        """Fraction of shards still readable if ``dead`` hosts are lost."""
        alive = 0
        for s in range(self.n_shards):
            if any(h not in dead for h in self.hosts_for(s)):
                alive += 1
        return alive / max(1, self.n_shards)
