"""Parallel namespace scanner (C2) — multi-threaded depth-first traversal.

Reproduces the paper's Fig. 3 design: the traversal is decomposed into
per-directory *tasks*; a pool of worker threads services them from a shared
LIFO stack, which yields the depth-first priority the paper illustrates
(deep directories are drained before siblings, bounding the frontier —
a FIFO would grow the frontier to the namespace's width).

Also implements the paper's **multi-client** mode: the namespace is split
at a chosen depth into disjoint subtrees, each assigned to a *client* (its
own scanner instance with its own thread pool, simulating one Lustre client
node's RPC stream), all feeding the same catalog.

The scan is the *initial population* path; steady-state freshness comes from
the changelog (C3). A completed scan also reconciles: entries present in the
catalog but absent from the FS are dropped (``prune_missing``) — this is what
makes the scan usable for disaster recovery of the catalog.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from .catalog import Catalog
from .types import Entry, FsType


class _TaskStack:
    """LIFO work stack with completion tracking (depth-first priority)."""

    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._stack: List[int] = []
        self._outstanding = 0

    def push(self, fid: int) -> None:
        with self._lock:
            self._stack.append(fid)
            self._outstanding += 1
            self._lock.notify()

    def pop(self) -> Optional[int]:
        """Next task, or None when the whole traversal is complete."""
        with self._lock:
            while not self._stack:
                if self._outstanding == 0:
                    return None
                self._lock.wait(timeout=0.1)
            return self._stack.pop()

    def done(self) -> None:
        with self._lock:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._lock.notify_all()


class ScanStats:
    def __init__(self) -> None:
        self.entries = 0
        self.dirs = 0
        self.errors = 0
        self.elapsed = 0.0
        self._lock = threading.Lock()

    def bump(self, entries: int = 0, dirs: int = 0, errors: int = 0) -> None:
        with self._lock:
            self.entries += entries
            self.dirs += dirs
            self.errors += errors


class Scanner:
    """Multi-threaded depth-first scanner feeding a catalog (or a sink)."""

    def __init__(self, fs, catalog: Optional[Catalog] = None,
                 n_threads: int = 4,
                 sink: Optional[Callable[[Entry], None]] = None,
                 readdir_latency: float = 0.0) -> None:
        self.fs = fs
        self.catalog = catalog
        self.n_threads = max(1, n_threads)
        self.sink = sink
        self.readdir_latency = readdir_latency  # simulated per-RPC latency
        self.stats = ScanStats()

    def _emit(self, e: Entry) -> None:
        if self.sink is not None:
            self.sink(e)
        elif self.catalog is not None:
            self.catalog.upsert(e)
        self.stats.bump(entries=1)

    def _worker(self, stack: _TaskStack) -> None:
        while True:
            fid = stack.pop()
            if fid is None:
                return
            try:
                if self.readdir_latency:
                    time.sleep(self.readdir_latency)
                children = self.fs.readdir(fid)
                self.stats.bump(dirs=1)
                for _name, cfid in children:
                    e = self.fs.stat(cfid)
                    if e is None:
                        self.stats.bump(errors=1)
                        continue
                    self._emit(e)
                    if e.type == FsType.DIR:
                        stack.push(cfid)
            except Exception:
                self.stats.bump(errors=1)
            finally:
                stack.done()

    def scan(self, root_fid: Optional[int] = None) -> ScanStats:
        """Full traversal from ``root_fid`` (default: FS root)."""
        t0 = time.perf_counter()
        stack = _TaskStack()
        root = self.fs.root_fid() if root_fid is None else root_fid
        root_entry = self.fs.stat(root)
        if root_entry is not None:
            self._emit(root_entry)
        stack.push(root)
        threads = [threading.Thread(target=self._worker, args=(stack,),
                                    daemon=True)
                   for _ in range(self.n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.stats.elapsed = time.perf_counter() - t0
        return self.stats


def multi_client_scan(fs, catalog: Catalog, n_clients: int = 2,
                      threads_per_client: int = 4,
                      readdir_latency: float = 0.0) -> List[ScanStats]:
    """Paper SIII-A1: split the namespace across clients, one DB.

    Top-level subtrees are round-robined over ``n_clients`` scanner
    instances running concurrently; their cumulated RPC throughput is what
    beats the single-client limit.
    """
    root = fs.root_fid()
    top = fs.readdir(root)
    root_entry = fs.stat(root)
    if root_entry is not None:
        catalog.upsert(root_entry)
    # assign top-level children round-robin to clients
    assignments: List[List[int]] = [[] for _ in range(n_clients)]
    for i, (_name, fid) in enumerate(top):
        e = fs.stat(fid)
        if e is None:
            continue
        catalog.upsert(e)
        if e.type == FsType.DIR:
            assignments[i % n_clients].append(fid)

    scanners = [Scanner(fs, catalog, n_threads=threads_per_client,
                        readdir_latency=readdir_latency)
                for _ in range(n_clients)]

    def run(client: int) -> None:
        for fid in assignments[client]:
            # each subtree scan reuses the client's thread pool
            s = scanners[client]
            stack = _TaskStack()
            stack.push(fid)
            threads = [threading.Thread(target=s._worker, args=(stack,),
                                        daemon=True)
                       for _ in range(s.n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

    drivers = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for d in drivers:
        d.start()
    for d in drivers:
        d.join()
    elapsed = time.perf_counter() - t0
    for s in scanners:
        s.stats.elapsed = elapsed
    return [s.stats for s in scanners]


def prune_missing(fs, catalog: Catalog) -> int:
    """Drop catalog entries that no longer exist in the FS (post-scan GC)."""
    removed = 0
    for shard in catalog.shards:
        for fid in shard.fids():
            if fs.stat(fid) is None:
                if catalog.remove(fid):
                    removed += 1
    return removed
