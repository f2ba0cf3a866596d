"""HSM backend (copytool target) — the 'large, cheap' tier behind Lustre."""
from __future__ import annotations

import threading
from typing import Dict, Optional


class HsmBackend:
    """Stores archived copies keyed by fid (sizes; payload is simulated)."""

    def __init__(self, capacity: int = 1 << 50,
                 archive_latency: float = 0.0) -> None:
        self.capacity = capacity
        self.archive_latency = archive_latency   # per-op simulated latency
        self.used = 0
        self._lock = threading.Lock()
        self._objects: Dict[int, Dict] = {}
        self.puts = 0
        self.gets = 0

    def put(self, fid: int, size: int, archive_id: int = 1) -> None:
        if self.archive_latency:
            import time
            time.sleep(self.archive_latency)
        with self._lock:
            prev = self._objects.get(fid)
            if prev is not None:
                self.used -= prev["size"]
            if self.used + size > self.capacity:
                raise OSError("HSM backend full")
            self._objects[fid] = {"size": size, "archive_id": archive_id}
            self.used += size
            self.puts += 1

    def has(self, fid: int) -> bool:
        with self._lock:
            return fid in self._objects

    def get(self, fid: int) -> int:
        if self.archive_latency:
            import time
            time.sleep(self.archive_latency)
        with self._lock:
            obj = self._objects[fid]
            self.gets += 1
            return obj["size"]

    def remove(self, fid: int) -> None:
        with self._lock:
            obj = self._objects.pop(fid, None)
            if obj is not None:
                self.used -= obj["size"]

    def count(self) -> int:
        with self._lock:
            return len(self._objects)
