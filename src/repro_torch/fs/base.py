"""Minimal backend interface the scanner and pipeline consume."""
from __future__ import annotations

from typing import Iterable, List, Optional, Protocol, Tuple

from ..core.types import Entry


class FsBackend(Protocol):
    """What Robinhood needs from a filesystem: readdir + stat, by fid."""

    def root_fid(self) -> int: ...

    def readdir(self, fid: int) -> List[Tuple[str, int]]:
        """(name, child_fid) pairs of a directory."""
        ...

    def stat(self, fid: int) -> Optional[Entry]: ...


def stat_batch(fs, fids: Iterable[int]) -> List[Optional[Entry]]:
    """Batched stat with a scalar fallback.

    The columnar ingest plane resolves every surviving fid of a folded
    batch in one call; backends that can serve it under a single lock
    (``LustreSim.stat_batch``) export their own, everything else gets the
    per-fid loop here.
    """
    batched = getattr(fs, "stat_batch", None)
    if batched is not None:
        return batched(fids)
    return [fs.stat(f) for f in fids]
