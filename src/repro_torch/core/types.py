"""Shared types for the Robinhood core: entries, changelog records, HSM states.

Terminology follows the paper: an *entry* is a filesystem object (file,
directory, symlink) identified by a stable ``fid`` (Lustre FID analogue).
The catalog mirrors entry metadata; the changelog carries metadata-change
events from an MDT (or any event source) to the catalog.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Optional


class FsType(enum.IntEnum):
    FILE = 0
    DIR = 1
    SYMLINK = 2
    OTHER = 3


class HsmState(enum.IntEnum):
    """Lustre-HSM entry states, as driven by the paper's policy engine."""

    NONE = 0        # never archived
    DIRTY = 1       # modified since last archive
    ARCHIVING = 2   # archive request in flight
    ARCHIVED = 3    # clean copy exists in the HSM backend
    RELEASED = 4    # data punched from Lustre, stub remains
    RESTORING = 5   # restore in flight
    LOST = 6        # backend copy lost / unrecoverable


class ChangelogType(enum.IntEnum):
    """Subset of Lustre MDT changelog record types used by Robinhood."""

    CREAT = 0
    MKDIR = 1
    UNLNK = 2
    RMDIR = 3
    RENME = 4
    SATTR = 5   # setattr: chmod/chown/utimes
    CLOSE = 6   # close after write: size/mtime may have changed
    TRUNC = 7
    HSM = 8     # HSM state change event
    SLINK = 9
    XATTR = 10
    MTIME = 11


@dataclasses.dataclass
class Entry:
    """A filesystem entry's metadata, as mirrored in the catalog."""

    fid: int
    parent_fid: int = -1
    name: str = ""
    path: str = ""
    type: FsType = FsType.FILE
    size: int = 0
    blocks: int = 0          # allocated bytes (spc_used)
    owner: str = "root"
    group: str = "root"
    mode: int = 0o644
    nlink: int = 1
    atime: float = 0.0
    mtime: float = 0.0
    ctime: float = 0.0
    ost_idx: int = -1        # first stripe OST (-1: no data / dir)
    stripe_osts: tuple = ()  # all OSTs holding stripes
    pool: str = ""
    hsm_state: HsmState = HsmState.NONE
    archive_id: int = 0
    status: str = ""         # generic-policy status tag (v3)
    xattrs: dict = dataclasses.field(default_factory=dict)
    dirty: bool = False      # async dirty-tag mode (paper SIII-A2 future work)

    def touch(self) -> None:
        now = time.time()
        self.atime = self.mtime = self.ctime = now


@dataclasses.dataclass
class ChangelogRecord:
    """One transactional changelog record.

    ``seq`` is assigned by the emitting MDT stream; records must be acked in
    order and survive until acked (paper SII-C2).
    """

    seq: int
    type: ChangelogType
    fid: int
    parent_fid: int = -1
    name: str = ""
    time: float = 0.0
    uid: str = ""            # user performing the operation
    jobid: str = ""          # Lustre >=2.7 jobid (paper SIII-C)
    mdt: int = 0             # emitting MDT index (DNE)
    attrs: Optional[dict] = None   # optional attribute payload

    def key(self) -> tuple:
        return (self.mdt, self.seq)


# Size-profile buckets, matching robinhood's file-size profile ranges.
SIZE_PROFILE_EDGES = (
    0, 1, 32, 1 << 10, 32 << 10, 1 << 20, 32 << 20, 1 << 30, 32 << 30, 1 << 40
)
SIZE_PROFILE_LABELS = (
    "0", "1~31", "32~1K", "1K~31K", "32K~1M", "1M~31M", "32M~1G", "1G~31G",
    "32G~1T", "+1T",
)

# Age-profile buckets (paper: "overall statistics about data ownership, age
# and size profiles"). Ages are ``now - atime`` seconds; an entry's bucket
# is the largest i with age >= AGE_PROFILE_EDGES[i] (clipped to bucket 0
# for future timestamps).
AGE_PROFILE_EDGES = (
    0.0, 3600.0, 86400.0, 7 * 86400.0, 30 * 86400.0, 90 * 86400.0,
    365 * 86400.0,
)
AGE_PROFILE_LABELS = (
    "<1h", "1h~1d", "1d~7d", "7d~30d", "30d~90d", "90d~1y", "+1y",
)


def age_profile_bucket(age: float) -> int:
    """Index of ``age`` (seconds) in the age-profile histogram.

    Shares the comparison-count formula with the ``profile_cube`` kernel:
    ``clip(sum(age >= edge) - 1, 0, A-1)`` — future timestamps (negative
    age) land in bucket 0.
    """
    b = -1
    for e in AGE_PROFILE_EDGES:
        if age >= e:
            b += 1
    return max(b, 0)


def size_profile_bucket(size: int) -> int:
    """Index of ``size`` in the robinhood size-profile histogram."""
    for i in range(len(SIZE_PROFILE_EDGES) - 1, -1, -1):
        if size >= SIZE_PROFILE_EDGES[i] and (size > 0 or i == 0):
            if size == 0:
                return 0
            return i
    return 0


def parse_size(text: str) -> int:
    """Parse a size literal with units: ``1GB``, ``512MB``, ``4k``..."""
    s = text.strip().upper().rstrip("B")
    units = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40,
             "P": 1 << 50}
    if s and s[-1] in units:
        return int(float(s[:-1]) * units[s[-1]])
    return int(float(s)) if s else 0


def parse_duration(text: str) -> float:
    """Parse a duration literal: ``15min``, ``2h``, ``30d``, ``45s``."""
    s = text.strip().lower()
    units = (("min", 60), ("sec", 1), ("s", 1), ("m", 60), ("h", 3600),
             ("d", 86400), ("w", 7 * 86400), ("y", 365 * 86400))
    for suffix, mult in units:
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    return float(s)


def format_size(n: float) -> str:
    for unit in ("", "KB", "MB", "GB", "TB", "PB"):
        if abs(n) < 1024 or unit == "PB":
            return f"{n:.2f} {unit}".strip() if unit else f"{int(n)}"
        n /= 1024.0
    return f"{n:.2f} PB"
