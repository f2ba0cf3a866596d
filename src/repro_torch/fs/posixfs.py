"""POSIX backend: scan real directories (used by benchmarks vs. `find`/`du`)."""
from __future__ import annotations

import os
import stat as stat_mod
import threading
from typing import Dict, List, Optional, Tuple

from ..core.types import Entry, FsType


class PosixFs:
    """Adapter exposing a real directory tree through the FsBackend interface.

    fids are dense ids assigned per (st_dev, st_ino) as discovered.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self._lock = threading.Lock()
        self._fid_of: Dict[Tuple[int, int], int] = {}
        self._path_of: Dict[int, str] = {}
        self._next = 1
        self._fid_for(self.root)

    def _fid_for(self, path: str) -> int:
        st = os.lstat(path)
        key = (st.st_dev, st.st_ino)
        with self._lock:
            fid = self._fid_of.get(key)
            if fid is None:
                fid = self._next
                self._next += 1
                self._fid_of[key] = fid
            self._path_of[fid] = path
            return fid

    def root_fid(self) -> int:
        return 1

    def readdir(self, fid: int) -> List[Tuple[str, int]]:
        path = self._path_of[fid]
        out = []
        try:
            with os.scandir(path) as it:
                for de in it:
                    out.append((de.name, self._fid_for(de.path)))
        except (PermissionError, FileNotFoundError):
            pass
        return out

    def stat(self, fid: int) -> Optional[Entry]:
        path = self._path_of.get(fid)
        if path is None:
            return None
        try:
            st = os.lstat(path)
        except FileNotFoundError:
            return None
        if stat_mod.S_ISDIR(st.st_mode):
            t = FsType.DIR
        elif stat_mod.S_ISLNK(st.st_mode):
            t = FsType.SYMLINK
        elif stat_mod.S_ISREG(st.st_mode):
            t = FsType.FILE
        else:
            t = FsType.OTHER
        return Entry(
            fid=fid, parent_fid=self._fid_for(os.path.dirname(path))
            if path != self.root else 0,
            name=os.path.basename(path) or "/", path=path, type=t,
            size=st.st_size, blocks=st.st_blocks * 512,
            owner=str(st.st_uid), group=str(st.st_gid),
            mode=stat_mod.S_IMODE(st.st_mode), nlink=st.st_nlink,
            atime=st.st_atime, mtime=st.st_mtime, ctime=st.st_ctime)

    def stat_batch(self, fids) -> List[Optional[Entry]]:
        """No batched lstat on POSIX — the loop just pins the interface."""
        return [self.stat(f) for f in fids]
