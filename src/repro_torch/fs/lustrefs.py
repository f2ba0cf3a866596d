"""In-process Lustre model: namespace + OSTs + pools + DNE changelogs + HSM.

This is the "filesystem under management" for tests, benchmarks and examples.
It models exactly what the paper's engine consumes/controls:

* a namespace of entries with POSIX attributes;
* **OSTs** with capacities; files stripe over OSTs (``stripe_count``), data
  usage is accounted per OST so watermark-triggered purge (C7) is observable;
* **pools** — administratively-defined OST groups, usable in policies;
* **DNE**: directories are hash-distributed over ``n_mdts`` metadata shards,
  each emitting its own transactional changelog stream (C3);
* **HSM hooks**: archive copies file payload to an :class:`HsmBackend`,
  release punches OST data (keeping a stub), restore brings it back —
  emitting HSM changelog events throughout (C8).

Operations update atime/mtime/ctime like a real FS so age-based policies are
meaningful; a ``clock`` callable is injectable so tests can fake time.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.changelog import ChangelogHub
from ..core.types import ChangelogType, Entry, FsType, HsmState
from .hsm_backend import HsmBackend


class Ost:
    """One object storage target: capacity + used-bytes accounting."""

    def __init__(self, index: int, capacity: int) -> None:
        self.index = index
        self.capacity = capacity
        self.used = 0
        self._lock = threading.Lock()

    def alloc(self, nbytes: int) -> None:
        with self._lock:
            self.used += nbytes

    def free(self, nbytes: int) -> None:
        with self._lock:
            self.used = max(0, self.used - nbytes)

    @property
    def usage_pct(self) -> float:
        return 100.0 * self.used / self.capacity if self.capacity else 0.0


class _Node:
    __slots__ = ("entry", "children", "data_len", "archived_len")

    def __init__(self, entry: Entry) -> None:
        self.entry = entry
        self.children: Dict[str, int] = {}   # name -> fid (dirs only)
        self.data_len = 0                     # bytes resident on OSTs
        self.archived_len = 0                 # bytes archived in HSM


class LustreSim:
    """Simulated Lustre filesystem with changelog + OST + HSM semantics."""

    def __init__(self, n_osts: int = 4, ost_capacity: int = 1 << 30,
                 n_mdts: int = 1, stripe_count: int = 1,
                 changelog_dir: Optional[str] = None,
                 hsm: Optional[HsmBackend] = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.osts = [Ost(i, ost_capacity) for i in range(n_osts)]
        self.pools: Dict[str, Tuple[int, ...]] = {}
        self.stripe_count = stripe_count
        self.changelog = ChangelogHub(n_mdts=n_mdts, persist_dir=changelog_dir)
        self.n_mdts = n_mdts
        self.hsm = hsm
        self.clock = clock
        self._lock = threading.RLock()
        self._nodes: Dict[int, _Node] = {}
        self._next_fid = 2
        self._rr = 0   # round-robin stripe cursor
        now = self.clock()
        root = Entry(fid=1, parent_fid=0, name="/", path="/", type=FsType.DIR,
                     mode=0o755, atime=now, mtime=now, ctime=now)
        self._nodes[1] = _Node(root)

    # -- helpers -------------------------------------------------------------
    def define_pool(self, name: str, ost_indices: Sequence[int]) -> None:
        self.pools[name] = tuple(ost_indices)

    def _mdt_of(self, parent_fid: int) -> int:
        return parent_fid % self.n_mdts

    def _emit(self, parent_fid: int, type_: ChangelogType, fid: int, **kw) -> None:
        kw.setdefault("time", self.clock())
        self.changelog.stream(self._mdt_of(parent_fid)).emit(
            type_, fid, parent_fid=parent_fid, **kw)

    def _pick_osts(self, pool: str) -> Tuple[int, ...]:
        cands = self.pools.get(pool) or tuple(range(len(self.osts)))
        n = min(self.stripe_count, len(cands))
        out = tuple(cands[(self._rr + i) % len(cands)] for i in range(n))
        self._rr += 1
        return out

    def _node(self, fid: int) -> _Node:
        node = self._nodes.get(fid)
        if node is None:
            raise FileNotFoundError(fid)
        return node

    def _alloc_fid(self) -> int:
        fid = self._next_fid
        self._next_fid += 1
        return fid

    # -- namespace operations (each emits a changelog record) -------------------
    def mkdir(self, parent: int, name: str, owner: str = "root",
              group: str = "root", uid: str = "", jobid: str = "") -> int:
        with self._lock:
            pnode = self._node(parent)
            if name in pnode.children:
                raise FileExistsError(name)
            fid = self._alloc_fid()
            now = self.clock()
            path = (pnode.entry.path.rstrip("/") + "/" + name)
            e = Entry(fid=fid, parent_fid=parent, name=name, path=path,
                      type=FsType.DIR, mode=0o755, owner=owner, group=group,
                      atime=now, mtime=now, ctime=now)
            self._nodes[fid] = _Node(e)
            pnode.children[name] = fid
            pnode.entry.mtime = now
            self._emit(parent, ChangelogType.MKDIR, fid, name=name, uid=uid,
                       jobid=jobid)
            return fid

    def create(self, parent: int, name: str, owner: str = "root",
               group: str = "root", pool: str = "", uid: str = "",
               jobid: str = "") -> int:
        with self._lock:
            pnode = self._node(parent)
            if name in pnode.children:
                raise FileExistsError(name)
            fid = self._alloc_fid()
            now = self.clock()
            stripes = self._pick_osts(pool)
            path = (pnode.entry.path.rstrip("/") + "/" + name)
            e = Entry(fid=fid, parent_fid=parent, name=name, path=path,
                      type=FsType.FILE, owner=owner, group=group, pool=pool,
                      ost_idx=stripes[0] if stripes else -1,
                      stripe_osts=stripes, atime=now, mtime=now, ctime=now)
            self._nodes[fid] = _Node(e)
            pnode.children[name] = fid
            pnode.entry.mtime = now
            self._emit(parent, ChangelogType.CREAT, fid, name=name, uid=uid,
                       jobid=jobid)
            return fid

    def symlink(self, parent: int, name: str, target: str,
                owner: str = "root", uid: str = "") -> int:
        with self._lock:
            pnode = self._node(parent)
            fid = self._alloc_fid()
            now = self.clock()
            path = (pnode.entry.path.rstrip("/") + "/" + name)
            e = Entry(fid=fid, parent_fid=parent, name=name, path=path,
                      type=FsType.SYMLINK, owner=owner, size=len(target),
                      atime=now, mtime=now, ctime=now,
                      xattrs={"target": target})
            self._nodes[fid] = _Node(e)
            pnode.children[name] = fid
            self._emit(parent, ChangelogType.SLINK, fid, name=name, uid=uid)
            return fid

    def write(self, fid: int, nbytes: int, uid: str = "", jobid: str = "") -> None:
        """Append ``nbytes``; allocates across the file's stripe OSTs."""
        with self._lock:
            node = self._node(fid)
            e = node.entry
            if e.type != FsType.FILE:
                raise IsADirectoryError(fid)
            per = nbytes // max(1, len(e.stripe_osts)) if e.stripe_osts else 0
            for idx in e.stripe_osts:
                self.osts[idx].alloc(per)
            node.data_len += nbytes
            now = self.clock()
            e.size += nbytes
            e.blocks = node.data_len
            e.mtime = e.atime = now
            if e.hsm_state in (HsmState.ARCHIVED,):
                e.hsm_state = HsmState.DIRTY
                self._emit(e.parent_fid, ChangelogType.HSM, fid,
                           attrs={"hsm_state": int(HsmState.DIRTY)}, uid=uid)
            self._emit(e.parent_fid, ChangelogType.CLOSE, fid, name=e.name,
                       uid=uid, jobid=jobid,
                       attrs={"size": e.size, "blocks": e.blocks,
                              "mtime": e.mtime})

    def read(self, fid: int, uid: str = "") -> int:
        """Touch atime; transparently restores released files (Lustre does)."""
        with self._lock:
            node = self._node(fid)
            node.entry.atime = self.clock()
            if node.entry.hsm_state == HsmState.RELEASED:
                self.hsm_restore(fid, uid=uid)
            return node.entry.size

    def setattr(self, fid: int, uid: str = "", **attrs) -> None:
        with self._lock:
            node = self._node(fid)
            e = node.entry
            for k, v in attrs.items():
                setattr(e, k, v)
            e.ctime = self.clock()
            self._emit(e.parent_fid, ChangelogType.SATTR, fid, name=e.name,
                       uid=uid, attrs=dict(attrs))

    def rename(self, fid: int, new_parent: int, new_name: str,
               uid: str = "") -> None:
        with self._lock:
            node = self._node(fid)
            e = node.entry
            old_parent = self._node(e.parent_fid)
            old_parent.children.pop(e.name, None)
            npnode = self._node(new_parent)
            npnode.children[new_name] = fid
            e.parent_fid, e.name = new_parent, new_name
            e.path = npnode.entry.path.rstrip("/") + "/" + new_name
            e.ctime = self.clock()
            self._fix_paths(fid)
            self._emit(new_parent, ChangelogType.RENME, fid, name=new_name,
                       uid=uid, attrs={"path": e.path})

    def _fix_paths(self, fid: int) -> None:
        node = self._nodes[fid]
        for name, cfid in node.children.items():
            ce = self._nodes[cfid].entry
            ce.path = node.entry.path.rstrip("/") + "/" + name
            if ce.type == FsType.DIR:
                self._fix_paths(cfid)

    def unlink(self, fid: int, uid: str = "", jobid: str = "") -> None:
        with self._lock:
            node = self._node(fid)
            e = node.entry
            if e.type == FsType.DIR:
                if node.children:
                    raise OSError("directory not empty")
                type_ = ChangelogType.RMDIR
            else:
                type_ = ChangelogType.UNLNK
                per = node.data_len // max(1, len(e.stripe_osts)) if e.stripe_osts else 0
                for idx in e.stripe_osts:
                    self.osts[idx].free(per)
            parent = self._nodes.get(e.parent_fid)
            if parent:
                parent.children.pop(e.name, None)
            del self._nodes[fid]
            self._emit(e.parent_fid, type_, fid, name=e.name, uid=uid,
                       jobid=jobid)

    # -- HSM operations (C8) -----------------------------------------------------
    def hsm_archive(self, fid: int, archive_id: int = 1, uid: str = "") -> None:
        with self._lock:
            node = self._node(fid)
            e = node.entry
            if self.hsm is None:
                raise RuntimeError("no HSM backend attached")
            e.hsm_state = HsmState.ARCHIVING
            self.hsm.put(fid, e.size, archive_id)
            node.archived_len = e.size
            e.hsm_state = HsmState.ARCHIVED
            e.archive_id = archive_id
            self._emit(e.parent_fid, ChangelogType.HSM, fid, uid=uid,
                       attrs={"hsm_state": int(HsmState.ARCHIVED),
                              "archive_id": archive_id})

    def hsm_release(self, fid: int, uid: str = "") -> None:
        """Punch data from OSTs; entry stays visible (stub)."""
        with self._lock:
            node = self._node(fid)
            e = node.entry
            if e.hsm_state != HsmState.ARCHIVED:
                raise RuntimeError(f"cannot release fid {fid}: not archived")
            per = node.data_len // max(1, len(e.stripe_osts)) if e.stripe_osts else 0
            for idx in e.stripe_osts:
                self.osts[idx].free(per)
            node.data_len = 0
            e.blocks = 0
            e.hsm_state = HsmState.RELEASED
            self._emit(e.parent_fid, ChangelogType.HSM, fid, uid=uid,
                       attrs={"hsm_state": int(HsmState.RELEASED), "blocks": 0})

    def hsm_restore(self, fid: int, uid: str = "") -> None:
        with self._lock:
            node = self._node(fid)
            e = node.entry
            if self.hsm is None or not self.hsm.has(fid):
                e.hsm_state = HsmState.LOST
                raise RuntimeError(f"HSM copy of fid {fid} lost")
            e.hsm_state = HsmState.RESTORING
            size = self.hsm.get(fid)
            per = size // max(1, len(e.stripe_osts)) if e.stripe_osts else 0
            for idx in e.stripe_osts:
                self.osts[idx].alloc(per)
            node.data_len = size
            e.blocks = size
            e.hsm_state = HsmState.ARCHIVED
            self._emit(e.parent_fid, ChangelogType.HSM, fid, uid=uid,
                       attrs={"hsm_state": int(HsmState.ARCHIVED),
                              "blocks": size})

    # -- FsBackend interface (for the scanner) ------------------------------------
    def root_fid(self) -> int:
        return 1

    def readdir(self, fid: int) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._node(fid).children.items())

    def stat(self, fid: int) -> Optional[Entry]:
        with self._lock:
            node = self._nodes.get(fid)
            if node is None:
                return None
            e = node.entry
            # return a copy so catalog mutations never alias FS state
            import dataclasses
            return dataclasses.replace(e, xattrs=dict(e.xattrs),
                                       stripe_osts=tuple(e.stripe_osts))

    def stat_batch(self, fids) -> List[Optional[Entry]]:
        """Stat many fids under ONE namespace lock acquisition.

        The per-entry copy bypasses ``dataclasses.replace`` (which
        re-runs ``__init__`` field by field) with a ``__dict__`` copy —
        the same bulk-construction idiom as ``CatalogShard.get_batch`` —
        so the columnar pipeline's GET_INFO stage costs a dict copy per
        surviving fid, not a dataclass construction per record.
        """
        out: List[Optional[Entry]] = []
        new = Entry.__new__
        with self._lock:
            nodes = self._nodes
            for fid in fids:
                node = nodes.get(fid)
                if node is None:
                    out.append(None)
                    continue
                e = node.entry
                c = new(Entry)
                d = dict(e.__dict__)
                d["xattrs"] = dict(e.xattrs)
                d["stripe_osts"] = tuple(e.stripe_osts)
                c.__dict__ = d
                out.append(c)
        return out

    def count(self) -> int:
        with self._lock:
            return len(self._nodes)
