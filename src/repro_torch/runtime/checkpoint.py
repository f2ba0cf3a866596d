"""Checkpointing with a Robinhood-managed artifact lifecycle.

This is the paper's engine applied to the framework's own storage problem:
a long training run writes thousands of checkpoint shard files; nobody
scans the checkpoint directory to manage them. Instead:

* every shard write/delete emits a **changelog** record consumed into an
  **artifact catalog** (core.Catalog) — the mirror stays fresh without
  directory walks (C1+C3);
* **retention** is a policy run: "purge checkpoints beyond the last k,
  except every nth which is archived to cold storage" (C5/C8 analogue);
* **undelete**: purged checkpoints move to a trash tier first, and can be
  restored from it (paper SII-C3);
* **disaster recovery**: the catalog can be rebuilt by a parallel scan of
  the checkpoint root (C2).

Writes are crash-safe: a checkpoint directory is staged under a temp name
and atomically renamed; a checkpoint is visible iff its manifest exists.

The port writes the reference's on-disk format unchanged (one
``shard_NNNNN.npy`` a leaf in ``jax.tree`` order, bf16 stored as uint16,
``manifest.json`` with the treedef string ``jax`` prints), so either
package restores the other's checkpoints. A state is a tree of dicts
(sorted keys), lists and tuples whose leaves are tensors, numpy arrays or
numbers (:func:`tree_flatten`); ``restore`` puts each leaf on ``like``'s
device and dtype and reads bf16 through an int16 view.

A state laid out over a mesh (``DTensor`` leaves, ``runtime/elastic.py``)
is saved as its logical tensors: every rank gathers each leaf whole (a
collective, so every rank calls ``save``), rank 0 writes, and the ranks
meet at a barrier before ``save`` returns. ``restore(shardings=)`` lays
the logical tensors out on another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.catalog import Catalog
from ..core.changelog import ChangelogStream
from ..core.stats import StatsAggregator
from ..core.types import ChangelogType, Entry, FsType
from .elastic import reshard_state
from .sharding import lay_out

PyTree = Any


def tree_flatten(tree: PyTree) -> Tuple[List[Any], str]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order (dict keys
    sorted, lists and tuples in order, None a node without leaves) and the
    treedef string ``jax`` prints for it."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if node is None:
            return "None"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(like: PyTree, leaves: List[Any]) -> PyTree:
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    return build(like)


def _numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 tensors as their uint16 bits; a
    ``DTensor`` as its whole tensor (a collective over its mesh)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _writes() -> bool:
    """Rank 0 of the default group (or a lone process) writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


class ArtifactStore:
    """Catalog-mirrored view of a real directory of training artifacts."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.catalog = Catalog(n_shards=2)
        self.stats = StatsAggregator(self.catalog.strings)
        self.catalog.add_delta_hook(self.stats.on_delta)
        self.changelog = ChangelogStream(mdt=0)
        self._next_fid = 1
        self._fid_by_path: Dict[str, int] = {}

    # -- event emission (the "MDT" side) ------------------------------------
    def _fid(self, path: str) -> int:
        if path not in self._fid_by_path:
            self._fid_by_path[path] = self._next_fid
            self._next_fid += 1
        return self._fid_by_path[path]

    def record_write(self, path: str, kind: str = "shard",
                     owner: str = "trainer") -> None:
        fid = self._fid(path)
        st = os.stat(path)
        self.changelog.emit(ChangelogType.CLOSE, fid, name=path,
                            uid=owner, attrs={"size": st.st_size})
        rel = os.path.relpath(path, self.root)
        self.catalog.upsert(Entry(
            fid=fid, name=os.path.basename(path), path=rel,
            type=FsType.FILE, size=st.st_size, blocks=st.st_size,
            owner=owner, status=kind, atime=st.st_atime, mtime=st.st_mtime,
            ctime=st.st_ctime))

    def record_delete(self, path: str) -> None:
        fid = self._fid_by_path.get(path)
        if fid is None:
            return
        self.changelog.emit(ChangelogType.UNLNK, fid, name=path)
        self.catalog.remove(fid)

    def rescan(self) -> int:
        """Disaster recovery: rebuild the catalog by walking the root."""
        n = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for f in files:
                p = os.path.join(dirpath, f)
                self.record_write(p, kind="recovered")
                n += 1
        return n

    def usage(self) -> dict:
        return self.stats.report_types().get("file",
                                             {"count": 0, "volume": 0})


class CheckpointManager:
    """Sharded, atomic, policy-retained checkpoints of a train state."""

    def __init__(self, directory: str, keep_last: int = 3,
                 archive_every: int = 0, trash_capacity: int = 2) -> None:
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.trash_dir = os.path.join(self.dir, ".trash")
        self.cold_dir = os.path.join(self.dir, "cold")   # the "HSM" tier
        os.makedirs(self.trash_dir, exist_ok=True)
        os.makedirs(self.cold_dir, exist_ok=True)
        self.keep_last = keep_last
        self.archive_every = archive_every
        self.trash_capacity = trash_capacity
        self.store = ArtifactStore(self.dir)

    # -- save ----------------------------------------------------------------
    def _ckpt_name(self, step: int) -> str:
        return f"ckpt_{step:08d}"

    def save(self, state: PyTree, step: int) -> str:
        """Atomically write a checkpoint; returns its directory."""
        name = self._ckpt_name(step)
        final = os.path.join(self.dir, name)
        leaves, treedef = tree_flatten(state)
        # every rank gathers (the DTensor leaves' collectives), rank 0 writes
        arrays = [(_dtype_name(leaf), _numpy(leaf)) for leaf in leaves]
        if not _writes():
            dist.barrier()
            return final
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(),
                    "treedef": treedef, "leaves": []}
        for i, (logical_dtype, arr) in enumerate(arrays):
            path = os.path.join(tmp, f"shard_{i:05d}.npy")
            np.save(path, arr)
            manifest["leaves"].append({
                "index": i, "shape": list(arr.shape),
                "dtype": logical_dtype, "file": os.path.basename(path)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)                     # atomic commit
        for leaf_info in manifest["leaves"]:
            self.store.record_write(os.path.join(final, leaf_info["file"]))
        self.store.record_write(os.path.join(final, "manifest.json"),
                                kind="manifest")
        self.apply_retention()
        if _ranks() > 1:
            dist.barrier()
        return final

    # -- enumerate -----------------------------------------------------------
    def steps(self, include_cold: bool = False) -> List[int]:
        out = []
        dirs = [self.dir] + ([self.cold_dir] if include_cold else [])
        for d in dirs:
            for name in os.listdir(d):
                if name.startswith("ckpt_") and not name.endswith(".tmp") \
                        and os.path.exists(os.path.join(d, name,
                                                        "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(set(out))

    def _path_for(self, step: int) -> Optional[str]:
        name = self._ckpt_name(step)
        for d in (self.dir, self.cold_dir, self.trash_dir):
            p = os.path.join(d, name)
            if os.path.exists(os.path.join(p, "manifest.json")):
                return p
        return None

    # -- restore ---------------------------------------------------------------
    def restore(self, like: PyTree, step: Optional[int] = None,
                shardings: Optional[PyTree] = None) -> Tuple[PyTree, int]:
        """Load a checkpoint into the structure of ``like``: each tensor
        leaf onto its ``like`` leaf's device and dtype (a numpy leaf gives a
        CPU tensor of its dtype, a number a CPU tensor of the stored one).

        ``shardings`` (a tree of ``runtime.sharding.NamedSharding`` shaped
        like the state, ``runtime.elastic.state_shardings``): each leaf is
        laid out on its sharding's mesh as a ``DTensor``, on the mesh's
        device type: the reference's elastic restore onto another mesh (a
        None sharding leaves its leaf as restored, as ``device_put`` to
        None does).
        Without it a ``DTensor`` leaf of ``like`` gives a ``DTensor`` with
        its mesh and placements.
        """
        steps = self.steps(include_cold=True)
        if not steps:
            raise FileNotFoundError("no checkpoints")
        step = step if step is not None else steps[-1]
        path = self._path_for(step)
        if path is None:
            raise FileNotFoundError(f"checkpoint step {step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, _ = tree_flatten(like)
        assert len(leaves) == len(manifest["leaves"]), \
            "checkpoint/state structure mismatch"
        out = []
        for info, ref_leaf in zip(manifest["leaves"], leaves):
            arr = np.load(os.path.join(path, info["file"]))
            if info["dtype"] == "bfloat16":   # no ml_dtypes: an int16 view
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            elif isinstance(ref_leaf, np.ndarray):
                t = torch.from_numpy(arr.astype(ref_leaf.dtype))
            else:
                t = torch.from_numpy(arr)
            if isinstance(ref_leaf, DTensor):
                mesh = ref_leaf.device_mesh
                t = lay_out(t.to(device=mesh.device_type,
                                 dtype=ref_leaf.dtype),
                            mesh, ref_leaf.placements)
            elif isinstance(ref_leaf, torch.Tensor):
                t = t.to(device=ref_leaf.device, dtype=ref_leaf.dtype)
            out.append(t)
        state = tree_unflatten(like, out)
        if shardings is not None:
            state = reshard_state(state, shardings)
        return state, step

    # -- retention / archive / undelete (the Robinhood policies) ---------------
    def apply_retention(self) -> dict:
        """keep_last live; archive every nth to cold; purge rest to trash."""
        report = {"archived": [], "trashed": [], "purged": []}
        live = self.steps()
        victims = live[:-self.keep_last] if self.keep_last else []
        for step in victims:
            name = self._ckpt_name(step)
            src = os.path.join(self.dir, name)
            if not os.path.exists(src):
                continue
            if self.archive_every and step % self.archive_every == 0:
                shutil.move(src, os.path.join(self.cold_dir, name))
                report["archived"].append(step)
            else:
                shutil.move(src, os.path.join(self.trash_dir, name))
                report["trashed"].append(step)
            for leaf in os.listdir(os.path.join(
                    self.cold_dir if step in report["archived"]
                    else self.trash_dir, name)):
                self.store.record_delete(os.path.join(src, leaf))
        # bound the trash tier (true purge)
        trash = sorted(os.listdir(self.trash_dir))
        while len(trash) > self.trash_capacity:
            victim = trash.pop(0)
            shutil.rmtree(os.path.join(self.trash_dir, victim))
            report["purged"].append(int(victim.split("_")[1]))
        return report

    def undelete(self, step: int) -> bool:
        """Bring a trashed checkpoint back (paper's undelete)."""
        name = self._ckpt_name(step)
        src = os.path.join(self.trash_dir, name)
        if not os.path.exists(src):
            return False
        shutil.move(src, os.path.join(self.dir, name))
        for leaf in os.listdir(os.path.join(self.dir, name)):
            self.store.record_write(os.path.join(self.dir, name, leaf))
        return True
