"""Shipped policy plugins (C10 — robinhood v3 architecture, Fig. 4).

Each plugin is an action factory: given runtime handles it returns an
``Action`` callable usable in a :class:`PolicyDefinition`. Administrators
compose policies from these "with a few lines of configuration"; custom
plugins are just new callables registered in :data:`PLUGIN_REGISTRY`.

Batch interface (zero-materialization contract)
-----------------------------------------------

Actions may expose a vectorized form by attaching an
``action_batch(batch, params) -> list[bool]`` attribute to the callable.
``batch`` is a :class:`~repro_torch.core.catalog.ColumnBatch` — parallel numpy
columns (``batch.fids``, ``batch.size``, ``batch.hsm_state``, interned
codes with ``batch.decode("owner")`` for lazy string access) gathered
straight from the catalog shards with **no per-entry Python object**. The
engine calls it once per rule group per chunk; actions apply their effects
with one filesystem pass plus one ``catalog.*_batch`` commit.

Actions that genuinely need full :class:`Entry` objects (names, paths,
xattrs) declare ``needs_entries = True`` next to ``action_batch``; the
engine then materializes entries for that action alone and passes
``List[Entry]`` instead. Everything else rides the Entry-free path.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .catalog import Catalog, ColumnBatch
from .types import Entry, HsmState

PluginFactory = Callable[..., Callable[[Entry, dict], bool]]
PLUGIN_REGISTRY: Dict[str, PluginFactory] = {}


def register_plugin(name: str) -> Callable[[PluginFactory], PluginFactory]:
    def deco(fn: PluginFactory) -> PluginFactory:
        PLUGIN_REGISTRY[name] = fn
        return fn
    return deco


@register_plugin("purge")
def purge_plugin(fs, catalog: Catalog) -> Callable[[Entry, dict], bool]:
    """Delete entries (classic cleanup policy)."""

    def action(e: Entry, params: dict) -> bool:
        fs.unlink(e.fid)
        catalog.remove(e.fid)
        return True

    def action_batch(batch: ColumnBatch, params: dict) -> List[bool]:
        oks = []
        gone = []
        for fid in batch.fids.tolist():
            try:
                fs.unlink(fid)
                oks.append(True)
                gone.append(fid)
            except Exception:
                oks.append(False)
        catalog.remove_batch(gone)
        return oks

    action.action_batch = action_batch
    return action


@register_plugin("rmdir_empty")
def rmdir_plugin(fs, catalog: Catalog) -> Callable[[Entry, dict], bool]:
    """Remove old empty directories.

    The scalar path needs a ``readdir`` per entry; the batch path derives
    a vectorized per-directory child-count column from the catalog's
    ``parent_fid`` column — the same one-vector groupby as
    ``Reports.top_dirs_by_count`` — cached per :attr:`Catalog.version`.
    Within a chunk, directories are processed in plan order with their
    counts decremented as children are removed, so a parent emptied by a
    child earlier in the chunk is removed exactly like the scalar
    readdir path would; one batched catalog commit, no per-directory
    filesystem listing.
    """

    # sorted unique parent fids + child counts, rebuilt when the catalog
    # ticks (removals inside a run can empty ancestors; the next chunk
    # re-derives)
    cache = {"version": -1, "parents": None, "counts": None}

    def _child_counts(fids: np.ndarray) -> List[int]:
        version = catalog.version
        if cache["version"] != version:
            col = catalog.arrays()["parent_fid"]
            cache["parents"], cache["counts"] = np.unique(
                col[col >= 0], return_counts=True)
            cache["version"] = version
        parents, counts = cache["parents"], cache["counts"]
        if not len(parents):
            return [0] * len(fids)
        pos_c = np.clip(np.searchsorted(parents, fids), 0, len(parents) - 1)
        hit = parents[pos_c] == fids
        return np.where(hit, counts[pos_c], 0).tolist()

    def action(e: Entry, params: dict) -> bool:
        if fs.readdir(e.fid):
            return False
        fs.unlink(e.fid)
        catalog.remove(e.fid)
        return True

    def action_batch(batch: ColumnBatch, params: dict) -> List[bool]:
        fids = batch.fids.tolist()
        parent_of = batch.parent_fid.tolist()
        remaining = dict(zip(fids, _child_counts(batch.fids)))
        oks = [False] * len(fids)
        gone = []
        for i, fid in enumerate(fids):
            if remaining.get(fid, 0):
                continue                    # still has children
            try:
                fs.unlink(fid)
            except Exception:
                continue
            oks[i] = True
            gone.append(fid)
            if parent_of[i] in remaining:   # parent may empty in-chunk
                remaining[parent_of[i]] -= 1
        catalog.remove_batch(gone)
        return oks

    action.action_batch = action_batch
    return action


@register_plugin("archive")
def archive_plugin(fs, catalog: Catalog) -> Callable[[Entry, dict], bool]:
    def action(e: Entry, params: dict) -> bool:
        fs.hsm_archive(e.fid, archive_id=params.get("archive_id", 1))
        catalog.update_fields(e.fid, hsm_state=HsmState.ARCHIVED)
        return True

    def action_batch(batch: ColumnBatch, params: dict) -> List[bool]:
        archive_id = params.get("archive_id", 1)
        oks = []
        done = []
        for fid in batch.fids.tolist():
            try:
                fs.hsm_archive(fid, archive_id=archive_id)
                oks.append(True)
                done.append(fid)
            except Exception:
                oks.append(False)
        catalog.update_fields_batch(done, hsm_state=HsmState.ARCHIVED)
        return oks

    action.action_batch = action_batch
    return action


@register_plugin("release")
def release_plugin(fs, catalog: Catalog) -> Callable[[Entry, dict], bool]:
    def action(e: Entry, params: dict) -> bool:
        fs.hsm_release(e.fid)
        catalog.update_fields(e.fid, hsm_state=HsmState.RELEASED, blocks=0)
        return True

    def action_batch(batch: ColumnBatch, params: dict) -> List[bool]:
        oks = []
        done = []
        for fid in batch.fids.tolist():
            try:
                fs.hsm_release(fid)
                oks.append(True)
                done.append(fid)
            except Exception:
                oks.append(False)
        catalog.update_fields_batch(done, hsm_state=HsmState.RELEASED,
                                    blocks=0)
        return oks

    action.action_batch = action_batch
    return action


@register_plugin("migrate_pool")
def migrate_pool_plugin(fs, catalog: Catalog) -> Callable[[Entry, dict], bool]:
    """Internal data migration between OST pools (paper SIII-D: SSD<->HDD).

    Re-stripes a file's data onto the target pool's OSTs (simulated move)
    and updates pool/ost metadata — the 'data must be moved between pools of
    storage resources according to site-specific policies' case.

    The batch form takes the FS lock once per chunk and applies the space
    accounting as a **per-OST grouped restripe**: frees are summed per
    source OST and allocations per target OST, one ``free``/``alloc`` call
    per OST instead of one per file stripe, followed by a single catalog
    batch commit.
    """

    def _new_stripes(target_pool: str):
        cands = fs.pools.get(target_pool)
        if not cands:
            return None
        n = min(fs.stripe_count, len(cands))
        return tuple(cands[i % len(cands)] for i in range(n))

    def action(e: Entry, params: dict) -> bool:
        target_pool = params.get("pool", "")
        new_stripes = _new_stripes(target_pool)
        if new_stripes is None:
            return False
        node = fs._nodes.get(e.fid)
        if node is None:
            return False
        with fs._lock:
            per = node.data_len // max(1, len(e.stripe_osts)) if e.stripe_osts else 0
            for idx in e.stripe_osts:
                fs.osts[idx].free(per)
            per_new = node.data_len // max(1, len(new_stripes))
            for idx in new_stripes:
                fs.osts[idx].alloc(per_new)
            node.entry.stripe_osts = new_stripes
            node.entry.ost_idx = new_stripes[0] if new_stripes else -1
            node.entry.pool = target_pool
        catalog.update_fields(e.fid, pool=target_pool,
                              ost_idx=new_stripes[0] if new_stripes else -1,
                              stripe_osts=new_stripes)
        return True

    def action_batch(batch: ColumnBatch, params: dict) -> List[bool]:
        target_pool = params.get("pool", "")
        new_stripes = _new_stripes(target_pool)
        fids = batch.fids.tolist()
        if new_stripes is None:
            return [False] * len(fids)
        oks = [False] * len(fids)
        moved: List[int] = []
        freed: Dict[int, int] = {}       # per-source-OST grouped frees
        alloc_total = 0                  # per-target-OST grouped allocs
        with fs._lock:
            for i, fid in enumerate(fids):
                node = fs._nodes.get(fid)
                if node is None:
                    continue
                stripes = node.entry.stripe_osts
                per = node.data_len // max(1, len(stripes)) if stripes else 0
                for idx in stripes:
                    freed[idx] = freed.get(idx, 0) + per
                alloc_total += node.data_len // max(1, len(new_stripes))
                node.entry.stripe_osts = new_stripes
                node.entry.ost_idx = new_stripes[0] if new_stripes else -1
                node.entry.pool = target_pool
                oks[i] = True
                moved.append(fid)
            for idx, nbytes in freed.items():
                fs.osts[idx].free(nbytes)
            for idx in new_stripes:
                fs.osts[idx].alloc(alloc_total)
        catalog.update_fields_batch(
            moved, pool=target_pool,
            ost_idx=new_stripes[0] if new_stripes else -1,
            stripe_osts=new_stripes)
        return oks

    action.action_batch = action_batch
    return action


@register_plugin("checksum")
def checksum_plugin(fs, catalog: Catalog) -> Callable[[Entry, dict], bool]:
    """Data-integrity check pass (paper SIII-D 'data integrity checks').

    The sim has no payload bytes; we verify metadata consistency instead:
    catalog size/blocks must match FS truth. The batch form compares the
    catalog's size column against FS stats in one pass and commits the
    check/corrupt verdicts with one grouped catalog update per outcome.
    """

    def action(e: Entry, params: dict) -> bool:
        truth = fs.stat(e.fid)
        if truth is None:
            return False
        ok = truth.size == e.size
        catalog.update_fields(e.fid, status="checked" if ok else "corrupt")
        return ok

    def _truth_sizes(fids: List[int]) -> List[Optional[int]]:
        """FS-truth sizes for a chunk: one FS lock when the backend exposes
        its node table (LustreSim), else a stat per fid."""
        nodes = getattr(fs, "_nodes", None)
        if nodes is not None and hasattr(fs, "_lock"):
            with fs._lock:
                return [nodes[f].entry.size if f in nodes else None
                        for f in fids]
        out: List[Optional[int]] = []
        for f in fids:
            truth = fs.stat(f)
            out.append(None if truth is None else truth.size)
        return out

    def action_batch(batch: ColumnBatch, params: dict) -> List[bool]:
        fids = batch.fids.tolist()
        sizes = batch.size.tolist()
        oks = [False] * len(fids)
        checked: List[int] = []
        corrupt: List[int] = []
        for i, (fid, size, truth) in enumerate(
                zip(fids, sizes, _truth_sizes(fids))):
            if truth is None:
                continue
            if truth == size:
                oks[i] = True
                checked.append(fid)
            else:
                corrupt.append(fid)
        if checked:
            catalog.update_fields_batch(checked, status="checked")
        if corrupt:
            catalog.update_fields_batch(corrupt, status="corrupt")
        return oks

    action.action_batch = action_batch
    return action


@register_plugin("tag_status")
def tag_status_plugin(fs, catalog: Catalog) -> Callable[[Entry, dict], bool]:
    """Generic post-processing: set the v3 status field."""

    def action(e: Entry, params: dict) -> bool:
        return catalog.update_fields(e.fid, status=params.get("status", "seen"))

    def action_batch(batch: ColumnBatch, params: dict) -> List[bool]:
        fids = batch.fids.tolist()
        updated = set(catalog.update_fields_batch(
            fids, status=params.get("status", "seen")))
        return [fid in updated for fid in fids]

    action.action_batch = action_batch
    return action
