"""Lustre-HSM coordination (C8): archive / release / purge policies.

Implements the paper's HSM binding as shipped policy configurations over the
generic engine (v3 style):

* **archive**: copy modified (NEW/DIRTY) files older than ``archive_age`` to
  the HSM backend;
* **release**: when an OST crosses its high watermark, punch archived+cold
  file data from that OST until below the low watermark (LRU order);
* **hsm_remove**: drop backend copies of entries deleted from the FS;
* **undelete / disaster recovery** helpers: the catalog retains enough
  metadata to re-create a released/removed entry's stub and restore payload
  from the HSM backend.
"""
from __future__ import annotations

import time
from typing import List, Optional

from .catalog import Catalog
from .policy import parse_expr
from .policy_engine import (PolicyDefinition, PolicyEngine, RunReport,
                            UsageWatermarkTrigger)
from .types import Entry, FsType, HsmState


class HsmCoordinator:
    """Wires archive/release policies between a LustreSim and its HSM."""

    def __init__(self, fs, catalog: Catalog, engine: PolicyEngine,
                 archive_age: str = "0s", archive_id: int = 1,
                 high_wm: float = 80.0, low_wm: float = 60.0) -> None:
        self.fs = fs
        self.catalog = catalog
        self.engine = engine
        self.archive_id = archive_id

        # -- archive policy: new/dirty files, old enough, not released
        def do_archive(e: Entry, params: dict) -> bool:
            aid = params.get("archive_id", self.archive_id)
            self.fs.hsm_archive(e.fid, archive_id=aid)
            self.catalog.update_fields(e.fid, hsm_state=HsmState.ARCHIVED,
                                       archive_id=aid)
            return True

        def do_archive_batch(batch, params: dict) -> List[bool]:
            # Entry-free: consumes a ColumnBatch, touches only fid columns
            aid = params.get("archive_id", self.archive_id)
            oks = []
            done = []
            for fid in batch.fids.tolist():
                try:
                    self.fs.hsm_archive(fid, archive_id=aid)
                    oks.append(True)
                    done.append(fid)
                except Exception:
                    oks.append(False)
            self.catalog.update_fields_batch(
                done, hsm_state=HsmState.ARCHIVED, archive_id=aid)
            return oks

        do_archive.action_batch = do_archive_batch

        self.engine.register(PolicyDefinition.from_config(
            name="hsm_archive", action=do_archive,
            scope="type == file",
            rules=[("archive_candidates",
                    f"(hsm_state == none or hsm_state == dirty) "
                    f"and last_mod >= {archive_age}", {})],
            sort_by="mtime",
        ))

        # -- release policy: archived files, LRU by atime, targeted per OST
        def do_release(e: Entry, params: dict) -> bool:
            self.fs.hsm_release(e.fid)
            self.catalog.update_fields(e.fid, hsm_state=HsmState.RELEASED,
                                       blocks=0)
            return True

        def do_release_batch(batch, params: dict) -> List[bool]:
            # Entry-free: consumes a ColumnBatch, touches only fid columns
            oks = []
            done = []
            for fid in batch.fids.tolist():
                try:
                    self.fs.hsm_release(fid)
                    oks.append(True)
                    done.append(fid)
                except Exception:
                    oks.append(False)
            self.catalog.update_fields_batch(
                done, hsm_state=HsmState.RELEASED, blocks=0)
            return oks

        do_release.action_batch = do_release_batch

        self.engine.register(PolicyDefinition.from_config(
            name="hsm_release", action=do_release,
            scope="type == file",
            rules=[("release_candidates", "hsm_state == archived", {})],
            sort_by="atime",
        ))

        def ost_usage():
            return [(o.index, o.used, o.capacity) for o in self.fs.osts]

        self.engine.add_watermark_trigger(
            "hsm_release",
            UsageWatermarkTrigger(
                usage_fn=ost_usage, high_pct=high_wm, low_pct=low_wm,
                restrict_fn=lambda ost: parse_expr(f"ost_idx == {int(ost)}")))

    # -- convenience drivers ----------------------------------------------------
    def archive_pass(self) -> RunReport:
        return self.engine.run("hsm_archive")

    def space_check(self) -> List[RunReport]:
        """Fire watermark purges if any OST is over threshold (C7)."""
        return self.engine.check_triggers()

    # -- undelete & disaster recovery (paper SII-C3) ------------------------------
    def undelete(self, fid: int, parent: int, name: str) -> Optional[int]:
        """Re-create a removed entry from catalog+HSM knowledge.

        Works when the backend copy still exists: a fresh stub is created and
        payload restored. Returns the new fid, or None if unrecoverable.
        """
        if self.fs.hsm is None or not self.fs.hsm.has(fid):
            return None
        size = self.fs.hsm.get(fid)
        new_fid = self.fs.create(parent, name)
        self.fs.write(new_fid, size)
        # adopt the old archive object under the new fid
        self.fs.hsm.put(new_fid, size, self.archive_id)
        self.fs.hsm.remove(fid)
        self.fs._nodes[new_fid].entry.hsm_state = HsmState.ARCHIVED
        e = self.fs.stat(new_fid)
        if e is not None:
            self.catalog.upsert(e)
        return new_fid

    def rebuild_catalog(self, scanner_threads: int = 4) -> int:
        """Disaster recovery: rebuild the DB from a full scan (C2)."""
        from .scanner import Scanner
        s = Scanner(self.fs, self.catalog, n_threads=scanner_threads)
        stats = s.scan()
        return stats.entries
