"""Subject → grant-set model for multi-tenant report scoping (``subject=``).

The ROADMAP's "millions of users" goal means ``find``/``du``/top-N/profile
queries arrive scoped to what one *subject* (a user, a service account, an
auditor) may see. This module is the host-side authority for that
visibility:

* a **subject** owns a set of grants — owner names (uid ownership), group
  names (gid membership) and directory subtrees (every entry at or under
  a path prefix);
* :meth:`GrantTable.visible_mask` is the scalar oracle: a boolean
  visibility mask over any catalog column dict — the fold the host report
  paths filter by, and the differential reference the device plane is
  pinned to byte-for-byte (``tests/core/test_tenant_scoping.py``);
* the device column store permissions
  plane (``enable_permissions_plane``) pre-materializes the same
  semantics as packed per-subject ``uint32`` bitsets over resident rows
  (subtree grants resolved through the reports plane's sorted-path
  mirrors) and ANDs the unpacked subject bitset into the mesh kernels'
  match masks — tenant scoping at serving time is one fused AND, not a
  second scan.

Every mutation bumps :attr:`GrantTable.version`; consumers key
materialized state on it (the store re-materializes stale bitsets on the
next scoped query, mirroring its catalog-version refresh contract).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

import numpy as np


class Subject:
    """One subject's grant set. Immutable — :meth:`GrantTable.grant`
    replaces the whole record so readers never see a half-updated set."""

    __slots__ = ("name", "owners", "groups", "subtrees")

    def __init__(self, name: str, owners: Iterable[str],
                 groups: Iterable[str], subtrees: Iterable[str]) -> None:
        self.name = name
        self.owners = tuple(owners)
        self.groups = tuple(groups)
        # normalized: a subtree grant covers the prefix row itself plus
        # everything under "<prefix>/" (same range shape as rbh-du)
        self.subtrees = tuple(p.rstrip("/") for p in subtrees)


class GrantTable:
    """Dense subject registry: name -> subject id -> grant set.

    Subject ids are append-only and dense (the device store's permission
    bitsets index by them); grant *content* may change at any time and
    bumps :attr:`version` so materialized bitsets know to refresh.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subjects: List[Subject] = []
        self._ids: Dict[str, int] = {}
        self.version = 0

    def __len__(self) -> int:
        return len(self._subjects)

    def add_subject(self, name: str, owners: Optional[Iterable[str]] = None,
                    groups: Iterable[str] = (),
                    subtrees: Iterable[str] = ()) -> int:
        """Register ``name`` and return its dense subject id.

        ``owners=None`` (the default) grants ownership of ``name``'s own
        files — the common "a user sees what they own" case; pass ``()``
        for a subject with no uid grant (e.g. a subtree-only auditor).
        Re-registering raises — extend an existing subject with
        :meth:`grant` instead.
        """
        with self._lock:
            if name in self._ids:
                raise ValueError(f"subject {name!r} already registered")
            sid = len(self._subjects)
            self._ids[name] = sid
            self._subjects.append(Subject(
                name, (name,) if owners is None else owners, groups,
                subtrees))
            self.version += 1
            return sid

    def grant(self, name: str, owners: Iterable[str] = (),
              groups: Iterable[str] = (),
              subtrees: Iterable[str] = ()) -> None:
        """Extend an existing subject's grant set (bumps ``version`` —
        materialized bitsets refresh on the next scoped query)."""
        with self._lock:
            sid = self._ids[name]
            s = self._subjects[sid]
            self._subjects[sid] = Subject(
                name, s.owners + tuple(owners), s.groups + tuple(groups),
                s.subtrees + tuple(subtrees))
            self.version += 1

    def _unknown(self, name: str) -> KeyError:
        known = ", ".join(sorted(self._ids)) or "<none registered>"
        return KeyError(f"unknown subject {name!r} (known subjects: {known})")

    def subject_id(self, name: str) -> int:
        with self._lock:
            try:
                return self._ids[name]
            except KeyError:
                raise self._unknown(name) from None

    def subject(self, name: str) -> Subject:
        with self._lock:
            try:
                return self._subjects[self._ids[name]]
            except KeyError:
                raise self._unknown(name) from None

    def subjects(self) -> List[Subject]:
        """Snapshot of every subject in id order (the bitset row order)."""
        with self._lock:
            return list(self._subjects)

    def visible_mask(self, name: str, cols, strings) -> np.ndarray:
        """Boolean row visibility for ``name`` over a catalog column dict
        — the scalar oracle every accelerated scoping path must match.

        ``cols`` needs the interned ``owner``/``group`` code columns;
        subtree grants additionally read the ``_paths`` gather. Names
        that were never interned (no such owner/group exists in the
        catalog) simply match nothing.
        """
        s = self.subject(name)
        owner = np.asarray(cols["owner"])
        grp = np.asarray(cols["group"])
        vis = np.zeros(owner.shape, dtype=bool)
        ocodes = [c for c in (strings.code_of(u) for u in s.owners)
                  if c is not None]
        if ocodes:
            vis |= np.isin(owner, ocodes)
        gcodes = [c for c in (strings.code_of(g) for g in s.groups)
                  if c is not None]
        if gcodes:
            vis |= np.isin(grp, gcodes)
        if s.subtrees:
            paths = np.asarray(cols["_paths"])
            for pref in s.subtrees:
                vis |= (paths == pref) | np.char.startswith(paths,
                                                            pref + "/")
        return vis
