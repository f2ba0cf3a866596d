"""Carry a catalog's state over from the reference package.

The policy engine runs no model, so its counterpart of weights is the
catalog: :func:`catalog_from_columns` rebuilds a port
:class:`~repro_torch.core.catalog.Catalog` from the column dict that the
reference ``Catalog.arrays()`` returns (as numpy arrays, ``_names`` and
``_paths`` included) and the reference ``StringTable``'s strings in code
order. Entries go in through the port's own ``Entry`` and ``upsert_batch``,
so the result has the same entries, the same row order and the same
string codes.

The profile cube's state needs no function here: ``ProfileCube.save`` and
``ProfileCube.load`` write and read the same ``np.savez_compressed`` file
in both packages (per-shard cube, fids and entry tables plus the
``GroupIndex`` export), so a cube saved by either loads into the other
over catalogs with the same string codes.

The serving engine's weights come from ``jax.random`` in the reference,
which torch cannot reproduce: :func:`paged_lm_state_dict` carries them over
(as numpy arrays) into a ``state_dict`` for the port's ``PagedLM``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .core.catalog import Catalog
from .core.types import Entry, FsType, HsmState


def catalog_from_columns(arrays: Mapping[str, np.ndarray],
                         strings: Sequence[str], n_shards: int = 4,
                         chunk: int = 100_000) -> Catalog:
    """Build a port catalog from reference ``arrays()`` columns.

    ``strings[c]`` is the string interned under code ``c`` (code 0 is the
    empty string). ``n_shards`` must match the reference catalog for
    ``arrays()`` to come back in the same row order. Stripe lists and
    xattrs are not columns, so they do not carry over.
    """
    cat = Catalog(n_shards=n_shards)
    if len(strings) == 0 or strings[0] != "":
        raise ValueError("strings must start with the empty string (code 0)")
    for code, s in enumerate(strings):
        if cat.strings.intern(s) != code:
            raise ValueError(f"string {s!r} repeats: codes must be unique")
    cols = {k: np.asarray(arrays[k]) for k in (
        "fid", "parent_fid", "type", "size", "blocks", "mode", "nlink",
        "atime", "mtime", "ctime", "ost_idx", "hsm_state", "archive_id",
        "owner", "group", "pool", "status", "dirty")}
    names, paths = arrays["_names"], arrays["_paths"]
    n = len(cols["fid"])
    for lo in range(0, n, chunk):        # chunked: bounds peak memory
        rows = {k: v[lo:lo + chunk].tolist() for k, v in cols.items()}
        cat.upsert_batch([
            Entry(fid=rows["fid"][i], parent_fid=rows["parent_fid"][i],
                  name=names[lo + i], path=paths[lo + i],
                  type=FsType(rows["type"][i]), size=rows["size"][i],
                  blocks=rows["blocks"][i],
                  owner=strings[rows["owner"][i]],
                  group=strings[rows["group"][i]],
                  mode=rows["mode"][i], nlink=rows["nlink"][i],
                  atime=rows["atime"][i], mtime=rows["mtime"][i],
                  ctime=rows["ctime"][i], ost_idx=rows["ost_idx"][i],
                  pool=strings[rows["pool"][i]],
                  hsm_state=HsmState(rows["hsm_state"][i]),
                  archive_id=rows["archive_id"][i],
                  status=strings[rows["status"][i]],
                  dirty=bool(rows["dirty"][i]))
            for i in range(len(rows["fid"]))])
    return cat


LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")


def paged_lm_state_dict(embed, head, layers: Sequence[Mapping]
                        ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~repro_torch.serve.engine.PagedLM` from
    the reference ``ServingEngine``'s ``embed``, ``head`` and ``layers``
    (a list of dicts of ``wq, wk, wv, wo, w1, w2``), each as a numpy array
    (``np.asarray(ref.embed)``, ...). Keys mirror the reference's names:
    ``embed``, ``head``, ``layers.<i>.<name>``; values are f32 CPU tensors
    in the same (in, out) layout."""
    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {"embed": f32(embed), "head": f32(head)}
    for i, layer in enumerate(layers):
        if set(layer) != set(LAYER_WEIGHTS):
            raise ValueError(f"layer {i} has {sorted(layer)}, expected "
                             f"{sorted(LAYER_WEIGHTS)}")
        for name in LAYER_WEIGHTS:
            out[f"layers.{i}.{name}"] = f32(layer[name])
    return out
