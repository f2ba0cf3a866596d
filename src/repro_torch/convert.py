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
(as numpy arrays) into a ``state_dict`` for the port's ``PagedLM``, and
:func:`model_state_dict` carries the model zoo's ``Model.init`` parameters
into a ``state_dict`` for the port's ``models.Model``; :func:`model_cache`
maps the reference's decode caches the same way, so the two can be compared
layer by layer. :func:`train_state` maps a reference train state
(parameters, AdamW moments, counts) onto the port's, so both packages can
train from one state.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

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


def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype; bf16 arrays (numpy
    has no bf16 of its own: the reference's come as ``ml_dtypes``) cross
    bit for bit through an int16 view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Mapping, prefix: str, out: Dict[str, Any]) -> None:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            _flatten(val, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = val


def _row(stacked: Mapping, i: int) -> Dict[str, Any]:
    """Row ``i`` of every leaf of a stacked subtree, as a nested dict (a
    0-d leaf where the stacked one was 1-D, e.g. a cross-attention gate)."""
    flat: Dict[str, Any] = {}
    _flatten(stacked, "", flat)
    layer: Dict[str, Any] = {}
    for key, val in flat.items():
        node = layer
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(val)[i]
    return layer


def _per_layer(tree: Mapping, cfg) -> List[Mapping]:
    """The reference's ``scan``/``tail`` grouping as one entry a layer:
    ``tree["scan"][j]`` row ``i`` is layer ``i * period + j`` and
    ``tree[f"tail{t}"]`` is layer ``n_super * period + t``."""
    period = len(cfg.pattern)
    layers: List[Mapping] = []
    for n in range(cfg.n_layers):
        i, j = divmod(n, period)
        if i < cfg.n_super:
            layers.append(_row(tree["scan"][j], i))
        else:
            layers.append(tree[f"tail{n - cfg.n_super * period}"])
    return layers


def model_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's :class:`~repro_torch.models.Model`
    from the reference ``Model(cfg).init(key)`` pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``). Keys: ``embed``, ``final.<n>``,
    ``lm_head``, ``pos_embed`` where the reference has them,
    ``layers.<l>.<group>.<name>`` for every layer in ``cfg.layers`` order,
    and for an encoder ``encoder.pos``, ``encoder.final.<n>`` and
    ``encoder.layers.<i>.<group>.<name>`` (row ``i`` of the reference's
    stacked ``encoder.layers``); values keep the reference's dtypes (bf16
    or f32) on the CPU."""
    flat: Dict[str, Any] = {}
    _flatten({k: v for k, v in params.items()
              if k not in ("scan", "encoder") and not k.startswith("tail")},
             "", flat)
    for n, layer in enumerate(_per_layer(params, cfg)):
        _flatten(layer, f"layers.{n}.", flat)
    if "encoder" in params:
        enc = params["encoder"]
        _flatten({k: v for k, v in enc.items() if k != "layers"},
                 "encoder.", flat)
        for i in range(cfg.encoder.n_layers):
            _flatten(_row(enc["layers"], i), f"encoder.layers.{i}.", flat)
    return {k: _tensor(v) for k, v in flat.items()}


def model_cache(cache: Mapping, cfg) -> List[Dict[str, torch.Tensor]]:
    """The port's cache layout (one dict a layer, in ``cfg.layers`` order)
    from a reference ``init_cache``/``prefill``/``decode_step`` cache with
    numpy leaves, as CPU tensors of the reference's dtypes, bit for bit
    (cross-attention ``xk``/``xv`` and the int8 ``k``/``v`` with their f32
    ``kscale``/``vscale`` too)."""
    return [{k: _tensor(v) for k, v in layer.items()}
            for layer in _per_layer(cache, cfg)]


def train_state(state: Mapping, cfg) -> Dict[str, Any]:
    """The port's train state from the reference's
    ``{"params", "opt": {"m", "v", "count"}, "step"}`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``): ``params``, ``m`` and ``v``
    through :func:`model_state_dict` (the moments have the parameters'
    layout), ``count`` and ``step`` as 0-d int32 tensors, all on the
    CPU. ``Model.bind_params`` (the train step) copies ``params`` into a
    model."""
    opt = state["opt"]
    return {"params": model_state_dict(state["params"], cfg),
            "opt": {"m": model_state_dict(opt["m"], cfg),
                    "v": model_state_dict(opt["v"], cfg),
                    "count": _tensor(opt["count"])},
            "step": _tensor(state["step"])}
