"""Sharding rules: parameter/cache/batch partition specs per architecture
(the reference's ``runtime/sharding.py``).

Profiles:

* ``tp`` (default): tensor parallel over "model" (heads / d_ff / vocab
  columns), data parallel over ("pod",)+"data"; optimizer states are
  additionally sharded over "data" (ZeRO-1).
* ``fsdp``: like ``tp`` but parameters themselves are also sharded over
  "data" at rest — required for mixtral-8x22b / llama4-400b whose TP-only
  shards exceed a device's memory.

Dims that do not divide the mesh axis are left unsharded (deepseek's 56
heads, whisper's vocab of 51,866), as in the reference.

The reference describes a layout with ``jax.sharding.PartitionSpec`` and
``NamedSharding``. Here :class:`P` is the same tuple of axis names (or
None, or a tuple of names) per tensor dim, :func:`to_placements` turns it
into one ``Shard``/``Replicate`` per dim of a
``torch.distributed.device_mesh.DeviceMesh``, and :class:`NamedSharding`
pairs the two; :func:`lay_out` lays a logical tensor out as a
``DTensor``. The rules read a mesh's axis names and sizes only, so a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` mapping
(the reference tests' ``FakeMesh``) will do.

The port keeps one tensor a layer (``layers.<i>.<group>.<name>``,
``repro_torch.convert.model_state_dict``), not the reference's stacked
``scan`` leaves: the rules give each layer's tensor the reference's
base-shape spec, which is the reference's spec with its stacking axis
dropped. Trees are the port's own: a parameter or moment dict keyed by
name, a cache as a list of per-layer dicts, a batch dict (``extras``
nested).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

PyTree = Any


class P(tuple):
    """A partition spec: per tensor dim None (replicated), a mesh axis
    name, or a tuple of names (sharded over their product, the first
    major). ``P()`` replicates a tensor of any rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    if hasattr(mesh, "mesh_dim_names"):            # a DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...] = ("data",)     # ("pod","data") on multi-pod
    tp: str = "model"

    @classmethod
    def from_mesh(cls, mesh) -> "MeshAxes":
        names = tuple(mesh_axes(mesh))
        dp = tuple(n for n in names if n in ("pod", "data"))
        return cls(dp=dp, tp="model" if "model" in names else names[-1])


def _axis_size(mesh, name) -> int:
    sizes = mesh_axes(mesh)
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= sizes[n]
        return out
    return sizes[name]


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _leaf_name(name: str) -> str:
    """The last part of a dotted name that is not a layer index."""
    for part in reversed(name.split(".")):
        if not part.isdigit():
            return part
    return ""


class ShardingRules:
    """Derives partition specs for a model's params/caches/batches."""

    def __init__(self, cfg, mesh, profile: str = "tp") -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.axes = MeshAxes.from_mesh(mesh)
        self.tp_size = _axis_size(mesh, self.axes.tp)
        self.dp_size = _axis_size(mesh, self.axes.dp)
        self.profile = profile

    # -- helpers ---------------------------------------------------------------
    def _col(self, dim: int) -> Optional[str]:
        """Shard a dim over tp if it divides evenly."""
        return self.axes.tp if dim % self.tp_size == 0 else None

    def _param_rule(self, name: str, shape: Tuple[int, ...]) -> P:
        cfg = self.cfg
        c = self._col
        if name == "embed" and getattr(cfg, "tie_embeddings", False):
            # tied: vocab-sharded so the head matmul emits vocab-sharded
            # logits with no collective
            return P(c(shape[0]), None)
        if name in ("embed", "pos_embed", "pos"):
            return P(None, c(shape[-1]))
        if name == "lm_head":
            return P(None, c(shape[-1]))
        if name in ("wq", "wk", "wv", "w1", "w3", "s1", "s3", "w_gate",
                    "w_in", "w_a", "w_x", "wr", "wg", "maa_a", "wd_a"):
            return P(*([None] * (len(shape) - 1) + [c(shape[-1])]))
        if name in ("wo", "w2", "s2", "w_out"):
            # row-parallel: contraction dim sharded
            return P(*([None] * (len(shape) - 2) + [c(shape[-2]), None]))
        if name == "router":
            return P(None, None)
        if name in ("bq", "bk", "bv", "b1", "b_a", "b_x", "lam", "w0",
                    "gn_w"):
            return P(c(shape[-1]))
        if name == "conv_w":
            return P(None, c(shape[-1]))
        if name == "mu":
            return P(None, c(shape[-1]))
        if name in ("maa_b", "wd_b"):
            return P(*([None] * (len(shape) - 1) + [c(shape[-1])]))
        if name == "u":
            return P(c(shape[0]), None) if len(shape) == 2 else P(None)
        # norms, biases, gates, scalars: replicate
        return P(*([None] * len(shape)))

    def _moe_rule(self, name: str, shape: Tuple[int, ...]) -> Optional[P]:
        """Expert tensors (E, D, F) / (E, F, D): EP if E divides tp, else TP."""
        if name not in ("w1", "w3", "w2") or len(shape) < 3:
            return None
        E = self.cfg.moe.num_experts if self.cfg.moe else 0
        if shape[-3] != E or E == 0:
            return None
        lead = [None] * (len(shape) - 3)
        if E % self.tp_size == 0:
            return P(*lead, self.axes.tp, None, None)        # EP
        if name == "w2":
            return P(*lead, None, self._col(shape[-2]), None)  # TP rows
        return P(*lead, None, None, self._col(shape[-1]))      # TP cols

    def _fsdpify(self, spec: P, shape: Tuple[int, ...]) -> P:
        """Also shard the largest unsharded dim over data (params at rest)."""
        if len(shape) < 2 or _prod(shape) < (1 << 20):
            return spec
        dp = self.axes.dp
        dims = list(spec) + [None] * (len(shape) - len(spec))
        best, best_size = -1, 0
        for i, (d, s) in enumerate(zip(dims, shape)):
            if d is None and s % self.dp_size == 0 and s > best_size:
                best, best_size = i, s
        if best >= 0:
            dims[best] = dp if len(dp) > 1 else dp[0]
        return P(*dims)

    def _dp_if(self, dim: int):
        """dp axis spec if the dim divides the dp size (B=1 long-context)."""
        if dim % self.dp_size != 0:
            return None
        return self.axes.dp if len(self.axes.dp) > 1 else self.axes.dp[0]

    def _spec(self, name: str, shape: Tuple[int, ...], fsdp: bool) -> P:
        leaf = _leaf_name(name)
        spec = self._moe_rule(leaf, shape)
        if spec is None:
            spec = self._param_rule(leaf, shape)
        return self._fsdpify(spec, shape) if fsdp else spec

    # -- public API -----------------------------------------------------------
    def param_pspecs(self, params: Mapping[str, Any]) -> Dict[str, P]:
        """A spec for each named parameter (anything with ``.shape``)."""
        fsdp = self.profile == "fsdp"
        return {k: self._spec(k, tuple(v.shape), fsdp)
                for k, v in params.items()}

    def opt_state_pspecs(self, params: Mapping[str, Any]) -> Dict[str, P]:
        """ZeRO-1: moments sharded over data on top of the param sharding."""
        return {k: self._spec(k, tuple(v.shape), True)
                for k, v in params.items()}

    def cache_pspecs(self, cache: Sequence[Mapping[str, Any]]
                     ) -> list:
        """Decode-cache sharding: batch over dp; heads (or head_dim) over
        tp. ``cache``: one dict a layer (``Model.init_cache``)."""

        def rule(name: str, shape: Tuple[int, ...]) -> P:
            nd = len(shape)
            if name in ("k", "v", "xk", "xv"):
                # (..., B, L, K, hd)
                lead = [None] * (nd - 4)
                dp = self._dp_if(shape[-4])
                kspec = self._col(shape[-2])
                hspec = None if kspec else self._col(shape[-1])
                return P(*lead, dp, None, kspec, hspec)
            if name in ("kscale", "vscale"):     # (..., B, L, K, 1)
                lead = [None] * (nd - 4)
                return P(*lead, self._dp_if(shape[-4]), None,
                         self._col(shape[-2]), None)
            if name == "h":                     # (..., B, R)
                return P(*([None] * (nd - 2)), self._dp_if(shape[-2]),
                         self._col(shape[-1]))
            if name == "conv":                  # (..., B, w-1, R)
                return P(*([None] * (nd - 3)), self._dp_if(shape[-3]),
                         None, self._col(shape[-1]))
            if name == "s":                     # (..., B, H, hd, hd)
                return P(*([None] * (nd - 4)), self._dp_if(shape[-4]),
                         self._col(shape[-3]), None, None)
            if name in ("shift_t", "shift_c"):  # (..., B, D)
                return P(*([None] * (nd - 2)), self._dp_if(shape[-2]),
                         self._col(shape[-1]))
            return P(*([None] * nd))

        return [{k: rule(k, tuple(v.shape)) for k, v in layer.items()}
                for layer in cache]

    def batch_pspecs(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """Batch dim over dp. Supports a leading grad-accum dim."""

        def rule(name: str, shape: Tuple[int, ...]) -> P:
            nd = len(shape)
            if name in ("tokens", "labels"):
                return P(*([None] * (nd - 2)), self._dp_if(shape[-2]), None)
            if name in ("frames", "img"):
                return P(*([None] * (nd - 3)), self._dp_if(shape[-3]),
                         None, self._col(shape[-1]))
            if name == "pos":
                return P()
            return P(*([None] * nd))

        def walk(node):
            return {k: walk(v) if isinstance(v, Mapping)
                    else rule(k, tuple(v.shape)) for k, v in node.items()}
        return walk(batch)

    # -- NamedSharding wrappers -------------------------------------------------
    def to_shardings(self, pspec_tree: PyTree) -> PyTree:
        return tree_map(lambda s: NamedSharding(self.mesh, s), pspec_tree,
                        is_leaf=lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: P, mesh) -> Tuple[Any, ...]:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim: ``Shard(d)`` where
    tensor dim ``d``'s entry names that mesh axis (alone or in a tuple;
    DTensor splits over mesh dims in mesh order, which is the reference's
    major-first order for the rules' ``("pod", "data")``)."""
    out = []
    for axis in mesh_axes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        if len(dims) > 1:
            raise ValueError(f"{spec}: mesh axis {axis!r} shards two dims")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> Tuple[Any, ...]:
        return to_placements(self.spec, self.mesh)


def shard_view(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t``, a logical tensor every rank holds whole,
    as a view: ``torch.chunk`` along each ``Shard`` dim, mesh dim by mesh
    dim (the split ``DTensor`` uses). No communication."""
    coord = mesh.get_coordinate()
    out = t
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out = out.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return out


def local_chunk(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """:func:`shard_view` as a tensor of its own: ``t`` itself where the
    shard is all of it, else a contiguous copy (which does not keep ``t``
    alive)."""
    out = shard_view(t, mesh, placements)
    if out.shape == t.shape:        # every Shard over a mesh dim of size 1
        return t
    return out.clone(memory_format=torch.contiguous_format)


def lay_out(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (a logical tensor every rank holds whole, on the mesh's device
    type) as a ``DTensor`` with ``placements``, without communication.
    Outside autograd: a state's leaves, not a step of a model."""
    t = t.detach()
    return DTensor.from_local(local_chunk(t, mesh, placements), mesh,
                              tuple(placements), run_check=False,
                              shape=t.shape, stride=t.stride())


# ---------------------------------------------------------------------------
# a rank's share of a state, a cache and a batch (the partitioned steps)
# ---------------------------------------------------------------------------

def _local_tree(laid: PyTree) -> Tuple[PyTree, PyTree]:
    """A tree of ``DTensor``\\s as (this rank's shards, their placements)."""
    return (tree_map(lambda t: t.to_local(), laid),
            tree_map(lambda t: tuple(t.placements), laid))


def lay_out_params(cfg, mesh, params: Mapping[str, torch.Tensor],
                   profile: str = "tp") -> Tuple[Dict[str, torch.Tensor],
                                                  Dict[str, tuple]]:
    """A model's parameters (name -> whole tensor, or a ``DTensor``) laid
    out by ``param_pspecs`` on ``mesh`` (``elastic.reshard_state``): this
    rank's shard of each, a plain tensor (the tensor itself where the
    shard is all of it), and each one's placements, for a
    ``runtime.partition.Partition`` (the serving steps' ``params=`` and
    ``part=``)."""
    from .elastic import reshard_state
    rules = ShardingRules(cfg, mesh, profile)
    return _local_tree(reshard_state(dict(params), rules.to_shardings(
        rules.param_pspecs(params))))


def lay_out_cache(cfg, mesh, cache: Sequence[Mapping[str, torch.Tensor]]
                  ) -> Tuple[list, list]:
    """A decode cache (one dict a layer, whole: ``Model.init_cache`` or
    ``Model.prefill`` unpartitioned) laid out by ``cache_pspecs``: this
    rank's shards (the shapes ``Model.init_cache(part=)`` gives) and their
    placements."""
    from .elastic import reshard_state
    rules = ShardingRules(cfg, mesh)
    return _local_tree(reshard_state(
        [dict(layer) for layer in cache],
        rules.to_shardings(rules.cache_pspecs(cache))))


def local_batch(cfg, mesh, batch: Mapping[str, Any], device
                ) -> Tuple[Dict[str, Any], bool]:
    """This rank's part of ``batch`` by ``batch_pspecs`` (a leaf is a
    ``DTensor`` laid out so, or a whole tensor every rank holds), and
    whether the rows are split over the data axes."""
    specs = ShardingRules(cfg, mesh).batch_pspecs(batch)

    def local(t, spec):
        pl = to_placements(spec, mesh)
        if isinstance(t, DTensor):
            if tuple(t.placements) != pl:
                raise ValueError(f"a batch leaf laid out as {t.placements},"
                                 f" the rules place it {pl}")
            return t.to_local()
        return shard_view(torch.as_tensor(t, device=device), mesh, pl)

    out = {k: local(v, specs[k]) for k, v in batch.items()
           if k != "extras"}
    extras = batch.get("extras") or {}
    if extras:
        out["extras"] = {k: local(v, specs["extras"][k])
                         for k, v in extras.items()}
    return out, specs["tokens"][-2] is not None


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> PyTree:
    """``fn`` over the leaves of dicts, lists and tuples (``rest``: trees
    of the same structure, their leaves passed alongside)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def profile_for(cfg) -> str:
    """fsdp for >=100B-param models, tp otherwise."""
    return "fsdp" if cfg.param_count() > 100e9 else "tp"
