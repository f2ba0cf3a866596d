"""Partitioned compute over a mesh: the collectives GSPMD inserts into
the reference's partitioned step, written out for the port's layer code
(the reference gets them from ``jax.jit(step, in_shardings=...)``).

A :class:`Partition` carries one rank's place on a mesh laid out by
``runtime.sharding.ShardingRules``: the "model" axis (tensor parallel)
and the data axes ("pod", "data"). The layers receive plain local
tensors (each parameter's shard, each activation's rows) and call the
partition where GSPMD would communicate:

* :meth:`~Partition.copy` before a column-parallel product (identity
  forward, all-reduce of the input's gradient backward);
* :meth:`~Partition.reduce` after a row-parallel product (the partial
  products all-reduced in f32 and cast once; identity backward), and of
  a decode step's partial attention scores over a cache's head_dim chunk
  (f32 already: summed in f32 before the softcap);
* :meth:`~Partition.gather` of columns over "model" (all-gather forward;
  backward the rank's own chunk, or with ``partial=True``, where the
  gathered tensor feeds rank-specific products, a reduce-scatter);
* :meth:`~Partition.split` of a replicated tensor into the rank's columns
  (all-gather backward);
* :meth:`~Partition.tp_max` (no gradient), :meth:`~Partition.tp_argmax`
  (the serving steps' argmax over vocab-sharded logits; no gradient),
  :meth:`~Partition.dp_sum`
  (statistics of the global batch: all-reduce over the data axes forward,
  identity backward), and for a buffer every data rank adds its rows to
  :meth:`~Partition.dp_all` (all-reduce both ways) or
  :meth:`~Partition.dp_scatter` (each rank's chunk of the sum) with
  :meth:`~Partition.dp_gather` (the chunks of the result gathered);
* :meth:`~Partition.param`: a parameter sharded over the data axes at rest
  (the ``fsdp`` profile) gathered where it is used, its gradient
  reduce-scattered back to the shard;
* :meth:`~Partition.grad_shard`: a parameter's gradient from the rank's
  rows reduced over the data axes into the f32 accumulator's layout.

Every collective is a ``torch.distributed._functional_collectives`` call
inside a ``torch.autograd.Function``: it runs on gloo and NCCL groups and
traces on the ``"fake"`` one, where ``roofline.CollectiveCounter`` counts
it. The convention is Megatron's: a tensor every "model" rank holds whole
carries its whole gradient on each of them.

A partition with every axis of size 1 (:data:`NO_PARTITION`, or a 1x1
mesh) calls no collective and returns every tensor as it was given, so a
step on it is the unsharded step bit for bit.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import Shard

Axis = Tuple[object, int, int]          # (process group, size, coordinate)


# the single-tensor names (newer PyTorch), else the older ones
_gather_fn = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
_scatter_fn = getattr(fc, "reduce_scatter_single", None) or \
    fc.reduce_scatter_tensor


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def _all_reduce(t: torch.Tensor, axes: Sequence[Axis], op: str = "sum"
                ) -> torch.Tensor:
    for group, _, _ in axes:
        t = _wait(fc.all_reduce(t, op, group))
    return t


def _all_gather(t: torch.Tensor, dim: int, axes: Sequence[Axis]
                ) -> torch.Tensor:
    """Chunks over ``axes`` (major first) gathered, the minor axis first."""
    for group, _, _ in reversed(axes):
        t = _wait(_gather_fn(t.contiguous(), dim % t.dim(), group))
    return t


def _reduce_scatter(t: torch.Tensor, dim: int, axes: Sequence[Axis]
                    ) -> torch.Tensor:
    """Summed over ``axes`` in f32 and split along ``dim``, major first;
    the result in ``t``'s dtype."""
    out = t.float()
    for group, _, _ in axes:
        out = _wait(_scatter_fn(out.contiguous(), "sum", dim % t.dim(),
                                group))
    return out.to(t.dtype)


def _chunk(t: torch.Tensor, dim: int, axes: Sequence[Axis]) -> torch.Tensor:
    for _, size, coord in axes:
        t = t.chunk(size, dim)[coord]
    return t


def _sum_f32(t: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    return _all_reduce(t.float(), axes).to(t.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.axes), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return _sum_f32(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _sum_f32(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.axes), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, partial):
        ctx.dim, ctx.axes, ctx.partial = dim, axes, partial
        return _all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter(g, ctx.dim, ctx.axes), None, None, None
        return _chunk(g, ctx.dim, ctx.axes), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.dim, ctx.axes = dim, axes
        return _reduce_scatter(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.axes), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.dim, ctx.axes = dim, axes
        return _chunk(x, dim, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.axes), None, None


def _axes_of(mesh, names: Sequence[str]) -> Tuple[Axis, ...]:
    """(group, size, coordinate) of each named mesh dim of size > 1."""
    coord = mesh.get_coordinate()
    dims = list(mesh.mesh_dim_names)
    out = []
    for name in names:
        i = dims.index(name)
        if mesh.size(i) > 1:
            out.append((mesh.get_group(i), mesh.size(i), coord[i]))
    return tuple(out)


def _shard_dim(placements, mesh_dims: Sequence[int], what: str
               ) -> Optional[int]:
    """The tensor dim the given mesh dims shard (one for all), or None."""
    dims = {placements[i].dim for i in mesh_dims
            if isinstance(placements[i], Shard)}
    if len(dims) > 1 or (dims and not all(
            isinstance(placements[i], Shard) for i in mesh_dims)):
        raise ValueError(f"{what}: the data axes shard {placements} on "
                         "different dims or only in part")
    return dims.pop() if dims else None


class Partition:
    """One rank's share of a step over ``mesh`` (None: no mesh).

    ``placements``: each parameter's at-rest placements on the mesh (a
    state laid out by ``runtime.elastic``); a parameter sharded over the
    data axes is gathered by :meth:`param` where it is used.
    ``rows_split``: whether each microbatch's rows are split over the data
    axes (``ShardingRules.batch_pspecs``: they are unless the rows do not
    divide). If not, every data rank runs the whole microbatch: its
    statistics are local and its gradients already global."""

    def __init__(self, mesh=None,
                 placements: Optional[Mapping[str, tuple]] = None,
                 rows_split: bool = True) -> None:
        self.mesh = mesh
        self._tp: Tuple[Axis, ...] = ()
        self._dp: Tuple[Axis, ...] = ()
        self._dp_dims: Tuple[int, ...] = ()
        self._tp_dim: Optional[int] = None
        if mesh is not None:
            names = list(mesh.mesh_dim_names)
            dp = [n for n in names if n in ("pod", "data")]
            self._dp_dims = tuple(names.index(n) for n in dp)
            self._dp = _axes_of(mesh, dp)
            if "model" in names:
                self._tp_dim = names.index("model")
                self._tp = _axes_of(mesh, ["model"])
        self.tp = self._tp[0][1] if self._tp else 1
        self.tp_rank = self._tp[0][2] if self._tp else 0
        self.dp = 1
        for _, size, _ in self._dp:
            self.dp *= size
        self.rows_split = bool(rows_split) and self.dp > 1
        # rows: the ranks the global batch's rows are split over
        self.rows = self.dp if self.rows_split else 1
        self._placements = dict(placements or {})
        self._fsdp: Dict[str, int] = {}
        for name, pl in self._placements.items():
            d = _shard_dim(pl, self._dp_dims, name)
            if d is not None and self.dp > 1:
                self._fsdp[name] = d

    @property
    def trivial(self) -> bool:
        """No axis of more than one rank: every call is an identity."""
        return self.tp == 1 and self.dp == 1

    # -- "model": tensor parallel -------------------------------------------
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (whole on every "model" rank) about to feed this rank's
        columns: the same forward, its gradient summed over "model"."""
        return _Copy.apply(x, self._tp) if self._tp else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over "model" of this rank's partial product ``x`` (f32,
        cast once to ``x``'s dtype; partial attention scores are f32)."""
        return _Reduce.apply(x, self._tp) if self._tp else x

    def gather(self, x: torch.Tensor, dim: int = -1, partial: bool = False
               ) -> torch.Tensor:
        """``x``'s chunks over "model" along ``dim`` gathered whole.
        ``partial``: the whole feeds rank-specific work, so each rank's
        gradient is a part of the whole's (reduce-scattered backward)."""
        if not self._tp:
            return x
        return _Gather.apply(x, dim, self._tp, partial)

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's chunk over "model" of ``x`` (whole on every rank)."""
        return _Split.apply(x, dim, self._tp) if self._tp else x

    def tp_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over "model" (no gradient)."""
        return _all_reduce(x.detach(), self._tp, "max") if self._tp else x

    def tp_argmax(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """``torch.argmax(., dim=-1)`` of the whole of ``x``, whose last
        dim holds this rank's chunk over "model" of ``n`` columns (or all
        of them): each rank's max and its first index, the max over
        "model", and the lowest global index among the ranks that hold
        it, so a tie breaks to the lower index as ``torch.argmax`` and
        ``jnp.argmax`` break it. int64, no gradient."""
        if not self._tp or x.shape[-1] == n:
            return torch.argmax(x, dim=-1)
        x = x.detach()
        w = x.shape[-1]
        i = torch.argmax(x, dim=-1, keepdim=True)
        m = torch.gather(x, -1, i)[..., 0]
        top = _all_reduce(m, self._tp, "max")
        idx = torch.where(m == top, i[..., 0] + self.tp_rank * w, n)
        return _all_reduce(idx, self._tp, "min")

    def tp_share(self, n: int) -> int:
        """This rank's part of a dim of ``n`` that the rules split over
        "model" where it divides (``ShardingRules._col``), else ``n``."""
        return n // self.tp if n % self.tp == 0 else n

    # -- the data axes -------------------------------------------------------
    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks holding other rows (a statistic of the
        global batch); the gradient flows to this rank's part as it is."""
        return _Reduce.apply(x, self._dp) if self.rows_split else x

    def dp_all(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks holding other rows of a tensor each adds
        its rows to, consumed by each rank for its own rows: summed both
        ways."""
        return _ReduceBoth.apply(x, self._dp) if self.rows_split else x

    def dp_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum over the data ranks
        of ``x`` (f32, cast once); the gradient gathered back."""
        if not self.rows_split:
            return x
        return _ReduceScatter.apply(x, dim, self._dp)

    def dp_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data ranks' chunks of ``x`` along ``dim``, in rank order;
        each rank's gradient (of its own rows' use) reduce-scattered
        back."""
        if not self.rows_split:
            return x
        if not x.requires_grad:
            return _all_gather(x, dim, self._dp)
        return _Gather.apply(x, dim, self._dp, True)

    def local_rows(self, batch: int) -> int:
        """This rank's rows of a global batch of ``batch``."""
        if batch % self.rows:
            raise ValueError(f"{batch} rows do not split over {self.rows} "
                             "data ranks (rows_split: the rules leave such a "
                             "batch whole)")
        return batch // self.rows

    @property
    def dp_rank(self) -> int:
        """This rank's index among the ranks the rows are split over."""
        r = 0
        if self.rows_split:
            for _, size, coord in self._dp:
                r = r * size + coord
        return r

    # -- parameters and gradients ---------------------------------------------
    def param(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``name``'s at-rest shard ``t`` as the layers use it:
        gathered over the data axes where it is sharded there at rest
        (``fsdp``), its gradient then reduce-scattered back over the ranks
        whose rows contributed."""
        d = self._fsdp.get(name)
        if d is None:
            return t
        return _Gather.apply(t, d, self._dp, self.rows_split)

    def grad_shard(self, name: str, g: torch.Tensor, acc_placements
                   ) -> torch.Tensor:
        """This rank's shard, in ``acc_placements``, of the global gradient
        of ``name``, from ``g``: the gradient of the at-rest shard from
        this rank's rows. f32 where the data axes sum it; ``g`` itself on
        one data rank."""
        at_rest = self._placements[name]
        if self._tp_dim is not None and \
                acc_placements[self._tp_dim] != at_rest[self._tp_dim]:
            raise ValueError(f"{name}: the accumulator's placement over "
                             f"'model' {acc_placements} is not the "
                             f"parameter's {at_rest}")
        acc_d = _shard_dim(acc_placements, self._dp_dims, name)
        if name in self._fsdp:                  # reduced by param()
            if acc_d != self._fsdp[name]:
                raise ValueError(f"{name}: the accumulator {acc_placements} "
                                 f"does not keep the parameter's data "
                                 f"shard {at_rest}")
            return g
        if self.dp == 1:
            return g
        if acc_d is None:
            return _all_reduce(g.float(), self._dp) if self.rows_split \
                else g
        if self.rows_split:
            return _reduce_scatter(g.float(), acc_d, self._dp)
        return _chunk(g, acc_d, self._dp)


NO_PARTITION = Partition()
