"""Training step: microbatched gradient accumulation + AdamW update (the
reference's ``train/train_step.py``).

The batch carries a leading ``accum`` dimension (on every leaf, the
``extras`` too); microbatches run one after the other, so activation
memory is that of one microbatch (each model superblock is additionally
rematerialized, see ``models/transformer.py``). Each microbatch's
gradients come out in the parameters' dtype (bf16 for bf16 weights, as
``jax.value_and_grad`` gives them) and are summed into f32 accumulators;
the sum over ``accum`` is cast to bf16 before the optimizer, as in the
reference.

The train state is ``{"params", "opt", "step"}``. Its ``params`` are the
model's own parameters (:meth:`~repro_torch.models.Model.train_params`),
which the step updates in place, with the moments; a state whose params
are other tensors (a restored checkpoint) is copied into the model first
(:meth:`~repro_torch.models.Model.bind_params`).

**Over a mesh** (the reference's ``jax.jit(step, in_shardings=...)``,
partitioned by GSPMD). A state laid out by ``runtime.elastic`` holds
``DTensor`` params and moments. The step partitions its compute the way
``runtime.sharding.ShardingRules`` place them (``runtime/partition.py``):

* each rank takes its rows of each microbatch (``batch_pspecs``: the
  batch over the data axes; ``frames``/``img`` also split on d_model
  over "model" and gathered by the model). A batch leaf may be a
  ``DTensor`` already laid out so (each rank drew only its rows) or a
  whole tensor every rank holds (the step takes its rows);
* the model runs on each rank's parameter shards as plain tensors
  (``Model.loss(params=, part=)``): products over "model" as the rules
  place each weight, parameters sharded over the data axes at rest
  (``fsdp``) gathered a remat region at a time; so a hand-written kernel
  only ever sees plain local tensors;
* the loss is the global batch's on every rank (the CE's sums and the
  MoE statistics all-reduced over the data axes), and each microbatch's
  gradient reaches the f32 accumulator's shard (laid out by
  ``grad_pspecs``, the reference's ``with_sharding_constraint``) by a
  reduce-scatter or an all-reduce over the data axes, in f32;
* the optimizer updates the shards where the moments live
  (``optim/adamw.py``).

On a 1x1 mesh every collective is skipped and the step is the unsharded
one bit for bit. On a larger mesh the sums over rows and over "model"
run in another order than one rank's (the CE and the aux statistics,
the row-parallel products' partial sums, each rank's bf16 gradient of
its rows before the f32 sum, the clip norm): the losses and parameters
agree to those roundings. The partitioned step reads the model's own
parameters for their names and shapes only: a caller may release them
(``Model.release_params``), and they are not updated over a mesh (the
state's shards are).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..runtime.partition import Partition
from ..runtime.sharding import local_batch, shard_view, to_placements

TrainState = Dict[str, Any]   # {"params", "opt", "step"}


def init_train_state(model, opt, generator: torch.Generator) -> TrainState:
    """Draws the model's parameters from ``generator`` on its device."""
    model.init(generator, generator.device)
    params = model.train_params()
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model.device)}


def _mesh_of(params: Mapping[str, Any]):
    for p in params.values():
        if isinstance(p, DTensor):
            return p.device_mesh
    return None


def _microbatches(model, batch: Mapping[str, Any],
                  params: Mapping[str, torch.Tensor],
                  part: Optional[Partition],
                  reduce: Callable[[str, torch.Tensor], torch.Tensor],
                  acc_shapes: Mapping[str, torch.Size]
                  ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor],
                             List[torch.Tensor], List[torch.Tensor]]:
    """Sums each microbatch's gradients, through ``reduce``, into f32
    accumulators (this rank's shards, plain tensors); returns them and the
    losses, CEs and auxes. ``part`` None: the model's own parameters
    (``params``), unpartitioned."""
    names = list(params)
    leaves = [params[k] for k in names]
    gsum = {k: torch.zeros(acc_shapes[k], dtype=torch.float32,
                           device=model.device) for k in names}
    losses, ces, auxes = [], [], []
    for i in range(batch["tokens"].shape[0]):
        mb = {"tokens": batch["tokens"][i], "labels": batch["labels"][i]}
        if batch.get("extras"):
            mb["extras"] = {k: v[i] for k, v in batch["extras"].items()}
        loss, metrics = model.loss(mb) if part is None else \
            model.loss(mb, params=params, part=part)
        grads = torch.autograd.grad(loss, leaves)
        for k, g in zip(names, grads):
            gsum[k].add_(reduce(k, g))
        del grads
        losses.append(loss.detach())
        ces.append(metrics["ce"].detach())
        auxes.append(metrics["aux"].detach())
    return gsum, losses, ces, auxes


def make_train_step(model, opt, grad_pspecs: Optional[Mapping] = None):
    """grad_pspecs: a spec (``runtime.sharding.P``) by parameter name for
    the f32 gradient accumulator (``ShardingRules.opt_state_pspecs``), on
    the mesh of the state's ``DTensor`` params; None lays it out as each
    parameter. A state of plain tensors takes None only."""

    def unsharded(state, batch):
        if grad_pspecs is not None:
            raise ValueError("grad_pspecs lays the gradients out on the "
                             "state's mesh: the state holds no DTensor "
                             "(runtime.elastic.reshard_state)")
        params = model.bind_params(state["params"])
        device = model.device
        batch = {k: torch.as_tensor(batch[k], device=device)
                 for k in ("tokens", "labels")} | (
            {"extras": {k: torch.as_tensor(v, device=device)
                        for k, v in batch["extras"].items()}}
            if batch.get("extras") else {})
        gsum, *mets = _microbatches(model, batch, params, None,
                                    lambda k, g: g,
                                    {k: p.shape for k, p in params.items()})
        return params, gsum, mets, None

    def partitioned(state, batch, mesh):
        dparams = state["params"]
        layouts = {k: to_placements(grad_pspecs[k], mesh)
                   if grad_pspecs is not None else tuple(p.placements)
                   for k, p in dparams.items()}
        local, rows_split = local_batch(model.cfg, mesh, batch,
                                        model.device)
        part = Partition(mesh, {k: tuple(p.placements)
                                for k, p in dparams.items()}, rows_split)
        # this rank's shards, as the leaves the gradients are taken of
        params = {k: p.to_local().detach().requires_grad_(True)
                  for k, p in dparams.items()}
        shapes = {k: shard_view(torch.empty(p.shape, device="meta"), mesh,
                                layouts[k]).shape
                  for k, p in dparams.items()}
        gsum, *mets = _microbatches(
            model, local, params, part,
            lambda k, g: part.grad_shard(k, g, layouts[k]), shapes)
        return dparams, gsum, mets, (mesh, layouts)

    def train_step(state: TrainState, batch: Mapping[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        mesh = _mesh_of(state["params"])
        if mesh is None:
            params, gsum, mets, laid = unsharded(state, batch)
        else:
            params, gsum, mets, laid = partitioned(state, batch, mesh)
        losses, ces, auxes = mets
        accum = len(losses)
        # in place: the accumulator's memory goes as each cast is made
        grads = {k: gsum.pop(k).div_(accum).to(torch.bfloat16)
                 for k in list(params)}
        if laid is not None:
            mesh, layouts = laid
            grads = {k: DTensor.from_local(g, mesh, layouts[k],
                                           run_check=False,
                                           shape=params[k].shape,
                                           stride=params[k].stride())
                     for k, g in grads.items()}
        new_params, new_opt = opt.update(grads, state["opt"], params,
                                         decays=model.decay_names())
        del grads
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": torch.stack(losses).mean(),
                   "ce": torch.stack(ces).mean(),
                   "aux": torch.stack(auxes).mean()}
        return new_state, metrics

    return train_step
