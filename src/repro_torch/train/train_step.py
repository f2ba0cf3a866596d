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

**Over a mesh.** A state laid out by ``runtime.elastic`` holds ``DTensor``
params and moments. The step gathers each parameter whole into the model
(``bind_params``: the reference's ``fsdp`` all-gather, here once a step)
and runs every microbatch on every rank, the model's ops on plain tensors
(so a hand-written kernel never sees a ``DTensor``). The f32 accumulator
is laid out by ``grad_pspecs`` on the state's mesh, the reference's
``with_sharding_constraint``: each rank adds only its shard of each
microbatch's gradient, and the optimizer updates the shards where the
moments live (``optim/adamw.py``). A layout, the same math: on a 1x1 mesh
the step is the unsharded one bit for bit, and on a larger mesh it differs
only by the reduction order of the clip norm.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..runtime.sharding import shard_view, to_placements

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


def make_train_step(model, opt, grad_pspecs: Optional[Mapping] = None):
    """grad_pspecs: a spec (``runtime.sharding.P``) by parameter name for
    the f32 gradient accumulator (``ShardingRules.opt_state_pspecs``), on
    the mesh of the state's ``DTensor`` params; None lays it out as each
    parameter. A state of plain tensors takes None only."""

    def grad_layouts(params) -> Optional[Dict[str, Tuple[Any, tuple]]]:
        mesh = _mesh_of(params)
        if mesh is None:
            if grad_pspecs is not None:
                raise ValueError("grad_pspecs lays the gradients out on the "
                                 "state's mesh: the state holds no DTensor "
                                 "(runtime.elastic.reshard_state)")
            return None
        if grad_pspecs is None:
            return {k: (p.device_mesh, tuple(p.placements))
                    for k, p in params.items()}
        return {k: (mesh, to_placements(grad_pspecs[k], mesh))
                for k in params}

    def train_step(state: TrainState, batch: Mapping[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        layouts = grad_layouts(state["params"])
        params = model.bind_params(state["params"])
        device = model.device
        tokens, labels = (torch.as_tensor(batch[k], device=device)
                          for k in ("tokens", "labels"))
        extras = {k: torch.as_tensor(v, device=device)
                  for k, v in (batch.get("extras") or {}).items()}
        accum = tokens.shape[0]
        names = list(params)
        leaves = [params[k] for k in names]
        def shard(k, t):        # each rank accumulates its shard only
            return t if layouts is None else shard_view(t, *layouts[k])
        gsum = {k: torch.zeros(shard(k, p).shape, dtype=torch.float32,
                               device=device) for k, p in params.items()}
        losses, ces, auxes = [], [], []
        for i in range(accum):
            mb = {"tokens": tokens[i], "labels": labels[i]}
            if extras:
                mb["extras"] = {k: v[i] for k, v in extras.items()}
            loss, metrics = model.loss(mb)
            grads = torch.autograd.grad(loss, leaves)
            for k, g in zip(names, grads):
                gsum[k].add_(shard(k, g))
            del grads
            losses.append(loss.detach())
            ces.append(metrics["ce"].detach())
            auxes.append(metrics["aux"].detach())
        # in place: the accumulator's memory goes as each cast is made
        grads = {k: gsum.pop(k).div_(accum).to(torch.bfloat16)
                 for k in names}
        if layouts is not None:
            grads = {k: DTensor.from_local(g, *layouts[k], run_check=False,
                                           shape=params[k].shape,
                                           stride=params[k].stride())
                     for k, g in grads.items()}
            # the state's own (sharded) parameters take the update
            params = state["params"]
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
