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
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

TrainState = Dict[str, Any]   # {"params", "opt", "step"}


def init_train_state(model, opt, generator: torch.Generator) -> TrainState:
    """Draws the model's parameters from ``generator`` on its device."""
    model.init(generator, generator.device)
    params = model.train_params()
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model.device)}


def make_train_step(model, opt, grad_pspecs=None):
    """grad_pspecs: the reference's PartitionSpec tree for the f32 grad
    accumulator; one card has no mesh, so only None is accepted."""
    if grad_pspecs is not None:
        raise ValueError("grad_pspecs shards over a mesh; the port runs on "
                         "one card (ROADMAP.md queue 1 item 12: "
                         "runtime/sharding.py)")

    def train_step(state: TrainState, batch: Mapping[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = model.bind_params(state["params"])
        device = model.device
        tokens, labels = (torch.as_tensor(batch[k], device=device)
                          for k in ("tokens", "labels"))
        extras = {k: torch.as_tensor(v, device=device)
                  for k, v in (batch.get("extras") or {}).items()}
        accum = tokens.shape[0]
        names = list(params)
        leaves = [params[k] for k in names]
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
                for k, p in params.items()}
        losses, ces, auxes = [], [], []
        for i in range(accum):
            mb = {"tokens": tokens[i], "labels": labels[i]}
            if extras:
                mb["extras"] = {k: v[i] for k, v in extras.items()}
            loss, metrics = model.loss(mb)
            grads = torch.autograd.grad(loss, leaves)
            for k, g in zip(names, grads):
                gsum[k].add_(g)
            del grads
            losses.append(loss.detach())
            ces.append(metrics["ce"].detach())
            auxes.append(metrics["aux"].detach())
        # in place: the accumulator's memory goes as each cast is made
        grads = {k: gsum.pop(k).div_(accum).to(torch.bfloat16)
                 for k in names}
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
