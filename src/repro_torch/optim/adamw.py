"""AdamW with a configurable moment dtype (the reference's
``optim/adamw.py``), over a mapping of named tensors.

The arithmetic is the reference's, operation for operation, in f32: a
global-norm gradient clip, bias-corrected moments, decoupled weight decay,
and the new parameter cast back to its own dtype. Two things differ:

* **In place.** ``update`` writes the new parameters, ``m`` and ``v`` into
  the tensors it was given and returns them (the reference returns new
  arrays): at recurrentgemma-9b's widths a second copy of the moments
  alone would take 17 GB of the card. ``count`` is a new tensor.
* **Which parameters decay.** The reference decays a leaf iff its
  ``ndim >= 2``, and its leaves of scanned superblocks carry a leading
  stacking axis, so a 1-D parameter there (a norm weight, a bias, ``lam``)
  decays and the same parameter in a tail layer does not. The port keeps
  one tensor a layer, so the rule comes from the model
  (:meth:`repro_torch.models.Model.decay_names`) as ``decays``: the names
  that decay. Without it, ``ndim >= 2`` of the port's own tensors.

**A state over a mesh.** ``params``, ``m``, ``v`` and the gradients may be
``DTensor`` leaves (``runtime/elastic.py``, ``train/train_step.py``). The
global norm then sums each tensor's local squares and reduces them over
its mesh (``full_tensor``: the only place the ranks' f32 sums meet, so a
mesh changes the norm by its reduction order and nothing else). Each
element is updated where its moments live: the gradient and the
parameter are taken in ``m``'s layout (a local split where ``m`` is
sharded more finely, ZeRO-1), the arithmetic above runs on the local
shards, and the new parameter goes back into ``params``' own layout
(gathered over the axes ``m`` alone shards).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Container, Dict, Mapping, Optional, Tuple, \
    Union

import torch
from torch.distributed.tensor import DTensor

Params = Dict[str, torch.Tensor]
OptState = Dict[str, object]        # {"m": Params, "v": Params, "count"}


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _in_layout(t: DTensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t`` in ``placements`` on ``mesh``."""
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t.to_local()


def _store(p: DTensor, new: torch.Tensor, mesh, placements) -> None:
    """Write ``new`` (a shard in ``placements``) into ``p``'s own layout."""
    if tuple(p.placements) != tuple(placements):
        new = DTensor.from_local(
            new, mesh, tuple(placements), run_check=False, shape=p.shape,
            stride=p.stride()).redistribute(p.device_mesh,
                                            p.placements).to_local()
    p.to_local().copy_(new)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    grad_clip: float = 1.0

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        device = next(iter(params.values())).device
        zeros = {k: torch.zeros(p.shape, dtype=self.moment_dtype,
                                device=p.device) for k, p in params.items()}
        return {"m": zeros,
                "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(count)
        return torch.tensor(self.lr, dtype=torch.float32,
                            device=count.device)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: OptState,
               params: Mapping[str, torch.Tensor],
               decays: Optional[Container[str]] = None
               ) -> Tuple[Params, OptState]:
        """One step over ``params`` (updated in place, with ``state["m"]``
        and ``state["v"]``). ``decays``: the names that take weight decay
        (the model's layout rule); None decays the tensors with
        ``ndim >= 2``. Returns (params, new state)."""
        f32 = torch.float32
        count = _local(state["count"]) + 1
        cf = count.to(f32)
        lr = self._lr(count)
        # global-norm clip (f32 accumulation; a DTensor's over its mesh)
        gsq = None
        for g in grads.values():
            s = torch.sum(torch.square(g.to(f32)))
            if isinstance(s, DTensor):
                s = s.full_tensor()
            gsq = s if gsq is None else gsq + s
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if self.grad_clip else 1.0

        b1 = torch.tensor(self.b1, dtype=f32, device=cf.device)
        b2 = torch.tensor(self.b2, dtype=f32, device=cf.device)
        bc1 = 1.0 - b1 ** cf
        bc2 = 1.0 - b2 ** cf
        wd_lr = lr * self.weight_decay
        for name, p_in in params.items():
            g, m, v = grads[name], state["m"][name], state["v"][name]
            if isinstance(m, DTensor):      # the moments' layout rules
                mesh, pl = m.device_mesh, m.placements
                g, p = _in_layout(g, mesh, pl), _in_layout(p_in, mesh, pl)
                m, v = m.to_local(), v.to_local()
            else:
                p = p_in
            gf = g.to(f32) * scale
            m_new = self.b1 * m.to(f32) + (1 - self.b1) * gf
            v_new = self.b2 * v.to(f32) + (1 - self.b2) * gf * gf
            del gf
            step = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            m.copy_(m_new)
            v.copy_(v_new)
            del m_new, v_new
            decay = (name in decays) if decays is not None else \
                p_in.dim() >= 2
            if self.weight_decay and decay:
                step = step + wd_lr * p.to(f32)
            if p is p_in:
                p.copy_(p.to(f32) - step)
            else:
                _store(p_in, (p.to(f32) - step).to(p.dtype), mesh, pl)
        if isinstance(state["count"], DTensor):
            c = state["count"]
            count = DTensor.from_local(count, c.device_mesh, c.placements,
                                       run_check=False)
        return params, {"m": state["m"], "v": state["v"], "count": count}
