"""The benchmark's weights, drawn on the device from the run's seed.

A group (see ``models/``) is drawn in one call a dtype: one flat tensor
of standard normals from a ``torch.Generator`` on the device, seeded from
(seed, group), then each leaf's view is scaled, shifted or mapped to a
uniform in place. The same (seed, group, device) gives the same values,
so the reference draws a layer again when it needs it and never reads a
tensor the program holds.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List

import torch

from .models.layout import Leaf

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def subseed(seed: int, *key) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed (any
    whole number) and ``key``."""
    h = hashlib.sha256(repr((int(seed),) + key).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@torch.no_grad()
def draw_group(leaves: List[Leaf], seed: int, group: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Group ``group``'s leaves, each in the dtype it is served in:
    benchmark name -> tensor (views of one flat tensor a dtype)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights", group))
    out: Dict[str, torch.Tensor] = {}
    for dname, dtype in DTYPES.items():
        mine = [leaf for leaf in leaves if leaf.dtype == dname]
        if not mine:
            continue
        flat = torch.empty(sum(leaf.numel for leaf in mine), dtype=dtype,
                           device=device)
        flat.normal_(generator=gen)
        at = 0
        for leaf in mine:
            t = flat[at:at + leaf.numel].view(leaf.shape)
            at += leaf.numel
            kind, a, b = leaf.init
            if kind == "normal":
                t.mul_(b).add_(a)
            elif kind == "uniform":
                t.copy_(torch.special.ndtr(t.float()) * (b - a) + a)
            else:
                raise ValueError(f"{leaf.name}: unknown init {kind!r}")
            out[leaf.name] = t
    return out


def bind(model, groups: List[List[Leaf]], seed: int) -> None:
    """Draws every group on the model's device and binds it into the
    model through ``Model.bind_params``, a group at a time: the other
    names map to the model's own tensors, which it does not copy, so no
    more than one group is held twice."""
    for g, leaves in enumerate(groups):
        own = dict(model.named_parameters())
        drawn = draw_group(leaves, seed, g, model.device)
        model.bind_params({**own, **{leaf.port: drawn[leaf.name]
                                     for leaf in leaves}})
        del drawn
    for p in model.parameters():
        p.requires_grad_(False)


def reference_weights(groups: List[List[Leaf]], seed: int,
                      device: torch.device
                      ) -> Callable[[int], Dict[str, torch.Tensor]]:
    """``group -> {benchmark name: float32 tensor}``, each group drawn
    again from the seed when asked for."""
    def get(group: int) -> Dict[str, torch.Tensor]:
        return {k: v.float() for k, v in
                draw_group(groups[group], seed, group, device).items()}
    return get
