"""Elastic scaling: restore a checkpoint onto a different mesh (the
reference's ``runtime/elastic.py``).

Checkpoints store *logical* (whole) tensors (``runtime/checkpoint.py``),
so changing the rank count between runs is a restore-time resharding:
build the new mesh, derive specs from the same ShardingRules, and lay
each leaf out on it as a ``DTensor``. Scale-down after a node loss and
scale-up both reduce to this.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from .sharding import P, ShardingRules, lay_out, tree_map

PyTree = Any


def state_shardings(cfg, mesh, state_specs: PyTree,
                    profile: Optional[str] = None) -> PyTree:
    """NamedSharding tree for a train state (``{"params", "opt": {"m",
    "v", "count"}, "step"}``; anything with ``.shape`` as leaves) on an
    arbitrary mesh."""
    rules = ShardingRules(cfg, mesh, profile or "tp")
    params = state_specs["params"]
    pspecs = {
        "params": rules.param_pspecs(params),
        "opt": {"m": rules.opt_state_pspecs(params),
                "v": rules.opt_state_pspecs(params),
                "count": P()},
        "step": P(),
    }
    return rules.to_shardings(pspecs)


def reshard_state(state: PyTree, shardings: PyTree) -> PyTree:
    """Reshard a (restored) logical state onto new shardings: each leaf
    (its whole tensor first, if it is already a ``DTensor``) laid out as a
    ``DTensor`` on the sharding's mesh, on the mesh's device type; a None
    sharding leaves its leaf as it is (``jax.device_put`` to None)."""

    def one(x, s):
        if s is None:
            return x
        if isinstance(x, DTensor):
            x = x.full_tensor()
        x = torch.as_tensor(x).to(s.mesh.device_type)
        return lay_out(x, s.mesh, s.placements)
    return tree_map(one, state, shardings)
