"""Plain PyTorch version of the columnar policy scan.

The semantics authority the CUDA kernels are held to, on any device, in
f32. A program is a postfix instruction list run on a stack of
``max_stack`` (N,) f32 rows that starts at zeros:

* a comparison pushes ``cols[col] <op> operand`` as 0/1 (compared in f32);
* AND / OR / NOT pop their inputs and push ``a*b``, ``clip(a+b, 0, 1)``
  and ``1-a``;
* ``a`` and ``b`` are read at ``max(sp-1, 0)`` and ``max(sp-2, 0)``, the
  write position is clipped to ``[0, max_stack-1]``, NOPs are skipped and
  an empty program gives 0.

The stack pointer depends on the opcodes only, never on the data, so it is
a host integer here. Programs deeper than ``max_stack`` are outside the
contract: this version clamps an out-of-range read (and column index) into
range, as the kernels do.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

N_AGG = 14   # count, volume, spc_used, 10 size-profile buckets, matched_max

# size-profile bucket edges (log-ish, matches core.types.SIZE_PROFILE_EDGES),
# all exact in f32
EDGES = (0.0, 1.0, 32.0, float(1 << 10), float(32 << 10), float(1 << 20),
         float(32 << 20), float(1 << 30), float(32 << 30), float(1 << 40))

# opcodes (shared with core.policy)
OP_EQ, OP_NE, OP_GT, OP_GE, OP_LT, OP_LE, OP_AND, OP_OR, OP_NOT = range(9)
OP_NOP = -1

_CMPS = (torch.eq, torch.ne, torch.gt, torch.ge, torch.lt, torch.le)


def eval_program(cols: torch.Tensor, ops: torch.Tensor, colidx: torch.Tensor,
                 operands: torch.Tensor, max_stack: int = 8) -> torch.Tensor:
    """Evaluate a postfix predicate program.

    cols: (n_cols, N) f32 columnar attributes; ops/colidx/operands: (P,)
    program (OP_NOP padded). Returns (N,) f32 mask in {0, 1}.
    """
    n_cols, n = cols.shape
    zero = torch.zeros(n, dtype=torch.float32, device=cols.device)
    stack: List[torch.Tensor] = [zero] * max_stack
    top = max_stack - 1

    def at(pos: int) -> int:
        return min(max(pos, 0), top)

    sp = 0
    vals = operands.to(torch.float32).tolist()     # f32 values, exactly
    for op, col, val in zip(ops.tolist(), colidx.tolist(), vals):
        if op < 0:
            continue
        a, b = stack[at(sp - 1)], stack[at(sp - 2)]
        if op < 6:
            vec = cols[min(max(col, 0), n_cols - 1)]
            new, pos, sp = _CMPS[op](vec, val).to(torch.float32), sp, sp + 1
        elif op == OP_AND:
            new, pos, sp = a * b, sp - 2, sp - 1
        elif op == OP_OR:
            new, pos, sp = torch.clamp(a + b, 0.0, 1.0), sp - 2, sp - 1
        elif op == OP_NOT:
            new, pos = 1.0 - a, sp - 1
        else:                       # unknown opcode: the reference's else arm
            new, pos, sp = 1.0 - a, sp - 2, sp - 1
        stack[at(pos)] = new
    return stack[at(sp - 1)].clone()


def size_buckets(size: torch.Tensor) -> torch.Tensor:
    """(N,) int64 size-profile bucket: ``clip(sum(size >= edge) - 1, 0, 9)``."""
    bucket = torch.zeros(size.shape, dtype=torch.int64, device=size.device)
    for e in EDGES:
        bucket += size >= e
    return torch.clamp(bucket - 1, 0, 9)


def _aggregate(mask: torch.Tensor, size: torch.Tensor, spc: torch.Tensor,
               bucket: torch.Tensor) -> torch.Tensor:
    parts = [mask.sum(), (mask * size).sum(), (mask * spc).sum()]
    parts += [(mask * (bucket == k)).sum() for k in range(10)]
    # zero-row tables match nothing
    parts.append(mask.max() if mask.numel() else mask.new_zeros(()))
    return torch.stack(parts).to(torch.float32)


def aggregate(mask: torch.Tensor, size: torch.Tensor, spc: torch.Tensor
              ) -> torch.Tensor:
    """Fused aggregates for a match mask: (N_AGG,) f32.

    [count, volume, spc_used, hist0..hist9, any_match].
    """
    return _aggregate(mask, size, spc, size_buckets(size))


def policy_scan_ref(cols: torch.Tensor, ops: torch.Tensor,
                    colidx: torch.Tensor, operands: torch.Tensor,
                    size_col: int = 0, blocks_col: int = 1,
                    valid_col: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask (N,) f32, aggregates (N_AGG,) f32) of one program.

    ``valid_col``: column of 0/1 row validity (-1 = all valid).
    """
    mask = eval_program(cols, ops, colidx, operands)
    if valid_col >= 0:
        mask = mask * cols[valid_col]
    return mask, aggregate(mask, cols[size_col], cols[blocks_col])


def attribute_ref(masks: torch.Tensor) -> torch.Tensor:
    """First-match-wins rule attribution over (R, N) program masks.

    Program 0 is the combined criteria; programs 1..R-1 are the per-rule
    conditions in priority order. Returns (N,) i32: the first rule whose
    mask is set (program r maps to rule r-1), or -1 where none is.
    """
    rule = torch.full((masks.shape[1],), -1, dtype=torch.int32,
                      device=masks.device)
    for r in range(masks.shape[0] - 1, 0, -1):     # lowest r written last
        rule = torch.where(masks[r] > 0.5, r - 1, rule)
    return rule


def aggregate_multi(masks: torch.Tensor, size: torch.Tensor,
                    spc: torch.Tensor) -> torch.Tensor:
    """Per-program fused aggregates: (R, N_AGG) f32, one row per mask."""
    bucket = size_buckets(size)
    return torch.stack([_aggregate(m, size, spc, bucket) for m in masks])


def policy_scan_batch_ref(cols: torch.Tensor, ops: torch.Tensor,
                          colidx: torch.Tensor, operands: torch.Tensor,
                          size_col: int = 0, blocks_col: int = 1,
                          valid_col: int = -1
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(masks (R, N) f32, rule_idx (N,) i32, agg (R, N_AGG) f32): every
    program's mask, first-match-wins attribution over programs 1..R-1, and
    per-program size/blocks reductions."""
    masks = torch.stack([eval_program(cols, o, c, v)
                         for o, c, v in zip(ops, colidx, operands)])
    if valid_col >= 0:
        masks = masks * cols[valid_col][None, :]
    return (masks, attribute_ref(masks),
            aggregate_multi(masks, cols[size_col], cols[blocks_col]))
