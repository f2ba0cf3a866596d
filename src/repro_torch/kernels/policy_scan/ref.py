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

from typing import List, Optional, Tuple

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


def policy_scan_multi_ref(cols: torch.Tensor, ops: torch.Tensor,
                          colidx: torch.Tensor, operands: torch.Tensor,
                          size_col: int = 0, blocks_col: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate R padded programs in one columnar pass.

    ops/colidx/operands: (R, P) with OP_NOP padding. Returns
    (masks (R, N) f32, agg (N_AGG,) f32 for program 0) — program 0 is, by
    convention, the policy's combined scope∧rules∧extra criteria; the
    remaining rows are per-rule masks used for vectorized attribution.
    """
    masks = torch.stack([eval_program(cols, o, c, v)
                         for o, c, v in zip(ops, colidx, operands)])
    return masks, aggregate(masks[0], cols[size_col], cols[blocks_col])


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


def combine_groups(parts: List[torch.Tensor]) -> torch.Tensor:
    """(R, N_AGG) f32 aggregates of every shard group from theirs, in group
    order: the additive slots summed in f32 and ``any_match`` their
    maximum, as the reference's psum / pmax across the mesh."""
    out = parts[0].clone()
    for p in parts[1:]:
        out[:, : N_AGG - 1] += p[:, : N_AGG - 1]
        out[:, N_AGG - 1] = torch.maximum(out[:, N_AGG - 1], p[:, N_AGG - 1])
    return out


def subject_bits(perm: torch.Tensor, sid) -> torch.Tensor:
    """One subject's row visibility from a packed permissions plane.

    ``perm`` is (..., Sp, W): one packed bitset a subject, W 32-bit words
    (held as int32, read as u32), bit ``b`` of word ``w`` (LSB first)
    covering row ``w * 32 + b``, as ``np.packbits(..., bitorder="little")``
    packs them. Returns the (..., W * 32) bool rows of subject ``sid``.
    The words are widened to int64 and masked to their 32 bits before the
    shifts, so no u32 arithmetic is needed (the CPU build of PyTorch has
    none for shifts and ``arange``)."""
    words = perm.select(-2, int(sid)).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=perm.device)
    return ((words.unsqueeze(-1) >> shifts) & 1).bool().flatten(-2)


def policy_scan_store_ref(cols: torch.Tensor, ops: torch.Tensor,
                          colidx: torch.Tensor, operands: torch.Tensor, *,
                          size_col: int, blocks_col: int, valid_col: int,
                          with_agg: bool,
                          perm: Optional[torch.Tensor] = None, sid=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The store form's plain version: :func:`policy_scan_batch_ref` on
    each shard group of ``cols`` (D, C, Rp), one group at a time.

    Returns (mask0 (D, Rp): program 0's f32 mask with ``with_agg``, else
    ``mask0 > 0.5`` as bool; rule (D, Rp) i32; agg (R, N_AGG) f32 over
    every group (:func:`combine_groups`), zeros without ``with_agg``).

    ``perm`` (D, Sp, Rp / 32) and ``sid`` scope it to one subject (see
    :func:`subject_bits`): each group runs on a copy of its columns whose
    validity is 0 where the subject's bit is 0."""
    mask0, rule, parts = [], [], []
    for g, c in enumerate(cols):
        if perm is not None:
            c = c.clone()
            c[valid_col] = torch.where(subject_bits(perm[g], sid),
                                       c[valid_col], c.new_zeros(()))
        masks, r, agg = policy_scan_batch_ref(
            c, ops, colidx, operands, size_col=size_col,
            blocks_col=blocks_col, valid_col=valid_col)
        mask0.append(masks[0] if with_agg else masks[0] > 0.5)
        rule.append(r)
        parts.append(agg)
    agg = combine_groups(parts) if with_agg else torch.zeros(
        (ops.shape[0], N_AGG), dtype=torch.float32, device=cols.device)
    return torch.stack(mask0), torch.stack(rule), agg
