"""Public policy-scan ops: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors, and nothing else.

``use_kernel=None`` picks by the device of ``cols``. ``use_kernel=True`` on
a CPU tensor raises (there is no kernel to run there) and so does
``use_kernel=False`` on a CUDA tensor: the plain version serves CPU tensors
only here (call ``ref.*`` directly to run it on the card). The kernel masks
its own ragged edge, so no row padding happens on either path, and
``valid_col=-1`` reads as a validity row of ones in the kernel and in the
plain version alike, so no row is appended either.

On the card a table has at most 96 columns (the kernel raises
beyond), and the aggregates count a row when its mask is not 0: they equal
the plain version's sums of the mask when the validity column holds only 0
and 1, as a catalog's does (volume and spc_used are weighted by the mask
either way).

:func:`mesh_policy_scan_batch` is the device column store's matcher over
its ``(D, C+1, Rp)`` shard groups: the kernel's store form on the card (one
launch over every group), and on the CPU the static-program evaluator
(:func:`_unrolled_masks`) one group at a time, as the reference runs it off
the TPU. :func:`policy_scan_multi` and :func:`policy_scan_batch_unrolled`
have no kernel in the reference either: they are plain PyTorch on any
device, and the card's main path never calls them. Nor have the store's
report ops, :func:`mesh_column_topk`, :func:`mesh_threshold_rows` and
:func:`mesh_range_aggregate`: plain PyTorch on the store's device.

Each store op takes ``perm``/``subject`` to scope it to one tenant: the
store's permissions plane, ``(D, Sp, Rp / 32)`` packed words held as
int32, and a subject id (see :func:`_subject_bits`). A row the subject may
not see drops out as if it were invalid. :func:`mesh_policy_scan_batch`
does that inside the kernel's scoped store form on the card (one launch,
no second pass over the masks); the report ops AND the bits into their
selection.
"""
from __future__ import annotations

import functools

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .._launches import kernel_for
from .kernel import (policy_scan_batch_cuda, policy_scan_cuda,
                     policy_scan_store_cuda)
from .ref import (N_AGG, OP_AND, OP_NOP, OP_NOT, OP_OR, aggregate_multi,
                  attribute_ref, combine_groups, policy_scan_batch_ref,
                  policy_scan_multi_ref, policy_scan_ref)
# one subject's (..., W * 32) bool rows of a packed (..., Sp, W) plane
from .ref import subject_bits as _subject_bits


def _prepare(cols, ops, colidx, operands, size_col, blocks_col, valid_col):
    """(args, kwargs) for a kernel or plain call: f32 contiguous columns,
    i32/f32 program arrays on the columns' device."""
    dev = cols.device
    args = (cols.to(torch.float32).contiguous(),
            *(t.to(device=dev, dtype=dt).contiguous() for t, dt in (
                (ops, torch.int32), (colidx, torch.int32),
                (operands, torch.float32))))
    return args, dict(size_col=size_col, blocks_col=blocks_col,
                      valid_col=valid_col)


def policy_scan(cols: torch.Tensor, ops: torch.Tensor, colidx: torch.Tensor,
                operands: torch.Tensor, size_col: int = 0,
                blocks_col: int = 1, valid_col: int = -1,
                use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a predicate program over a columnar table + aggregates.

    cols: (n_cols, N) f32. Returns (mask (N,) f32, agg (N_AGG,) f32). Every
    row is valid when ``valid_col`` < 0.
    """
    kernel = kernel_for(cols.device, use_kernel, "policy_scan", "ref.*")
    n = cols.shape[1]
    dev = cols.device
    if n == 0:            # zero-row table: nothing to scan
        return (torch.zeros((0,), dtype=torch.float32, device=dev),
                torch.zeros((N_AGG,), dtype=torch.float32, device=dev))
    args, kw = _prepare(cols, ops, colidx, operands, size_col, blocks_col,
                        valid_col)
    if kernel:
        return policy_scan_cuda(*args, **kw)
    return policy_scan_ref(*args, **kw)


def policy_scan_batch(cols: torch.Tensor, ops: torch.Tensor,
                      colidx: torch.Tensor, operands: torch.Tensor,
                      size_col: int = 0, blocks_col: int = 1,
                      valid_col: int = -1,
                      use_kernel: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-launch batch matcher over a columnar table.

    cols: (n_cols, N) f32; ops/colidx/operands: (R, P) OP_NOP-padded
    programs (program 0 = combined criteria, 1..R-1 = per-rule conditions).
    Returns (masks (R, N) f32, rule_idx (N,) i32, agg (R, N_AGG) f32): all
    program masks, fused first-match-wins attribution, and per-program
    size/blocks reductions — one kernel launch instead of R.
    """
    kernel = kernel_for(cols.device, use_kernel, "policy_scan", "ref.*")
    n = cols.shape[1]
    dev = cols.device
    if n == 0:            # zero-row table: nothing to scan
        r = ops.shape[0]
        return (torch.zeros((r, 0), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((r, N_AGG), dtype=torch.float32, device=dev))
    args, kw = _prepare(cols, ops, colidx, operands, size_col, blocks_col,
                        valid_col)
    if kernel:
        return policy_scan_batch_cuda(*args, **kw)
    return policy_scan_batch_ref(*args, **kw)


def policy_scan_multi(cols: torch.Tensor, ops: torch.Tensor,
                      colidx: torch.Tensor, operands: torch.Tensor,
                      size_col: int = 0, blocks_col: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate R padded predicate programs over one column stack.

    cols: (n_cols, N) f32; ops/colidx/operands: (R, P), OP_NOP padded.
    Returns (masks (R, N) f32, agg (N_AGG,) f32 for program 0). One
    columnar pass: matching and size/blocks aggregation fuse in one scan.
    """
    dev = cols.device
    return policy_scan_multi_ref(
        cols.to(torch.float32), ops.to(dev, torch.int32),
        colidx.to(dev, torch.int32), operands.to(dev, torch.float32),
        size_col=size_col, blocks_col=blocks_col)


_CMP_FNS = (torch.eq, torch.ne, torch.gt, torch.ge, torch.lt, torch.le)


def _eval_unrolled(cols: torch.Tensor, ops: Tuple[int, ...],
                   colidx: Tuple[int, ...], operands: torch.Tensor
                   ) -> torch.Tensor:
    """Postfix program evaluation with the *program* static.

    A policy's opcode/column sequence is fixed per definition (only the
    *operands* move with ``now``), so this path unrolls the program in
    Python: each instruction runs exactly the one comparison it needs, the
    stack is a Python list, and booleans (1 byte) replace f32 masks until
    the end. Bit-identical to :func:`ref.eval_program` on {0, 1} masks —
    differential-tested.
    """
    vals = operands.to(torch.float32).tolist()     # f32 values, exactly
    stack: List[torch.Tensor] = []
    for i, op in enumerate(ops):
        if op == OP_NOP:
            continue
        if op < 6:
            stack.append(_CMP_FNS[op](cols[colidx[i]], vals[i]))
        elif op == OP_AND:
            b, a = stack.pop(), stack.pop()
            stack.append(a & b)
        elif op == OP_OR:
            b, a = stack.pop(), stack.pop()
            stack.append(a | b)
        elif op == OP_NOT:
            stack.append(~stack.pop())
    if not stack:
        return torch.zeros(cols.shape[1], dtype=torch.bool,
                           device=cols.device)
    return stack[-1]


def _unrolled_masks(cols: torch.Tensor, ops_t, colidx_t,
                    operands: torch.Tensor, valid_col: int
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Shared core of the unrolled paths: (bool program masks,
    first-match-wins rule_idx). Single semantics authority for the
    single-device oracle and the lean store branch — fix either behaviour
    here, never in a caller."""
    masks_b = []
    for r in range(len(ops_t)):
        m = _eval_unrolled(cols, ops_t[r], colidx_t[r], operands[r])
        if valid_col >= 0:
            m = m & (cols[valid_col] > 0.5)
        masks_b.append(m)
    if len(masks_b) > 1:
        rule = attribute_ref(torch.stack(masks_b).to(torch.float32))
    else:
        rule = torch.full((cols.shape[1],), -1, dtype=torch.int32,
                          device=cols.device)
    return masks_b, rule


def policy_scan_batch_unrolled(cols: torch.Tensor, operands: torch.Tensor,
                               *, ops_t: Tuple[Tuple[int, ...], ...],
                               colidx_t: Tuple[Tuple[int, ...], ...],
                               size_col: int = 0, blocks_col: int = 1,
                               valid_col: int = -1
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Static-program batch matcher.

    Same contract as :func:`policy_scan_batch` — (masks (R, N) f32,
    rule_idx (N,) i32, agg (R, N_AGG) f32) — but the (R, P) opcode/column
    arrays are hashable tuples (operand values, which carry ``now``-
    relative thresholds, stay data). Any N works.
    """
    masks_b, rule = _unrolled_masks(cols, ops_t, colidx_t, operands,
                                    valid_col)
    masks = torch.stack(masks_b).to(torch.float32)
    agg = aggregate_multi(masks, cols[size_col], cols[blocks_col])
    return masks, rule, agg


def _program_tuples(ops: np.ndarray, colidx: np.ndarray
                    ) -> Tuple[Tuple[Tuple[int, ...], ...],
                               Tuple[Tuple[int, ...], ...]]:
    return (tuple(tuple(int(o) for o in row) for row in np.asarray(ops)),
            tuple(tuple(int(c) for c in row) for row in np.asarray(colidx)))


def _check_plane(global_cols: torch.Tensor, perm: torch.Tensor,
                 subject) -> None:
    """Raises unless ``perm`` is a (D, Sp, Rp / 32) plane over the D
    groups of Rp rows of ``global_cols`` and ``subject`` one of its Sp."""
    d, _, rp = global_cols.shape
    if perm.dim() != 3 or perm.shape[0] != d or perm.shape[2] * 32 != rp:
        raise ValueError(f"perm {tuple(perm.shape)} does not cover {d} "
                         f"groups of {rp} rows: (D, Sp, {rp // 32}) expected")
    if not 0 <= int(subject) < perm.shape[1]:
        raise ValueError(f"subject={int(subject)} outside "
                         f"[0, {perm.shape[1]})")


def _scope(global_cols: torch.Tensor, perm, subject
           ) -> Optional[torch.Tensor]:
    """(D, Rp) bool visibility of subject ``subject`` in the (D, Sp,
    Rp / 32) plane ``perm``, or None for an unscoped call."""
    if (perm is None) != (subject is None):
        raise ValueError("perm and subject go together: both scope a call")
    if perm is None:
        return None
    _check_plane(global_cols, perm, subject)
    return _subject_bits(perm, subject)


@functools.lru_cache(maxsize=64)
def _program_tensors(ops_t: Tuple[Tuple[int, ...], ...],
                     colidx_t: Tuple[Tuple[int, ...], ...],
                     dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (R, P) i32 program arrays on ``dev``, uploaded once per program
    set: an upload from pageable memory waits for the stream, which would
    hold each launch of a streamed window behind that window's copy."""
    return (torch.tensor(ops_t, dtype=torch.int32).to(dev),
            torch.tensor(colidx_t, dtype=torch.int32).to(dev))


def mesh_policy_scan_batch(global_cols: torch.Tensor,
                           operands: torch.Tensor, *,
                           ops_t: Tuple[Tuple[int, ...], ...],
                           colidx_t: Tuple[Tuple[int, ...], ...],
                           size_col: int = 0, blocks_col: int = 1,
                           valid_col: int = -1, with_agg: bool = True,
                           use_kernel: Optional[bool] = None,
                           perm=None, subject=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Batch matcher over the device column store's resident table.

    ``global_cols`` is (D, n_cols, Rp) f32: one shard group's padded column
    stack a group (see ``core.device_store``), ``valid_col`` its 0/1
    row-validity column. The (R, P) opcode/column program structure rides
    as static tuples; only the operand values are data. Returns (mask0
    (D, Rp) and rule_idx (D, Rp) i32; agg (R, N_AGG) f32 over every group,
    the additive slots summed and ``any_match`` their maximum): only the
    combined-criteria mask and the attribution leave the device.

    On a CUDA tensor one launch of the kernel's store form walks every
    group (mask0 f32); on a CPU tensor the unrolled static-program
    evaluator runs one group at a time (mask0 f32 with ``with_agg``).
    ``with_agg=False`` skips the fused size-profile aggregation (mask0 is
    bool and agg zeros) — the policy engine's match path, which only
    consumes mask + attribution. ``use_kernel`` as :func:`policy_scan`.

    ``perm``/``subject`` scope the whole match to one tenant: ``perm`` is
    the store's (D, Sp, Rp / 32) int32 permissions plane and ``subject`` a
    subject id. Masks, rule_idx and the aggregates all come back
    visibility-filtered, exactly as if invisible rows were invalid. On a
    CUDA tensor that is one launch of the kernel's scoped store form; on a
    CPU tensor the unrolled evaluator's masks are ANDed with the subject's
    bits, the rule set to -1 where a bit is 0, and the aggregates taken
    after, as the reference does off the TPU.
    """
    kernel = kernel_for(global_cols.device, use_kernel, "policy_scan",
                        "ref.*")
    dev = global_cols.device
    if kernel:
        ops, colidx = _program_tensors(ops_t, colidx_t, dev)
        return policy_scan_store_cuda(
            global_cols, ops, colidx,
            operands.to(device=dev, dtype=torch.float32).contiguous(),
            size_col=size_col, blocks_col=blocks_col, valid_col=valid_col,
            with_agg=with_agg, perm=perm,
            sid=None if subject is None else int(subject))
    bits = _scope(global_cols, perm, subject)
    operands = operands.to(device=dev, dtype=torch.float32)
    mask0, rule, parts = [], [], []
    for g, c in enumerate(global_cols):
        masks_b, r = _unrolled_masks(c, ops_t, colidx_t, operands,
                                     valid_col)
        if bits is not None:
            masks_b = [m & bits[g] for m in masks_b]
            r = torch.where(bits[g], r, torch.full_like(r, -1))
        if with_agg:
            masks = torch.stack(masks_b).to(torch.float32)
            parts.append(aggregate_multi(masks, c[size_col], c[blocks_col]))
            mask0.append(masks[0])
        else:
            mask0.append(masks_b[0])
        rule.append(r)
    agg = combine_groups(parts) if with_agg else torch.zeros(
        (len(ops_t), N_AGG), dtype=torch.float32, device=dev)
    return torch.stack(mask0), torch.stack(rule), agg


# -- the store's report ops (rbh-find / top-N / du over the store) -----------
#
# Plain PyTorch over the same resident (D, n_cols, Rp) tensor as
# mesh_policy_scan_batch, on its device (the reference runs them as plain
# jnp too): only per-group top-k candidates, the rows of a threshold mask,
# or four aggregates leave the device.

def _file_rows(global_cols: torch.Tensor, valid_col: int, type_col: int,
               file_code: float) -> torch.Tensor:
    """(D, Rp) bool: valid rows, of type ``file_code`` when ``type_col`` is
    given."""
    sel = global_cols[:, valid_col] > 0.5
    if type_col >= 0:
        sel &= global_cols[:, type_col] == file_code
    return sel


def mesh_column_topk(global_cols: torch.Tensor, *, col: int, k: int,
                     desc: bool = True, valid_col: int = -1,
                     type_col: int = -1, file_code: float = 0.0,
                     perm=None, subject=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group top-k over one column, restricted to valid FILE rows.

    Returns ``(vals (D, k) f32, idx (D, k) i64)``: each group's k best
    (largest when ``desc``) values of column ``col`` and their local rows.
    Rows failing the valid/type filter carry a -inf (+inf ascending)
    sentinel; callers drop non-finite candidates. The global top-k is a
    subset of the union of the groups' top-k, so the merged k-th best value
    is an exact threshold for :func:`mesh_threshold_rows`, which recovers
    the ties a per-group cut could hide (``torch.topk`` leaves the order of
    ties unspecified; the caller orders the recovered rows itself).
    ``perm``/``subject`` AND the subject's visibility bits into the row
    filter: the scoped top-k ranks only rows the tenant may see.
    """
    sel = _file_rows(global_cols, valid_col, type_col, file_code)
    bits = _scope(global_cols, perm, subject)
    if bits is not None:
        sel &= bits
    key = global_cols[:, col].masked_fill(
        ~sel, -math.inf if desc else math.inf)
    return torch.topk(key, k, dim=1, largest=desc, sorted=True)


def mesh_threshold_rows(global_cols: torch.Tensor, thr: float, *, col: int,
                        ge: bool = True, valid_col: int = -1,
                        type_col: int = -1, file_code: float = 0.0,
                        perm=None, subject=None) -> torch.Tensor:
    """(D, Rp) bool mask of the valid FILE rows whose column ``col`` passes
    ``thr`` (``>=`` with ``ge``, else ``<=``; ``thr`` is compared as f32):
    the second pass of the two-pass top-k (see :func:`mesh_column_topk`).
    ``perm``/``subject`` apply the same visibility AND as the top-k pass,
    so both passes of a scoped query select from the same rows."""
    sel = _file_rows(global_cols, valid_col, type_col, file_code)
    bits = _scope(global_cols, perm, subject)
    if bits is not None:
        sel &= bits
    c = global_cols[:, col]
    t = torch.full((), thr, dtype=c.dtype, device=c.device)   # no upload
    return sel & ((c >= t) if ge else (c <= t))


def mesh_range_aggregate(global_cols: torch.Tensor, bounds, *, ord_col: int,
                         type_col: int, size_col: int, blocks_col: int,
                         valid_col: int, file_code: float = 0.0,
                         perm=None, subject=None) -> torch.Tensor:
    """Subtree aggregate over sorted-path rank ranges, summed over groups.

    ``bounds`` is (D, 4): per group the half-open rank ranges
    ``[lo, hi) | [lo2, hi2)`` (host binary searches into that group's
    sorted path mirror; ``ord_col`` holds each row's rank in that order).
    Returns the (4,) f64 ``[count, files, volume, spc_used]`` on the
    columns' device: ``count`` and ``files`` are counted as integers (an
    f32 sum of 2^27 ones is not exact), volume and spc_used summed in f64 —
    equal to the reference's f32 sums wherever those are exact.
    ``perm``/``subject`` AND the subject's visibility bits into the range
    mask: a scoped ``du`` counts only rows the tenant may see.
    """
    dev = global_cols.device
    b = torch.as_tensor(np.asarray(bounds, np.float32)).to(dev)
    lo, hi, lo2, hi2 = (b[:, i, None] for i in range(4))
    o = global_cols[:, ord_col]
    m = (global_cols[:, valid_col] > 0.5) & (((o >= lo) & (o < hi))
                                             | ((o >= lo2) & (o < hi2)))
    bits = _scope(global_cols, perm, subject)
    if bits is not None:
        m &= bits
    f = m & (global_cols[:, type_col] == file_code)
    zero = global_cols.new_zeros(())
    return torch.stack([
        m.sum().to(torch.float64), f.sum().to(torch.float64),
        torch.where(f, global_cols[:, size_col], zero).sum(
            dtype=torch.float64),
        torch.where(f, global_cols[:, blocks_col], zero).sum(
            dtype=torch.float64)])


def column_stack(arrays, device=None) -> torch.Tensor:
    """Stack a Catalog.arrays() dict into the (n_cols, N) f32 kernel layout
    on ``device`` (one host->device copy)."""
    from ...core.policy import KERNEL_COLUMNS
    host = np.stack([np.asarray(arrays[c], np.float32)
                     for c in KERNEL_COLUMNS], axis=0)
    return torch.from_numpy(host).to(resolve_device(device))


def _attribute_np(masks: List[np.ndarray]) -> np.ndarray:
    """Host-side first-match-wins attribution (per-rule-launch fallback):
    ``masks[0]`` is the combined criteria (excluded), ``masks[1:]`` the
    rules. Delegates to the single semantics authority in core.policy."""
    from ...core.policy import attribute_rules
    n = masks[0].shape[0] if masks else 0
    return attribute_rules(masks[1:], n)


def merge_agg_partials(parts: List[np.ndarray],
                       n_programs: int) -> np.ndarray:
    """Combine per-launch (R, N_AGG) aggregate blocks into one exact
    (R, N_AGG) float64 block: the additive slots sum and the trailing
    ``any_match`` slot takes the max (each partial is integer-valued and
    f32-exact, so the float64 sum is exact)."""
    out = np.zeros((n_programs, N_AGG), np.float64)
    for p in parts:
        p = np.asarray(p, np.float64)
        out[:, : N_AGG - 1] += p[:, : N_AGG - 1]
        np.maximum(out[:, N_AGG - 1], p[:, N_AGG - 1],
                   out=out[:, N_AGG - 1])
    return out


def _agg_dict(agg_np: np.ndarray, per_rule: Optional[np.ndarray] = None
              ) -> dict:
    out = {
        "count": float(agg_np[0]), "volume": float(agg_np[1]),
        "spc_used": float(agg_np[2]),
        "size_profile": agg_np[3:13].tolist(),
        "any_match": bool(agg_np[13] > 0.5),
    }
    if per_rule is not None and per_rule.shape[0] > 1:
        out["rule_count"] = per_rule[1:, 0].tolist()
        out["rule_volume"] = per_rule[1:, 1].tolist()
        out["rule_spc_used"] = per_rule[1:, 2].tolist()
    return out


def match_programs(arrays, exprs, strings, now: float,
                   use_kernel: Optional[bool] = None,
                   single_launch: Optional[bool] = None, device=None
                   ) -> Tuple[List[np.ndarray], dict, np.ndarray]:
    """Evaluate several core.policy Exprs over catalog columns at once.

    ``exprs[0]`` is the combined match criteria (its fused aggregates are
    returned); further exprs are per-rule conditions in priority order.
    Returns ``(masks, agg, rule_idx)``: one boolean mask per program, the
    aggregate dict of program 0 (plus ``rule_count``/``rule_volume``/
    ``rule_spc_used`` per-rule reductions when rules are present), and the
    (N,) int32 first-match-wins rule attribution (-1 = no rule).

    The columns go to ``device`` (default the CUDA card; ``"cpu"`` runs the
    plain version). ``single_launch`` (default True) evaluates the whole
    (R, P) program batch in ONE launch with attribution and per-rule
    reductions fused on the device; ``single_launch=False`` launches once
    per program and attributes on the host (fallback and differential
    oracle). Raises PolicyError if any expr contains host-only (glob)
    predicates — callers fall back to the numpy mask path.
    """
    from ...core.policy import KERNEL_COLUMNS, compile_programs
    from ...core.telemetry import span as _tspan
    dev = resolve_device(device)
    with _tspan("kernel.compile"):
        ops, colidx, operands = compile_programs(exprs, strings, now)
        kcols = column_stack(arrays, dev)
    size_col = KERNEL_COLUMNS.index("size")
    blocks_col = KERNEL_COLUMNS.index("blocks")
    if single_launch is None:
        single_launch = True
    t_ops, t_col, t_opr = (torch.from_numpy(a).to(dev)
                           for a in (ops, colidx, operands))
    if single_launch:
        # the launch span times the async dispatch only; the device wait
        # lands in kernel.readback where the host actually blocks
        with _tspan("kernel.launch", programs=int(ops.shape[0])):
            m, rule, agg = policy_scan_batch(
                kcols, t_ops, t_col, t_opr, size_col=size_col,
                blocks_col=blocks_col, use_kernel=use_kernel)
        with _tspan("kernel.readback"):
            m = (m > 0.5).cpu().numpy()
            masks = [m[r] for r in range(m.shape[0])]
            per_rule = agg.cpu().numpy()
            rule = rule.cpu().numpy().astype(np.int32, copy=False)
        return masks, _agg_dict(per_rule[0], per_rule), rule
    # Fallback: one launch per program (each fuses mask + aggregation in a
    # single pass over the resident column stack), attribution on the host.
    masks, aggs = [], []
    for r in range(ops.shape[0]):
        m, a = policy_scan(kcols, t_ops[r], t_col[r], t_opr[r],
                           size_col=size_col, blocks_col=blocks_col,
                           use_kernel=use_kernel)
        aggs.append(a.cpu().numpy())
        masks.append((m > 0.5).cpu().numpy())
    per_rule = np.stack(aggs)
    return masks, _agg_dict(per_rule[0], per_rule), _attribute_np(masks)


def match_programs_mesh(store, exprs, now: float,
                        use_kernel: Optional[bool] = None):
    """Store-resident sibling of :func:`match_programs`: evaluate the
    (R, P) program batch over a
    :class:`~repro_torch.core.device_store.DeviceColumnStore` instead of a
    freshly uploaded column stack.

    The store refreshes stale shard groups by delta scatter (or full
    re-upload), launches :func:`mesh_policy_scan_batch` over the resident
    (D, n_cols, Rp) tensor, and pulls back only the program-0 mask and the
    rule attribution. Returns a ``MeshMatch`` (see device_store):
    ``.plan(sort_by)`` yields the matched (fids, sizes, sort_keys,
    rule_idx) arrays and ``.agg`` the fused aggregate dict — same
    semantics as :func:`match_programs`, differential-tested equal.
    Raises PolicyError on host-only (glob) predicates.
    """
    return store.match(exprs, now, use_kernel=use_kernel)


def scan_catalog(catalog, expr, now: float,
                 use_kernel: Optional[bool] = None, device=None,
                 store=None) -> Tuple[np.ndarray, dict]:
    """Run a core.policy expression over a Catalog via the kernel path.

    Only numeric/categorical predicates compile to the kernel program;
    glob predicates raise PolicyError (callers fall back to Expr.mask).
    Returns (matching fids, aggregate dict). When ``store`` (a
    :class:`~repro_torch.core.device_store.DeviceColumnStore` over the same
    catalog) is given, the scan runs over its resident column stacks on
    the store's device — no host-side concat, no host->device re-upload;
    ``device`` is then not used.
    """
    if store is not None:
        if store.catalog is not catalog:
            from ...core.policy import PolicyError
            raise PolicyError("device store wraps a different catalog "
                              "than the one passed to scan_catalog")
        return store.scan(expr, now, use_kernel=use_kernel)
    from ...core.policy import KERNEL_COLUMNS, compile_program
    from ...core.telemetry import span as _tspan
    dev = resolve_device(device)
    with _tspan("kernel.compile"):
        arrays = catalog.arrays()
        ops, colidx, operands = compile_program(expr, catalog.strings, now)
        cols = column_stack(arrays, dev)
    size_col = KERNEL_COLUMNS.index("size")
    blocks_col = KERNEL_COLUMNS.index("blocks")
    with _tspan("kernel.launch"):
        mask, agg = policy_scan(cols, *(torch.from_numpy(a).to(dev)
                                        for a in (ops, colidx, operands)),
                                size_col=size_col, blocks_col=blocks_col,
                                use_kernel=use_kernel)
    with _tspan("kernel.readback"):
        mask_np = (mask > 0.5).cpu().numpy()
        agg_np = agg.cpu().numpy()
    return arrays["fid"][mask_np], _agg_dict(agg_np)
