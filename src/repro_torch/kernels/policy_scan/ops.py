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
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .kernel import policy_scan_batch_cuda, policy_scan_cuda
from .ref import N_AGG, policy_scan_batch_ref, policy_scan_ref


def _kernel_for(cols: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    on_card = cols.device.type == "cuda"
    if use_kernel is None:
        return on_card
    if use_kernel and not on_card:
        raise ValueError("use_kernel=True needs CUDA tensors: the "
                         f"policy_scan kernels do not run on {cols.device}")
    if not use_kernel and on_card:
        raise ValueError("use_kernel=False on CUDA tensors: the plain "
                         "version serves CPU tensors only (call ref.* "
                         "directly to run it on the card)")
    return bool(use_kernel)


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
    kernel = _kernel_for(cols, use_kernel)
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
    kernel = _kernel_for(cols, use_kernel)
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


def scan_catalog(catalog, expr, now: float,
                 use_kernel: Optional[bool] = None, device=None
                 ) -> Tuple[np.ndarray, dict]:
    """Run a core.policy expression over a Catalog via the kernel path.

    Only numeric/categorical predicates compile to the kernel program;
    glob predicates raise PolicyError (callers fall back to Expr.mask).
    Returns (matching fids, aggregate dict).
    """
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
