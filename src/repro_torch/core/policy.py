"""Policy criteria language (C5): parse, evaluate, vectorize, compile.

The paper's example::

    (size > 1GB or owner == 'foo') and path == '/my/fs/*.tar'

Expressions support:

* numeric attributes with unit literals (``1GB``, ``30d``): ``size``,
  ``blocks``, ``nlink``, ``ost_idx``, ``archive_id``;
* age attributes (robinhood semantics — ``last_access > 30d`` means
  *accessed more than 30 days ago*): ``last_access``, ``last_mod``,
  ``creation``;
* string/categorical attributes: ``owner``, ``group``, ``pool``,
  ``status``, ``type`` (``file``/``dir``/``symlink``) with equality, and
  glob matching for ``path`` / ``name``;
* ``hsm_state`` (``none``/``dirty``/``archived``/``released``/...);
* boolean composition with ``and`` / ``or`` / ``not`` and parentheses.

Three evaluators, all oracle-equivalent (tested by hypothesis):

1. :meth:`Expr.evaluate` — per-entry Python (the paper's MySQL-row analogue);
2. :meth:`Expr.mask` — vectorized numpy over catalog columns;
3. :meth:`compile_program` — a flat postfix instruction program executed by
   the ``policy_scan`` CUDA kernel (numeric/categorical predicates).
"""
from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .types import FsType, HsmState, parse_duration, parse_size

NUMERIC_ATTRS = ("size", "blocks", "nlink", "ost_idx", "archive_id", "mode",
                 "dirty")
AGE_ATTRS = {"last_access": "atime", "last_mod": "mtime", "creation": "ctime"}
CATEGORICAL_ATTRS = ("owner", "group", "pool", "status")
GLOB_ATTRS = ("path", "name")

_TYPE_NAMES = {"file": FsType.FILE, "dir": FsType.DIR,
               "directory": FsType.DIR, "symlink": FsType.SYMLINK,
               "other": FsType.OTHER}
_HSM_NAMES = {s.name.lower(): s for s in HsmState}

_OPS = ("==", "!=", ">=", "<=", ">", "<")

# Postfix program opcodes (shared with kernels/policy_scan).
OP_CMP_EQ, OP_CMP_NE, OP_CMP_GT, OP_CMP_GE, OP_CMP_LT, OP_CMP_LE = range(6)
OP_AND, OP_OR, OP_NOT = 6, 7, 8
OP_NOP = -1     # padding opcode: leaves the evaluation stack untouched
_CMP_CODE = {"==": OP_CMP_EQ, "!=": OP_CMP_NE, ">": OP_CMP_GT,
             ">=": OP_CMP_GE, "<": OP_CMP_LT, "<=": OP_CMP_LE}


class PolicyError(ValueError):
    pass


class Expr:
    """Base criteria node."""

    def evaluate(self, entry, now: float) -> bool:
        raise NotImplementedError

    def mask(self, cols: Dict[str, np.ndarray], strings, now: float) -> np.ndarray:
        raise NotImplementedError

    def to_postfix(self, strings, now: float) -> List[Tuple[int, int, float]]:
        """(opcode, col_index, operand) program; raises PolicyError on globs."""
        raise NotImplementedError


# Column order the kernel program indexes into (numeric/categorical subset).
KERNEL_COLUMNS = ("size", "blocks", "nlink", "ost_idx", "archive_id", "mode",
                  "dirty", "atime", "mtime", "ctime", "type", "hsm_state",
                  "owner", "group", "pool", "status")
_KCOL = {c: i for i, c in enumerate(KERNEL_COLUMNS)}


def _entry_attr(entry, attr: str):
    if isinstance(entry, dict):
        return entry[attr]
    return getattr(entry, attr)


@dataclass
class Cmp(Expr):
    attr: str
    op: str
    value: object          # int/float for numeric; str for cat/glob

    def __post_init__(self):
        if self.op not in _OPS:
            raise PolicyError(f"bad operator {self.op!r}")

    # -- scalar ---------------------------------------------------------------
    def _cmp(self, lhs, rhs) -> bool:
        return {"==": lhs == rhs, "!=": lhs != rhs, ">": lhs > rhs,
                ">=": lhs >= rhs, "<": lhs < rhs, "<=": lhs <= rhs}[self.op]

    def evaluate(self, entry, now: float) -> bool:
        a = self.attr
        if a in NUMERIC_ATTRS:
            return self._cmp(int(_entry_attr(entry, a)), self.value)
        if a in AGE_ATTRS:
            age = now - float(_entry_attr(entry, AGE_ATTRS[a]))
            return self._cmp(age, self.value)
        if a == "type":
            tv = _entry_attr(entry, "type")
            tv = int(tv) if not isinstance(tv, str) else int(_TYPE_NAMES[tv])
            return self._cmp(tv, int(self.value))
        if a == "hsm_state":
            return self._cmp(int(_entry_attr(entry, a)), int(self.value))
        if a in CATEGORICAL_ATTRS:
            if self.op not in ("==", "!="):
                raise PolicyError(f"{a} supports ==/!= only")
            return self._cmp(str(_entry_attr(entry, a)), self.value)
        if a in GLOB_ATTRS:
            if self.op not in ("==", "!="):
                raise PolicyError(f"{a} supports ==/!= only")
            hit = fnmatch.fnmatchcase(str(_entry_attr(entry, a)), self.value)
            return hit if self.op == "==" else not hit
        raise PolicyError(f"unknown attribute {a!r}")

    # -- vectorized -------------------------------------------------------------
    def _npcmp(self, lhs: np.ndarray, rhs) -> np.ndarray:
        return {"==": lhs == rhs, "!=": lhs != rhs, ">": lhs > rhs,
                ">=": lhs >= rhs, "<": lhs < rhs, "<=": lhs <= rhs}[self.op]

    def mask(self, cols, strings, now: float) -> np.ndarray:
        a = self.attr
        if a in NUMERIC_ATTRS:
            return self._npcmp(cols[a], self.value)
        if a in AGE_ATTRS:
            return self._npcmp(now - cols[AGE_ATTRS[a]], self.value)
        if a in ("type", "hsm_state"):
            return self._npcmp(cols[a], int(self.value))
        if a in CATEGORICAL_ATTRS:
            code = strings.code_of(self.value)
            if code is None:          # string never interned -> no entry has it
                n = len(cols[a])
                return np.zeros(n, bool) if self.op == "==" else np.ones(n, bool)
            return self._npcmp(cols[a], code)
        if a in GLOB_ATTRS:
            pat = re.compile(fnmatch.translate(self.value))
            key = "_paths" if a == "path" else "_names"
            hit = np.fromiter((pat.match(s) is not None for s in cols[key]),
                              dtype=bool, count=len(cols[key]))
            return hit if self.op == "==" else ~hit
        raise PolicyError(f"unknown attribute {a!r}")

    # -- kernel program -----------------------------------------------------------
    def to_postfix(self, strings, now: float):
        a = self.attr
        op = _CMP_CODE[self.op]
        if a in NUMERIC_ATTRS:
            return [(op, _KCOL[a], float(self.value))]
        if a in AGE_ATTRS:
            # age > T  <=>  time_col < now - T  (flip the comparison)
            flip = {OP_CMP_GT: OP_CMP_LT, OP_CMP_GE: OP_CMP_LE,
                    OP_CMP_LT: OP_CMP_GT, OP_CMP_LE: OP_CMP_GE,
                    OP_CMP_EQ: OP_CMP_EQ, OP_CMP_NE: OP_CMP_NE}[op]
            return [(flip, _KCOL[AGE_ATTRS[a]], float(now - self.value))]
        if a in ("type", "hsm_state"):
            return [(op, _KCOL[a], float(int(self.value)))]
        if a in CATEGORICAL_ATTRS:
            code = strings.code_of(self.value)
            code = -1.0 if code is None else float(code)
            return [(op, _KCOL[a], code)]
        raise PolicyError(f"attribute {a!r} not supported by the kernel path "
                          "(glob predicates run on the host)")


@dataclass
class And(Expr):
    lhs: Expr
    rhs: Expr

    def evaluate(self, entry, now):
        return self.lhs.evaluate(entry, now) and self.rhs.evaluate(entry, now)

    def mask(self, cols, strings, now):
        return self.lhs.mask(cols, strings, now) & self.rhs.mask(cols, strings, now)

    def to_postfix(self, strings, now):
        return self.lhs.to_postfix(strings, now) + self.rhs.to_postfix(strings, now) \
            + [(OP_AND, 0, 0.0)]


@dataclass
class Or(Expr):
    lhs: Expr
    rhs: Expr

    def evaluate(self, entry, now):
        return self.lhs.evaluate(entry, now) or self.rhs.evaluate(entry, now)

    def mask(self, cols, strings, now):
        return self.lhs.mask(cols, strings, now) | self.rhs.mask(cols, strings, now)

    def to_postfix(self, strings, now):
        return self.lhs.to_postfix(strings, now) + self.rhs.to_postfix(strings, now) \
            + [(OP_OR, 0, 0.0)]


@dataclass
class Not(Expr):
    inner: Expr

    def evaluate(self, entry, now):
        return not self.inner.evaluate(entry, now)

    def mask(self, cols, strings, now):
        return ~self.inner.mask(cols, strings, now)

    def to_postfix(self, strings, now):
        return self.inner.to_postfix(strings, now) + [(OP_NOT, 0, 0.0)]


@dataclass
class Const(Expr):
    value: bool

    def evaluate(self, entry, now):
        return self.value

    def mask(self, cols, strings, now):
        return np.full(len(cols["fid"]), self.value, dtype=bool)

    def to_postfix(self, strings, now):
        # encode as tautology / contradiction on the size column
        op = OP_CMP_GE if self.value else OP_CMP_LT
        return [(op, _KCOL["size"], float("-inf"))]


ALWAYS = Const(True)

# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<lpar>\() | (?P<rpar>\)) |
        (?P<op>==|!=|>=|<=|>|<) |
        (?P<str>'[^']*'|"[^"]*") |
        (?P<word>[A-Za-z0-9_./*?\[\]\-~+]+)
    )""", re.VERBOSE)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise PolicyError(f"cannot tokenize near {text[pos:pos+20]!r}")
        pos = m.end()
        for kind in ("lpar", "rpar", "op", "str", "word"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    return out


_SIZE_RE = re.compile(r"^\d+(\.\d+)?\s*[KMGTP]?B?$", re.IGNORECASE)
_DUR_RE = re.compile(r"^\d+(\.\d+)?(s|sec|m|min|h|d|w|y)$", re.IGNORECASE)
_NUM_RE = re.compile(r"^-?\d+(\.\d+)?$")


def _parse_value(attr: str, tok_kind: str, tok: str):
    raw = tok[1:-1] if tok_kind == "str" else tok
    if attr in AGE_ATTRS:
        return parse_duration(raw)
    if attr == "type":
        return int(_TYPE_NAMES[raw.lower()])
    if attr == "hsm_state":
        return int(_HSM_NAMES[raw.lower()])
    if attr in NUMERIC_ATTRS:
        if _NUM_RE.match(raw):
            return int(float(raw))
        if _SIZE_RE.match(raw):
            return parse_size(raw)
        raise PolicyError(f"bad numeric literal {raw!r} for {attr}")
    return raw   # categorical / glob keeps the string


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def parse(self) -> Expr:
        e = self.or_expr()
        if self.i != len(self.toks):
            raise PolicyError(f"trailing tokens: {self.toks[self.i:]}")
        return e

    def or_expr(self) -> Expr:
        e = self.and_expr()
        while self.peek() == ("word", "or"):
            self.next()
            e = Or(e, self.and_expr())
        return e

    def and_expr(self) -> Expr:
        e = self.not_expr()
        while self.peek() == ("word", "and"):
            self.next()
            e = And(e, self.not_expr())
        return e

    def not_expr(self) -> Expr:
        kind, val = self.peek()
        if (kind, val) == ("word", "not"):
            self.next()
            return Not(self.not_expr())
        if kind == "lpar":
            self.next()
            e = self.or_expr()
            k, _ = self.next()
            if k != "rpar":
                raise PolicyError("missing ')'")
            return e
        if (kind, val) == ("word", "true"):
            self.next()
            return Const(True)
        if (kind, val) == ("word", "false"):
            self.next()
            return Const(False)
        return self.cmp()

    def cmp(self) -> Expr:
        kind, attr = self.next()
        if kind != "word":
            raise PolicyError(f"expected attribute, got {attr!r}")
        kind, op = self.next()
        if kind != "op":
            raise PolicyError(f"expected operator after {attr!r}, got {op!r}")
        vkind, vtok = self.next()
        if vkind not in ("word", "str"):
            raise PolicyError(f"expected value, got {vtok!r}")
        return Cmp(attr, op, _parse_value(attr, vkind, vtok))


def parse_expr(text: str) -> Expr:
    """Parse a criteria expression string into an AST."""
    return _Parser(_tokenize(text)).parse()


def compile_program(expr: Expr, strings, now: float
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten an AST into kernel instruction arrays (opcode, col, operand)."""
    prog = expr.to_postfix(strings, now)
    ops = np.array([p[0] for p in prog], dtype=np.int32)
    cols = np.array([p[1] for p in prog], dtype=np.int32)
    operands = np.array([p[2] for p in prog], dtype=np.float32)
    return ops, cols, operands


def iter_exprs(expr: Expr):
    """Yield every node of a criteria AST (pre-order)."""
    yield expr
    if isinstance(expr, (And, Or)):
        yield from iter_exprs(expr.lhs)
        yield from iter_exprs(expr.rhs)
    elif isinstance(expr, Not):
        yield from iter_exprs(expr.inner)


def any_of(exprs: Sequence[Expr]) -> Expr:
    """OR-fold a list of criteria (empty list -> ALWAYS)."""
    if not exprs:
        return ALWAYS
    out = exprs[0]
    for e in exprs[1:]:
        out = Or(out, e)
    return out


def all_of(exprs: Sequence[Expr]) -> Expr:
    """AND-fold a list of criteria (empty list -> ALWAYS)."""
    if not exprs:
        return ALWAYS
    out = exprs[0]
    for e in exprs[1:]:
        out = And(out, e)
    return out


def attribute_rules(rule_masks: Sequence[np.ndarray], n: int) -> np.ndarray:
    """First-match-wins rule attribution: the single host-side authority.

    ``rule_masks`` are the per-rule boolean masks in priority order (the
    policy's combined criteria mask is NOT included). Returns (n,) int32:
    index of the first matching rule per row, -1 where none match. The
    engine's numpy path, the per-rule-launch kernel fallback, and the
    fused on-device attribution (``attribute_ref`` / the batch kernel) all
    implement exactly these semantics — differential-tested equal.
    """
    if not rule_masks:
        return np.full(n, -1, dtype=np.int32)
    stacked = np.stack(rule_masks)
    idx = np.argmax(stacked, axis=0).astype(np.int32)   # first True wins
    idx[~stacked.any(axis=0)] = -1
    return idx


def compile_programs(exprs: Sequence[Expr], strings, now: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compile several criteria into one (R, P) instruction batch.

    Programs are right-padded with OP_NOP so a single vmapped scan can
    evaluate all of them over the same column stack in one pass.
    """
    progs = [e.to_postfix(strings, now) for e in exprs]
    plen = max(len(p) for p in progs)
    ops = np.full((len(progs), plen), OP_NOP, dtype=np.int32)
    cols = np.zeros((len(progs), plen), dtype=np.int32)
    operands = np.zeros((len(progs), plen), dtype=np.float32)
    for r, prog in enumerate(progs):
        for i, (op, col, val) in enumerate(prog):
            ops[r, i] = op
            cols[r, i] = col
            operands[r, i] = val
    return ops, cols, operands
