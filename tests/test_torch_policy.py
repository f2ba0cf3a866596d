"""The port's criteria compiler against the JAX package's.

``repro_torch.core.policy`` is a copy of ``repro.core.policy``: for the
same criteria strings and the same interned strings, ``compile_programs``
must return identical (R, P) opcode, column and operand arrays, and the
numpy masks and attribution must agree.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.catalog import StringTable as JStringTable
from repro.core import policy as jpolicy
from repro_torch.core.catalog import StringTable as TStringTable
from repro_torch.core import policy as tpolicy

NOW = 16_000_000.0

CRITERIA = [
    "true",
    "false",
    "size > 1GB",
    "size <= 32M",
    "size >= 1M and size < 64M",
    "blocks > 4096",
    "nlink != 1",
    "ost_idx == 3",
    "last_access > 30d",
    "last_mod <= 2h",
    "creation >= 15min",
    "last_access == 1000s",
    "owner == 'u1'",
    "group != 'grp0'",
    "pool == 'ssd' or pool == 'never-interned'",
    "status == ''",
    "type == file",
    "type != dir and hsm_state == archived",
    "not type == dir",
    "not (size <= 1M or last_access <= 500s)",
    "(size > 1GB or owner == 'u1') and type == file",
    "not (type == file and size <= 32M)",
    "((size > 8M or owner == 'u0') and not hsm_state == released) "
    "or (last_mod > 7d and not (pool == 'hdd' or dirty == 1))",
]


def _tables():
    jst, tst = JStringTable(), TStringTable()
    for s in ("u0", "u1", "u2", "grp0", "ssd", "hdd"):
        assert jst.intern(s) == tst.intern(s)
    return jst, tst


@pytest.mark.parametrize("text", CRITERIA)
def test_compile_program_matches_jax(text):
    jst, tst = _tables()
    want = jpolicy.compile_program(jpolicy.parse_expr(text), jst, NOW)
    got = tpolicy.compile_program(tpolicy.parse_expr(text), tst, NOW)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_compile_programs_batch_matches_jax():
    """The whole list as one NOP-padded (R, P) batch, plus the combined
    criteria the engine builds with all_of/any_of."""
    jst, tst = _tables()
    jex = [jpolicy.parse_expr(t) for t in CRITERIA]
    tex = [tpolicy.parse_expr(t) for t in CRITERIA]
    jex.insert(0, jpolicy.all_of([jex[6], jpolicy.any_of(jex[1:])]))
    tex.insert(0, tpolicy.all_of([tex[6], tpolicy.any_of(tex[1:])]))
    want = jpolicy.compile_programs(jex, jst, NOW)
    got = tpolicy.compile_programs(tex, tst, NOW)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_masks_and_attribution_match_jax():
    rng = np.random.default_rng(11)
    n = 500
    jst, tst = _tables()
    cols = {
        "fid": np.arange(1, n + 1),
        "size": rng.integers(0, 1 << 12, n) * (1 << 20),
        "blocks": rng.integers(0, 1 << 14, n),
        "nlink": rng.integers(1, 3, n), "ost_idx": rng.integers(0, 5, n),
        "archive_id": np.zeros(n, int), "mode": np.full(n, 0o644),
        "dirty": rng.integers(0, 2, n),
        "atime": NOW - rng.integers(0, 60 * 86400, n),
        "mtime": NOW - rng.integers(0, 60 * 86400, n),
        "ctime": NOW - rng.integers(0, 60 * 86400, n),
        "type": rng.integers(0, 2, n), "hsm_state": rng.integers(0, 5, n),
        "owner": rng.integers(1, 4, n), "group": np.full(n, 4),
        "pool": rng.integers(5, 7, n), "status": np.zeros(n, int),
    }
    jm = [jpolicy.parse_expr(t).mask(cols, jst, NOW) for t in CRITERIA]
    tm = [tpolicy.parse_expr(t).mask(cols, tst, NOW) for t in CRITERIA]
    for g, w in zip(tm, jm):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tpolicy.attribute_rules(tm, n),
                                  jpolicy.attribute_rules(jm, n))
