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


# -- tests/core/test_policy.py: the parser and three-evaluator equivalence ----

def _evaluate(text, entries):
    """``parse_expr(text).evaluate`` on each entry dict, on both packages
    (the enum-valued fields as each package's own enum)."""
    import repro.core as jcore
    import repro_torch.core as tcore
    out = []
    for pol, core in ((jpolicy, jcore), (tpolicy, tcore)):
        expr = pol.parse_expr(text)
        row = []
        for ent in entries:
            ent = dict(ent)
            if "type" in ent:
                ent["type"] = core.FsType(ent["type"])
            if "hsm_state" in ent:
                ent["hsm_state"] = core.HsmState(ent["hsm_state"])
            row.append(bool(expr.evaluate(ent, PARSE_NOW)))
        out.append(row)
    assert out[1] == out[0]
    return out[1]


PARSE_NOW = 2_000_000.0


def test_paper_example_parses():
    got = _evaluate("(size > 1GB or owner == 'foo') "
                    "and path == '/my/fs/*.tar'",
                    [dict(size=2 << 30, owner="bar", path="/my/fs/x.tar"),
                     dict(size=10, owner="foo", path="/my/fs/y.tar"),
                     dict(size=10, owner="baz", path="/my/fs/y.tar")])
    assert got == [True, True, False]


def test_units_and_ages():
    from repro_torch.core.types import parse_size
    assert parse_size("1GB") == 1 << 30
    assert parse_size("512k") == 512 << 10
    got = _evaluate("last_access > 1d", [dict(atime=PARSE_NOW - 90000),
                                         dict(atime=PARSE_NOW - 100)])
    assert got == [True, False]


def test_type_and_hsm_literals():
    # 1 == FsType.DIR, 4 == HsmState.RELEASED
    got = _evaluate("type == dir and hsm_state == released",
                    [dict(type=1, hsm_state=4), dict(type=0, hsm_state=4)])
    assert got == [True, False]


@pytest.mark.parametrize("bad", ["size >", "and size > 1", "size >> 3",
                                 "(size > 1"])
def test_parse_errors(bad):
    with pytest.raises(tpolicy.PolicyError):
        tpolicy.parse_expr(bad)
    with pytest.raises(jpolicy.PolicyError):
        jpolicy.parse_expr(bad)


try:                          # optional dependency: the equivalence skips
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = None

_NAMES = ["foo", "bar", "baz"]

if given is not None:
    _num_attr = st.sampled_from(["size", "blocks", "nlink"])
    _cat_attr = st.sampled_from(["owner", "group"])
    _op = st.sampled_from(["==", "!=", ">", ">=", "<", "<="])

    def _leaf():
        num = st.builds(lambda a, o, v: f"{a} {o} {v}", _num_attr, _op,
                        st.integers(0, 10000))
        cat = st.builds(lambda a, o, v: f"{a} {o} '{v}'", _cat_attr,
                        st.sampled_from(["==", "!="]),
                        st.sampled_from(_NAMES))
        return st.one_of(num, cat)

    def _expr(depth=2):
        if depth == 0:
            return _leaf()
        sub = _expr(depth - 1)
        return st.one_of(
            _leaf(),
            st.builds(lambda a, b: f"({a} and {b})", sub, sub),
            st.builds(lambda a, b: f"({a} or {b})", sub, sub),
            st.builds(lambda a: f"not ({a})", sub),
        )

    @settings(max_examples=40, derandomize=True, database=None,
              deadline=None)
    @given(text=_expr(), seed=st.integers(0, 99))
    def test_evaluator_equivalence(text, seed):
        """Per-entry evaluation, the numpy mask and the port's plain
        kernel program (torch tensors) agree on random expressions, and
        the mask equals the reference's."""
        import torch
        from repro_torch.core import Catalog, Entry, FsType
        from repro_torch.kernels.policy_scan.ref import eval_program
        rng = np.random.default_rng(seed)
        cat = Catalog(n_shards=2)
        for fid in range(1, 41):
            cat.upsert(Entry(
                fid=fid, name=f"f{fid}", path=f"/x/f{fid}", type=FsType.FILE,
                size=int(rng.integers(0, 12000)),
                blocks=int(rng.integers(0, 12000)),
                nlink=int(rng.integers(1, 5)),
                owner=_NAMES[rng.integers(0, 3)],
                group=_NAMES[rng.integers(0, 3)],
                atime=PARSE_NOW - 10, mtime=PARSE_NOW - 10,
                ctime=PARSE_NOW - 10))
        expr = tpolicy.parse_expr(text)
        cols = cat.arrays()
        vec = expr.mask(cols, cat.strings, PARSE_NOW)
        by_fid = {int(f): m for f, m in zip(cols["fid"], vec)}
        for e in cat.entries():
            assert expr.evaluate(e, PARSE_NOW) == bool(by_fid[e.fid]), text
        ops, ci, opr = tpolicy.compile_program(expr, cat.strings, PARSE_NOW)
        kcols = torch.stack([torch.as_tensor(np.asarray(cols[c]),
                                             dtype=torch.float32)
                             for c in tpolicy.KERNEL_COLUMNS])
        kmask = eval_program(kcols, *(torch.from_numpy(a)
                                      for a in (ops, ci, opr)))
        np.testing.assert_array_equal(kmask.numpy() > 0.5, vec, err_msg=text)
        jst = JStringTable()
        for code in range(len(cat.strings)):
            jst.intern(cat.strings.lookup(code))
        np.testing.assert_array_equal(
            jpolicy.parse_expr(text).mask(cols, jst, PARSE_NOW), vec,
            err_msg=text)
