"""policy_scan: the port's ops and plain version against the JAX package's.

The same numpy inputs, made from a seed, go through ``repro``'s
``policy_scan`` / ``policy_scan_batch`` (the Pallas kernels, in interpret
mode off-TPU) and refs, and through ``repro_torch``'s ops on the CPU. Masks
and rule indices must be identical. Aggregates must be identical on
f32-exact inputs (every sum below 2^24); on the wide ``_random_cols``
inputs f32 sums of values up to 2^32 round differently in another order,
so they are held to ``rtol=1e-5, atol=1``, the tolerance the reference's
own kernel tests use. Tests marked ``cuda`` hold the hand-written kernels
to the plain version on the card and skip where there is none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.catalog import StringTable
from repro_torch.core.policy import (KERNEL_COLUMNS, compile_program,
                                     compile_programs, parse_expr)
from repro_torch.kernels.policy_scan import ops as tops
from repro_torch.kernels.policy_scan import ref as tref

SIZE = KERNEL_COLUMNS.index("size")
BLOCKS = KERNEL_COLUMNS.index("blocks")
KW = dict(size_col=SIZE, blocks_col=BLOCKS)
SINGLE = "(size > 1GB or owner == 'u1') and type == file"
BATCH = [SINGLE, "size > 1GB", "owner == 'u1'",
         "not (type == file and size <= 32M)"]
SIZES = [0, 17, 100, 1024, 3000]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the policy_scan kernels run only "
                    "there")
    return torch.device("cuda")


def _strings():
    st = StringTable()
    for s in ("u0", "u1", "u2"):
        st.intern(s)
    return st


def _random_cols(rng, n):
    """The reference kernel tests' inputs: sizes/blocks up to 2^32."""
    cols = np.zeros((len(KERNEL_COLUMNS), n), np.float32)
    cols[SIZE] = rng.integers(0, 1 << 32, n)
    cols[BLOCKS] = rng.integers(0, 1 << 32, n)
    cols[KERNEL_COLUMNS.index("owner")] = rng.integers(0, 4, n)
    cols[KERNEL_COLUMNS.index("type")] = rng.integers(0, 2, n)
    cols[KERNEL_COLUMNS.index("atime")] = 1e6 - rng.integers(0, 1e5, n)
    return cols


def _exact_cols(rng, n):
    """f32-exact inputs: sizes are multiples of 1 MiB below 4 GiB and
    blocks below 2^10, so every partial sum of any order is a multiple of
    its unit below 2^24 units and no sum rounds."""
    cols = np.zeros((len(KERNEL_COLUMNS), n), np.float32)
    cols[SIZE] = rng.integers(0, 1 << 12, n) * float(1 << 20)
    cols[BLOCKS] = rng.integers(0, 1 << 10, n)
    cols[KERNEL_COLUMNS.index("owner")] = rng.integers(0, 4, n)
    cols[KERNEL_COLUMNS.index("type")] = rng.integers(0, 2, n)
    return cols


def _jax_ops():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ops as jops
    from repro.kernels.policy_scan import ref as jref
    return jnp, jops, jref


def _programs(batch):
    st = _strings()
    if batch:
        return compile_programs([parse_expr(e) for e in BATCH], st, now=1e6)
    return compile_program(parse_expr(SINGLE), st, now=1e6)


def _agg_check(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1)


@pytest.mark.parametrize("exact", [True, False], ids=["f32exact", "wide"])
@pytest.mark.parametrize("n", SIZES)
def test_policy_scan_matches_jax(n, exact):
    jnp, jops, jref = _jax_ops()
    rng = np.random.default_rng(n + 7 * exact)
    cols = (_exact_cols if exact else _random_cols)(rng, n)
    prog = _programs(batch=False)
    jargs = [jnp.asarray(a) for a in (cols, *prog)]
    targs = [torch.from_numpy(a) for a in (cols, *prog)]
    mask_k, agg_k = jops.policy_scan(*jargs, use_kernel=True, **KW)
    mask_t, agg_t = tops.policy_scan(*targs, **KW)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_k))
    _agg_check(agg_t.numpy(), np.asarray(agg_k), exact)
    if n:
        mask_jr, agg_jr = jref.policy_scan_ref(*jargs, **KW)
        mask_tr, agg_tr = tref.policy_scan_ref(*targs, **KW)
        np.testing.assert_array_equal(mask_tr.numpy(), np.asarray(mask_jr))
        _agg_check(agg_tr.numpy(), np.asarray(agg_jr), exact)


@pytest.mark.parametrize("exact", [True, False], ids=["f32exact", "wide"])
@pytest.mark.parametrize("n", SIZES)
def test_policy_scan_batch_matches_jax(n, exact):
    jnp, jops, jref = _jax_ops()
    rng = np.random.default_rng(100 + n + 7 * exact)
    cols = (_exact_cols if exact else _random_cols)(rng, n)
    prog = _programs(batch=True)
    jargs = [jnp.asarray(a) for a in (cols, *prog)]
    targs = [torch.from_numpy(a) for a in (cols, *prog)]
    masks_k, rule_k, agg_k = jops.policy_scan_batch(*jargs, use_kernel=True,
                                                    **KW)
    masks_t, rule_t, agg_t = tops.policy_scan_batch(*targs, **KW)
    np.testing.assert_array_equal(masks_t.numpy(), np.asarray(masks_k))
    np.testing.assert_array_equal(rule_t.numpy(), np.asarray(rule_k))
    assert rule_t.dtype == torch.int32 and masks_t.dtype == torch.float32
    _agg_check(agg_t.numpy(), np.asarray(agg_k), exact)
    if n:
        jm, jr, ja = jref.policy_scan_batch_ref(*jargs, **KW)
        tm, tr, ta = tref.policy_scan_batch_ref(*targs, **KW)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        _agg_check(ta.numpy(), np.asarray(ja), exact)
        np.testing.assert_array_equal(
            tref.attribute_ref(tm).numpy(),
            np.asarray(jref.attribute_ref(jnp.asarray(tm.numpy()))))


def test_eval_program_stack_edges_match_jax():
    """NOP padding, an empty program, NOT at the bottom of the stack and a
    stray AND on an empty stack: the clamp rules agree with the reference
    while the stack stays within its 8 slots."""
    jnp, _jops, jref = _jax_ops()
    rng = np.random.default_rng(3)
    cols = _random_cols(rng, 64)
    progs = [
        ([-1, -1], [0, 0], [0.0, 0.0]),                    # all NOPs
        ([8], [0], [0.0]),                                 # NOT on empty
        ([6, 2, -1], [0, 0, 0], [0.0, 1e9, 0.0]),          # AND on empty
        ([2, 4, 6, 8, -1, 0], [0, 12, 0, 0, 0, 10], [1e9, 1.0, 0, 0, 0, 0]),
        ([0, 1, 2, 3, 4, 5, 7, 7, 7, 7, 7], [12, 12, 0, 0, 1, 1, 0, 0, 0, 0, 0],
         [1.0, 2.0, 3e9, 1e9, 2e9, 4e9, 0, 0, 0, 0, 0]),
    ]
    for o, c, v in progs:
        o, c, v = (np.asarray(o, np.int32), np.asarray(c, np.int32),
                   np.asarray(v, np.float32))
        want = jref.eval_program(*(jnp.asarray(a) for a in (cols, o, c, v)))
        got = tref.eval_program(*(torch.from_numpy(a) for a in (cols, o, c,
                                                                 v)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = np.zeros(0, np.int32)
    got = tref.eval_program(torch.from_numpy(cols), torch.from_numpy(empty),
                            torch.from_numpy(empty),
                            torch.zeros(0, dtype=torch.float32))
    assert not got.any()


def test_merge_agg_partials_and_agg_dict_match_jax():
    _jnp, jops, _jref = _jax_ops()
    rng = np.random.default_rng(5)
    parts = [rng.integers(0, 1 << 20, (3, 14)).astype(np.float32)
             for _ in range(4)]
    for p in parts:
        p[:, 13] = rng.integers(0, 2, 3)
    got = tops.merge_agg_partials(parts, 3)
    np.testing.assert_array_equal(got, jops.merge_agg_partials(parts, 3))
    assert got.dtype == np.float64
    for per_rule in (None, parts[0], parts[0][:1]):
        assert tops._agg_dict(parts[1][0], per_rule) == \
            jops._agg_dict(parts[1][0], per_rule)
    masks = [rng.random(50) < p for p in (0.5, 0.2, 0.3, 0.1)]
    np.testing.assert_array_equal(tops._attribute_np(masks),
                                  jops._attribute_np(masks))


def test_ops_keep_the_plain_version_to_cpu_tensors():
    cols = torch.from_numpy(_random_cols(np.random.default_rng(1), 32))
    prog = [torch.from_numpy(a) for a in _programs(batch=True)]
    with pytest.raises(ValueError):
        tops.policy_scan_batch(cols, *prog, use_kernel=True, **KW)
    with pytest.raises(ValueError):
        tops.policy_scan(cols, prog[0][0], prog[1][0], prog[2][0],
                         use_kernel=True, **KW)
    m, r, a = tops.policy_scan_batch(cols, *prog, use_kernel=False, **KW)
    assert m.shape == (4, 32) and r.shape == (32,) and a.shape == (4, 14)


def test_no_validity_column_reads_as_a_row_of_ones():
    """``valid_col=-1`` gives what an appended all-ones validity row gives,
    without copying the columns."""
    host = _random_cols(np.random.default_rng(2), 300)
    ones = np.concatenate([host, np.ones((1, 300), np.float32)])
    prog = [torch.from_numpy(a) for a in _programs(batch=True)]
    got = tops.policy_scan_batch(torch.from_numpy(host), *prog, **KW)
    want = tops.policy_scan_batch(torch.from_numpy(ones), *prog,
                                  valid_col=len(KERNEL_COLUMNS), **KW)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = tops.policy_scan(torch.from_numpy(host), *(p[0] for p in prog),
                           **KW)
    want = tops.policy_scan(torch.from_numpy(ones), *(p[0] for p in prog),
                            valid_col=len(KERNEL_COLUMNS), **KW)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_build_dir_is_inside_the_checkout_or_named(monkeypatch, tmp_path):
    from pathlib import Path
    from repro_torch.kernels.policy_scan import kernel as tk
    root = Path(tk.__file__).resolve().parents[4]
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert tk.build_dir() == root / "build" / "repro_torch"
    assert tk.library_path().parent == tk.build_dir()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert tk.build_dir() == tmp_path


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("valid", [True, False], ids=["valid_col", "all"])
@pytest.mark.parametrize("n", [1, 17, 1024, 1025, 3000, 100_003])
def test_cuda_kernels_match_plain_version(cuda_device, n, valid):
    from repro_torch.kernels.policy_scan import kernel as tk
    rng = np.random.default_rng(n)
    host = np.concatenate([_random_cols(rng, n),
                           (rng.random((1, n)) < 0.95).astype(np.float32)])
    cols = torch.from_numpy(host).to(cuda_device)
    prog = [torch.from_numpy(a).to(cuda_device)
            for a in _programs(batch=True)]
    kw = dict(KW, valid_col=len(KERNEL_COLUMNS) if valid else -1)
    before = tk.policy_scan_batch_launches
    masks_k, rule_k, agg_k = tops.policy_scan_batch(cols, *prog, **kw)
    assert tk.policy_scan_batch_launches == before + 1
    masks_r, rule_r, agg_r = tref.policy_scan_batch_ref(cols, *prog, **kw)
    torch.cuda.synchronize()
    assert torch.equal(masks_k, masks_r)
    assert torch.equal(rule_k, rule_r)
    torch.testing.assert_close(agg_k, agg_r, rtol=1e-5, atol=1)
    for r in range(prog[0].shape[0]):
        before = tk.policy_scan_launches
        m1, a1 = tops.policy_scan(cols, prog[0][r], prog[1][r], prog[2][r],
                                  **kw)
        assert tk.policy_scan_launches == before + 1
        assert torch.equal(m1, masks_k[r])
        assert torch.equal(a1, agg_k[r])      # same kernel, same order
    with pytest.raises(ValueError):
        tops.policy_scan_batch(cols, *prog, use_kernel=False, **kw)
