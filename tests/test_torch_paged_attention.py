"""paged_attention: the port's plain version and op against the JAX package.

The same numpy inputs, made from a seed, go through ``repro``'s
``paged_attention_ref`` and its ``paged_attention`` op (the Pallas kernel,
in interpret mode off-TPU) and through ``repro_torch``'s plain version on
the CPU. Tolerances: f32 ``rtol=atol=1e-5`` (the same f32 math summed in
another order; the observed gap is below 1e-6), bf16 ``5e-2`` (the
reference test's; outputs are rounded to bf16, 2^-8 apart near 1). Tests
marked ``cuda`` hold the CUDA kernel to the plain version on the card and
skip where there is none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import kernel as tk
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import ref as tref

# (H, K, P): the reference sweep (tests/kernels/test_kernels.py) plus G = 7
SHAPES = [(8, 4, 16), (4, 4, 8), (8, 1, 32), (14, 2, 16)]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged_attention kernel runs "
                    "only there")
    return torch.device("cuda")


def _inputs(seed, H, K, P, B=2, hd=32, n_pages=16, max_pages=4):
    """The reference sweep's inputs: each sequence's pages drawn without
    replacement, its length ending somewhere in its last page."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, P, K, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, P, K, hd)).astype(np.float32)
    pt = np.full((B, max_pages), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.integers(1, max_pages + 1)
        pt[b, :n] = rng.choice(n_pages, n, replace=False)
        lens[b] = rng.integers((n - 1) * P + 1, n * P + 1)
    return q, kp, vp, pt, lens


def _edge_inputs(P=8, K=2, H=6, hd=24, n_pages=12, max_pages=4):
    """Four sequences: length 0, a -1 hole inside the length, a length that
    ends mid-page and one that ends on a page boundary."""
    q, kp, vp, _, _ = _inputs(5, H, K, P, B=4, hd=hd, n_pages=n_pages,
                              max_pages=max_pages)
    pt = np.array([[3, 7, -1, -1],
                   [1, -1, 9, 4],
                   [2, 8, 5, -1],
                   [11, 0, 6, 10]], np.int32)
    lens = np.array([0, 4 * P - 3, 2 * P + 3, 4 * P], np.int32)
    return q, kp, vp, pt, lens


def _torch(arrs, dtype, device="cpu"):
    q, kp, vp, pt, lens = arrs
    dt = getattr(torch, dtype)
    return (*(torch.from_numpy(a).to(device=device, dtype=dt)
              for a in (q, kp, vp)),
            torch.from_numpy(pt).to(device), torch.from_numpy(lens).to(device))


def _jax(arrs, dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    q, kp, vp, pt, lens = arrs
    dt = getattr(jnp, dtype)
    return (*(jnp.asarray(a, dt) for a in (q, kp, vp)), jnp.asarray(pt),
            jnp.asarray(lens))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hkp", SHAPES)
def test_plain_version_matches_reference(dtype, hkp):
    """Against ``repro``'s ``paged_attention_ref`` and its Pallas kernel
    (interpret mode)."""
    from repro.kernels.paged_attention.ops import paged_attention
    from repro.kernels.paged_attention.ref import paged_attention_ref
    arrs = _inputs(sum(hkp) * 7 + len(dtype), *hkp)
    got = _f32(tref.paged_attention_ref(*_torch(arrs, dtype)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    ja = _jax(arrs, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, _f32(paged_attention_ref(*ja)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _f32(paged_attention(*ja)), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_cases_match_reference(dtype):
    """Length 0 gives exact zeros (never NaN); a -1 hole is masked where
    pos < length; lengths mid-page and on a boundary; tolerance as the
    sweep's."""
    from repro.kernels.paged_attention.ops import paged_attention
    from repro.kernels.paged_attention.ref import paged_attention_ref
    arrs = _edge_inputs()
    got = tref.paged_attention_ref(*_torch(arrs, dtype))
    assert got.dtype == getattr(torch, dtype)
    got = _f32(got)
    assert np.isfinite(got).all()
    assert (got[0] == 0).all()
    ja = _jax(arrs, dtype)
    tol = TOL[dtype]
    for want in (paged_attention_ref(*ja), paged_attention(*ja)):
        np.testing.assert_allclose(got, _f32(want), rtol=tol, atol=tol)


def test_hole_is_masked_not_read():
    """The -1 hole reads nothing: sequence 1 equals the same pages with the
    hole dropped and the length cut by one page (f32, rtol 1e-6: the same
    positions summed in another grouping); pointing the hole at any page
    changes the result only when it is a real id."""
    q, kp, vp, pt, lens = _edge_inputs()
    P = kp.shape[1]
    hole = _f32(tref.paged_attention_ref(*_torch(
        (q[1:2], kp, vp, pt[1:2], lens[1:2]), "float32")))
    packed = np.array([[1, 9, 4, -1]], np.int32)
    want = _f32(tref.paged_attention_ref(*_torch(
        (q[1:2], kp, vp, packed, lens[1:2] - P), "float32")))
    np.testing.assert_allclose(hole, want, rtol=1e-6, atol=1e-7)
    filled = pt[1:2].copy()
    filled[0, 1] = 0
    other = _f32(tref.paged_attention_ref(*_torch(
        (q[1:2], kp, vp, filled, lens[1:2]), "float32")))
    assert not np.allclose(other, hole)


def _cut_inputs():
    """Sequence 0's scores all -1e31, sequence 1's all -0.7e30 (both at or
    below the reference's -0.5e30 cut), sequence 2's all +1e31 (one
    position wins: every score ties, so the output is the mean of V)."""
    H, K, P, hd = 4, 2, 4, 16
    kp = np.ones((3, P, K, hd), np.float32)
    vp = np.random.default_rng(9).standard_normal((3, P, K, hd)).astype(
        np.float32)
    root = np.sqrt(hd)
    q = np.stack([np.full((H, hd), s * root / hd, np.float32)
                  for s in (-1e31, -0.7e30, 1e31)])
    pt = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
    lens = np.array([6, 7, 5], np.int32)
    return q, kp, vp, pt, lens


def test_scores_at_or_below_the_cut_weigh_nothing():
    """A score at or below -0.5e30 weighs 0 even under the length, as in
    the reference: those sequences give exact zeros; equal huge scores
    average V (f32, rtol 1e-5)."""
    from repro.kernels.paged_attention.ref import paged_attention_ref
    arrs = _cut_inputs()
    got = _f32(tref.paged_attention_ref(*_torch(arrs, "float32")))
    want = _f32(paged_attention_ref(*_jax(arrs, "float32")))
    assert (got[:2] == 0).all() and (want[:2] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gqa_reads_kv_head_h_over_g():
    """Query head h reads KV head h // G (jnp.repeat interleaves): with
    V holding its KV head's index everywhere, every output is h // G."""
    H, K, P, hd = 8, 2, 4, 8
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((2, P, K, hd)).astype(np.float32)
    vp = np.broadcast_to(np.arange(K, dtype=np.float32)[None, None, :, None],
                         (2, P, K, hd)).copy()
    pt = np.array([[1, 0]], np.int32)
    out = _f32(tref.paged_attention_ref(*_torch(
        (q, kp, vp, pt, np.array([7], np.int32)), "float32")))
    want = np.repeat(np.arange(K, dtype=np.float32), H // K)
    np.testing.assert_allclose(out[0], np.repeat(want[:, None], hd, 1),
                               rtol=0, atol=1e-6)


def test_op_runs_plain_version_on_cpu_tensors():
    """Tables as numpy arrays or CPU tensors; no kernel launch."""
    arrs = _inputs(1, 8, 4, 16)
    q, kp, vp, pt, lens = _torch(arrs, "float32")
    before = tk.paged_attention_launches
    want = tref.paged_attention_ref(q, kp, vp, pt, lens)
    for table, length in ((pt, lens), (arrs[3], arrs[4])):
        got = tops.paged_attention(q, kp, vp, table, length)
        assert torch.equal(got, want)
    assert tops.paged_attention(q, kp, vp, pt, lens,
                                use_kernel=False).equal(want)
    assert tk.paged_attention_launches == before


def test_op_checks_its_inputs():
    arrs = _inputs(2, 4, 4, 8)
    q, kp, vp, pt, lens = _torch(arrs, "float32")
    with pytest.raises(ValueError):
        tops.paged_attention(q, kp, vp, pt, lens, use_kernel=True)
    bad = pt.clone()
    bad[0, 0] = kp.shape[0]
    with pytest.raises(ValueError):
        tops.paged_attention(q, kp, vp, bad, lens)
    bad[0, 0] = -2
    with pytest.raises(ValueError):
        tops.paged_attention(q, kp, vp, bad, lens)
    with pytest.raises(TypeError):
        tops.paged_attention(q, kp, vp, pt.float(), lens)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, kp, vp, pt, lens = _torch(_inputs(3, 4, 2, 8), "float32")
    before = tk.paged_attention_launches
    with pytest.raises(ValueError):
        tk.paged_attention_cuda(q, kp, vp, pt, lens)
    assert tk.paged_attention_launches == before


# -- on the card -----------------------------------------------------------


# (H, K, P, hd): the sweep; chatglm3-6b's and codeqwen1.5-7b's widths
# (64-row tiles, 64 KB of shared memory); G = 20 (two blocks a KV head);
# hd = 18 (no 16-byte loads), an odd page size, hd = 256
CUDA_CASES = [(*s, 32) for s in SHAPES] + [
    (32, 2, 64, 128), (32, 32, 64, 128), (40, 2, 8, 32), (6, 3, 5, 18),
    (4, 1, 16, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, case):
    """f32 ``rtol=1e-4`` with atol 1e-4 * max|v| (the reference test's
    kernel tolerance), bf16 5e-2, and each row within ROW_TOL of its size;
    the same call twice is bit-identical."""
    *hkp, hd = case
    arrs = _inputs(sum(case), *hkp, B=3, hd=hd, n_pages=16, max_pages=4)
    args = _torch(arrs, dtype, cuda_device)
    before = tk.paged_attention_launches
    got = tops.paged_attention(*args)
    again = tk.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert tk.paged_attention_launches == before + 2
    assert got.dtype == args[0].dtype and torch.equal(got, again)
    want = tref.paged_attention_ref(*args)
    tol = 1e-4 if dtype == "float32" else 5e-2
    atol = tol * float(args[2].float().abs().max())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=atol)
    _assert_rows_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_edge_cases(cuda_device, dtype):
    """Zeros for length 0; the hole sequence equal, bit for bit, to its
    packed table (the kernel skips the hole and walks the same rows in the
    same order); the rest within the sweep's tolerance."""
    arrs = _edge_inputs()
    args = _torch(arrs, dtype, cuda_device)
    got = tk.paged_attention_cuda(*args)
    want = tref.paged_attention_ref(*args)
    assert (got[0] == 0).all() and torch.isfinite(got.float()).all()
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                               atol=tol * float(args[2].float().abs().max()))
    P = args[1].shape[1]
    packed = torch.tensor([[1, 9, 4, -1]], dtype=torch.int32,
                          device=cuda_device)
    one = tk.paged_attention_cuda(args[0][1:2].contiguous(), args[1],
                                  args[2], packed, args[4][1:2] - P)
    assert torch.equal(got[1:2], one)


@pytest.mark.cuda
def test_cuda_kernel_applies_the_cut(cuda_device):
    args = _torch(_cut_inputs(), "float32", cuda_device)
    got = tk.paged_attention_cuda(*args)
    want = tref.paged_attention_ref(*args)
    assert (got[:2] == 0).all()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-6)


# -- the kernel's split of the page axis, in plain PyTorch -------------------

SPLITS = [1, 2, 3, 8]


def _split_plain(args, pages_per_split):
    return tref.combine_ref(tref.split_partials_ref(*args, pages_per_split),
                            args[0].dtype)


@pytest.mark.parametrize("pages_per_split", SPLITS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hkp", SHAPES)
def test_split_and_combine_match_reference(hkp, dtype, pages_per_split):
    """``split_partials_ref`` + ``combine_ref`` against ``repro``'s
    ``paged_attention_ref`` and the port's plain version, tolerance as the
    sweep's; tables 6 pages wide so most splits hold several pages and
    some none."""
    from repro.kernels.paged_attention.ref import paged_attention_ref
    arrs = _inputs(sum(hkp) + pages_per_split, *hkp, B=3, max_pages=6)
    args = _torch(arrs, dtype)
    got = _split_plain(args, pages_per_split)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(paged_attention_ref(
        *_jax(arrs, dtype))), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(tref.paged_attention_ref(
        *args)), rtol=tol, atol=tol)


def _boundary_hole(pages_per_split, P=8, K=2, H=6, hd=24, n_pages=16,
                   max_pages=12):
    """One sequence whose -1 hole sits right after its first
    ``pages_per_split`` readable pages (on a split boundary), and the same
    pages packed: (q, kp, vp, holed table, length, packed table, length)."""
    q, kp, vp, _, _ = _inputs(11, H, K, P, B=1, hd=hd, n_pages=n_pages,
                              max_pages=max_pages)
    pages = np.random.default_rng(pages_per_split).choice(
        n_pages, max_pages - 1, replace=False).astype(np.int32)
    holed = np.full((1, max_pages), -1, np.int32)
    holed[0, :pages_per_split] = pages[:pages_per_split]
    holed[0, pages_per_split + 1:] = pages[pages_per_split:]
    packed = np.full((1, max_pages), -1, np.int32)
    packed[0, :max_pages - 1] = pages
    length = np.array([max_pages * P - 3], np.int32)
    return q, kp, vp, holed, length, packed, length - P


@pytest.mark.parametrize("pages_per_split", SPLITS)
def test_split_hole_on_a_boundary_equals_packed(pages_per_split):
    """Splits count readable pages, not table slots: a hole on a split
    boundary and the same pages packed give the same partials and output,
    bit for bit."""
    q, kp, vp, holed, length, packed, packed_len = _boundary_hole(
        pages_per_split)
    a = _torch((q, kp, vp, holed, length), "float32")
    b = _torch((q, kp, vp, packed, packed_len), "float32")
    pa = tref.split_partials_ref(*a, pages_per_split)
    pb = tref.split_partials_ref(*b, pages_per_split)
    assert torch.equal(pa, pb)
    assert torch.equal(tref.combine_ref(pa), tref.combine_ref(pb))
    assert int((pa[0, 0, :, 1] > 0).sum()) == -(-(holed >= 0).sum()
                                                // pages_per_split)


@pytest.mark.parametrize("pages_per_split", SPLITS)
def test_split_alone_equals_its_row_in_a_batch(pages_per_split):
    """A sequence's partials and output do not depend on the batch."""
    q, kp, vp, pt, lens = _edge_inputs()
    batch = _torch((q, kp, vp, pt, lens), "float32")
    parts = tref.split_partials_ref(*batch, pages_per_split)
    out = tref.combine_ref(parts)
    for b in range(q.shape[0]):
        alone = _torch((q[b:b + 1], kp, vp, pt[b:b + 1], lens[b:b + 1]),
                       "float32")
        one = tref.split_partials_ref(*alone, pages_per_split)
        assert torch.equal(parts[b:b + 1], one)
        assert torch.equal(out[b:b + 1], tref.combine_ref(one))


@pytest.mark.parametrize("pages_per_split", SPLITS)
def test_split_empty_and_cut_sequences_give_zeros(pages_per_split):
    """The empty sequence's splits are all (-1e30, 0, 0) and it outputs
    exact zeros; so do sequences whose scores are all cut; equal huge
    scores still average V (f32, rtol 1e-5)."""
    edge = _torch(_edge_inputs(), "float32")
    parts = tref.split_partials_ref(*edge, pages_per_split)
    assert (parts[0, :, :, 0] == -1e30).all()
    assert (parts[0, :, :, 1:] == 0).all()
    assert (tref.combine_ref(parts)[0] == 0).all()
    cut = _torch(_cut_inputs(), "float32")
    got = _split_plain(cut, pages_per_split)
    assert (got[:2] == 0).all()
    np.testing.assert_allclose(_f32(got), _f32(tref.paged_attention_ref(
        *cut)), rtol=1e-5, atol=1e-6)


def test_split_slots_count_readable_pages():
    """Slots of each split, -1 past the readable pages; a page starting at
    or past the length and an id out of range are not readable."""
    pt = torch.tensor([[4, -1, 2, 7, 9, 1], [3, 5, -1, -1, -1, -1]],
                      dtype=torch.int32)
    lens = torch.tensor([5 * 4, 3], dtype=torch.int32)
    got = tref.split_slots(pt, lens, 9, 4, 2)
    want = [[[0, 2], [3, -1], [-1, -1]], [[0, -1], [-1, -1], [-1, -1]]]
    assert got.tolist() == want
    # ceil(max_pages / pages_per_split) splits, at least 1
    assert tref.split_slots(pt, lens, 9, 4, 8).shape[1] == 1
    assert tref.split_slots(pt[:, :0], lens, 9, 4, 8).shape[1] == 1
    assert tref.split_slots(pt, lens, 9, 4, 5).shape[1] == 2


# -- the split on the card ---------------------------------------------------


# each output row's relative L2 error: a limit scaled to the row's own size
# (bf16 outputs of long sequences are far smaller than the 5e-2 atol)
ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _assert_rows_close(got, want, dtype):
    g, w = _f32(got), _f32(want)
    diff = np.linalg.norm(g - w, axis=-1)
    size = np.linalg.norm(w, axis=-1)
    assert (diff <= ROW_TOL[dtype] * size).all(), \
        f"row relative L2 error {(diff / np.maximum(size, 1e-30)).max()}"


def _wide_inputs(seed, dtype, device, H=8, K=2, P=8, hd=32, B=3,
                 n_pages=96, max_pages=40):
    """Tables 40 pages wide (five splits of 8): every sequence's pages
    drawn without replacement, lengths across all splits."""
    arrs = _inputs(seed, H, K, P, B=B, hd=hd, n_pages=n_pages,
                   max_pages=max_pages)
    return _torch(arrs, dtype, device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_split_over_wide_tables(cuda_device, dtype):
    """S_max = 5: the combine runs; within the sweep's kernel tolerance of
    the plain version and each row within ROW_TOL of its size,
    bit-identical run to run, one op launch and one
    combine launch a call."""
    args = _wide_inputs(21, dtype, cuda_device)
    assert tk.n_splits(args[3].shape[1]) == 5
    calls, combines = (tk.paged_attention_launches,
                       tk.paged_attention_combine_launches)
    got = tk.paged_attention_cuda(*args)
    again = tk.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert tk.paged_attention_launches == calls + 2
    assert tk.paged_attention_combine_launches == combines + 2
    assert torch.equal(got, again)
    want = tref.paged_attention_ref(*args)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(
        _f32(got), _f32(want), rtol=tol,
        atol=tol * float(args[2].float().abs().max()))
    _assert_rows_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_split_hole_straddles_a_boundary(cuda_device, dtype):
    """A hole right after the first split's pages: equal, bit for bit, to
    the same pages packed; within the kernel tolerances of the plain
    version."""
    q, kp, vp, holed, length, packed, packed_len = _boundary_hole(
        tk.pages_per_split(), max_pages=40, n_pages=48)
    a = _torch((q, kp, vp, holed, length), dtype, cuda_device)
    b = _torch((q, kp, vp, packed, packed_len), dtype, cuda_device)
    got = tk.paged_attention_cuda(*a)
    assert torch.equal(got, tk.paged_attention_cuda(*b))
    want = tref.paged_attention_ref(*a)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(
        _f32(got), _f32(want), rtol=tol,
        atol=tol * float(a[2].float().abs().max()))
    _assert_rows_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_split_alone_equals_batch(cuda_device, dtype):
    """Each sequence run alone (B = 1) equals its row in the batch, bit for
    bit, over wide and narrow tables."""
    for args in (_wide_inputs(22, dtype, cuda_device),
                 _torch(_edge_inputs(), dtype, cuda_device)):
        got = tk.paged_attention_cuda(*args)
        for b in range(args[0].shape[0]):
            one = tk.paged_attention_cuda(
                args[0][b:b + 1].contiguous(), args[1], args[2],
                args[3][b:b + 1].contiguous(), args[4][b:b + 1].contiguous())
            assert torch.equal(got[b:b + 1], one)


@pytest.mark.cuda
def test_cuda_one_call_counts_one_launch(cuda_device):
    """One op call is one count, one split wide (no combine) or wider."""
    for args in (_torch(_inputs(4, 8, 2, 16), "float32", cuda_device),
                 _wide_inputs(23, "float32", cuda_device)):
        wide = tk.n_splits(args[3].shape[1]) > 1
        tk.reset_counters()
        tops.paged_attention(*args)
        torch.cuda.synchronize()
        assert tk.paged_attention_launches == 1
        assert tk.paged_attention_combine_launches == int(wide)


@pytest.mark.cuda
def test_cuda_refuses_tables_wider_than_the_combine_takes(cuda_device):
    """The combine keeps a weight a split in shared memory: at most
    MAX_SPLITS splits, so a wider table raises before any launch."""
    q, kp, vp, pt, lens = _torch(_inputs(6, 4, 2, 8), "float32", cuda_device)
    wide = torch.full((pt.shape[0], tk.MAX_SPLITS * tk.pages_per_split()
                       + 1), -1, dtype=torch.int32, device=cuda_device)
    before = tk.paged_attention_launches
    with pytest.raises(ValueError):
        tk.paged_attention_cuda(q, kp, vp, wide, lens)
    assert tk.paged_attention_launches == before
