"""profile_cube: the port's op and plain version against the JAX package's.

The same numpy inputs, made from a seed, go through ``repro``'s
``profile_cube`` (the Pallas kernel in interpret mode off-TPU with
``use_kernel=True``, its scatter-add oracle with ``use_kernel=False``) and
through ``repro_torch``'s op on the CPU, in the raw layout (bucketized from
size and age) and the prebucketed one (``sb``/``ab`` rows). Sizes and blocks
stay below 2^13 so every per-cell sum is below 2^24 and exact in f32: the
cubes must be equal. The plain version on f64 columns is exact for the
integer values this path carries, which is the contract the CUDA kernel is
held to (equal to it after the cast to f32). Tests marked ``cuda`` hold the
kernel to the plain version on the card and skip where there is none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.profiles import age_buckets_np, size_buckets_np
from repro_torch.kernels.profile_cube import kernel as tk
from repro_torch.kernels.profile_cube import ops as tops
from repro_torch.kernels.profile_cube import ref as tref

CASES = [(0, 17, 3), (1, 100, 1), (2, 1024, 40), (3, 3000, 21)]
F32_EXACT = 1 << 24                 # f32 holds every integer below this


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profile_cube kernel runs only "
                    "there")
    return torch.device("cuda")


def _inputs(seed, n, b):
    """The reference kernel tests' inputs: f32-safe sizes and blocks."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, b, n)
    size = rng.integers(0, 1 << 13, n)
    blocks = rng.integers(0, 1 << 13, n)
    age = rng.uniform(-100, 400 * 86400, n)
    return gid, size, blocks, age


def _truth(gid, size, blocks, age, b, valid=None):
    """Exact int64 cube from the host bucket functions."""
    if valid is None:
        valid = np.ones(len(gid), np.int64)
    flat = (gid * 10 + size_buckets_np(size)) * 7 + age_buckets_np(age)
    out = np.zeros((3, b * 70), np.int64)
    for m, v in enumerate((valid, valid * size, valid * blocks)):
        np.add.at(out[m], flat, np.asarray(v, np.int64))
    return out.reshape(3, b, 10, 7)


def _jax_profile_cube():
    pytest.importorskip("jax")
    from repro.kernels.profile_cube.ops import profile_cube
    return profile_cube


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["jax_kernel", "jax_ref"])
@pytest.mark.parametrize("layout", ["raw", "prebucketed"])
@pytest.mark.parametrize("seed,n,b", CASES)
def test_profile_cube_matches_jax(seed, n, b, layout, use_kernel):
    jpc = _jax_profile_cube()
    gid, size, blocks, age = _inputs(seed, n, b)
    kw = {}
    if layout == "prebucketed":
        kw = dict(sb=size_buckets_np(size), ab=age_buckets_np(age))
    want = jpc(gid, size, blocks, age, n_groups=b, use_kernel=use_kernel,
               **kw)
    got = tops.profile_cube(gid, size, blocks, age, n_groups=b,
                            device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.rint(got).astype(np.int64),
                                  _truth(gid, size, blocks, age, b))


def test_profile_cube_valid_mask_and_edge_shapes():
    jpc = _jax_profile_cube()
    n = 50
    rng = np.random.default_rng(9)
    gid = rng.integers(0, 4, n)
    size = rng.integers(0, 1 << 10, n)
    valid = (np.arange(n) % 2 == 0).astype(np.float32)
    got = tops.profile_cube(gid, size, size, np.zeros(n), n_groups=4,
                            valid=valid, device="cpu")
    want = jpc(gid, size, size, np.zeros(n), n_groups=4, valid=valid,
               use_kernel=True)
    np.testing.assert_array_equal(got, want)
    assert got[0].sum() == valid.sum()
    # zero rows / zero groups: the reference's shapes
    for n_rows, b in ((0, 0), (0, 3), (5, 0)):
        z = np.zeros(n_rows)
        empty = tops.profile_cube(z, z, z, z, n_groups=b, device="cpu")
        ref = jpc(z, z, z, z, n_groups=b)
        assert empty.shape == ref.shape == (3, b, 10, 7)
        assert not empty.any()
    with pytest.raises(ValueError):
        tops.profile_cube(gid, size, size, np.zeros(n),
                          n_groups=tops.MAX_GROUPS + 1, device="cpu")


def test_out_of_range_gid_is_clipped_like_the_plain_reference():
    """Outside the contract, but pinned: the port clips gid into range in
    its plain version (and its kernel), as ``repro``'s ``ref.py`` does."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.profile_cube.ref import profile_cube_ref as jref
    host = np.array([[-3, 0, 2, 7], [5, 6, 7, 8], [1, 2, 3, 4],
                     [0, 10, 4000, 1e6]], np.float32)
    got = tref.profile_cube_ref(torch.from_numpy(host), 3)
    want = np.asarray(jref(jnp.asarray(host), 3))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_functions_match_jax_and_host():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.profile_cube import ref as jref
    sizes = np.array([0, 1, 31, 32, 1023, 1024, (1 << 20) - 1, 1 << 20,
                      1 << 30, 1 << 35, 1 << 40, 1 << 41, -1], np.float32)
    ages = np.array([-5, 0, 1, 3599, 3600, 86400, 7 * 86400, 30 * 86400,
                     90 * 86400, 365 * 86400, 4e9], np.float32)
    for tfn, jfn, hfn, x in (
            (tref.size_buckets, jref.size_buckets, size_buckets_np, sizes),
            (tref.age_buckets, jref.age_buckets, age_buckets_np, ages)):
        got = tfn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(x))))
        keep = x >= 0
        np.testing.assert_array_equal(got[keep], hfn(x[keep]))


@pytest.mark.parametrize("prebucketed", [False, True])
def test_f64_plain_version_is_exact_and_the_f32_one_within_rtol(prebucketed):
    """Per-cell sums far above 2^24: the f64 plain version equals the int64
    truth exactly; the f32 one rounds at every add, within rtol=1e-5."""
    rng = np.random.default_rng(11)
    n, b = 20_000, 3
    gid = rng.integers(0, b, n)
    size = rng.integers(0, 1 << 24, n) * 4096          # below 2^36
    blocks = rng.integers(0, 1 << 24, n) * 4096
    # integer ages, as f32 holds them (odd values above 2^24 round)
    age = rng.integers(-100, 400 * 86400, n).astype(np.float32) \
        .astype(np.float64)
    valid = (rng.integers(0, 64, n) > 0).astype(np.int64)
    rows = [gid, size, blocks, age]
    kw = dict(valid_col=4)
    if prebucketed:
        rows += [size_buckets_np(size), age_buckets_np(age)]
        kw = dict(valid_col=6, sb_col=4, ab_col=5)
    cols = torch.from_numpy(np.stack(rows + [valid]).astype(np.float32))
    f64 = tref.profile_cube_ref(cols.double(), b, **kw)
    f32 = tref.profile_cube_ref(cols, b, **kw)
    truth = _truth(gid, size, blocks, age, b, valid)
    assert f64.dtype == torch.float64 and f32.dtype == torch.float32
    np.testing.assert_array_equal(f64.numpy().astype(np.int64), truth)
    assert truth[1].max() > (1 << 24)
    torch.testing.assert_close(f32, f64.float(), rtol=1e-5, atol=0)
    # counts stay below 2^24: exact in both
    assert torch.equal(f32[0], f64[0].float())


def test_kernel_path_refuses_cpu():
    gid, size, blocks, age = _inputs(0, 17, 3)
    before = tk.profile_cube_launches
    with pytest.raises(ValueError):
        tops.profile_cube(gid, size, blocks, age, n_groups=3,
                          use_kernel=True, device="cpu")
    with pytest.raises(ValueError):
        tk.profile_cube_cuda(torch.zeros((5, 8)), n_groups=3, gid_col=0,
                             size_col=1, blocks_col=2, age_col=3,
                             valid_col=4, sb_col=-1, ab_col=-1)
    assert tk.profile_cube_launches == before


def test_build_paths_share_the_build_dir(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    from repro_torch.kernels.policy_scan import kernel as pk
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert tk.library_path().parent == pk.library_path().parent \
        == _build.build_dir()
    assert tk.library_path().name.startswith("libprofile_cube_")
    assert pk.library_path().name.startswith("libpolicy_scan_")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert tk.library_path().parent == tmp_path


# -- the banded order of work, on the CPU ---------------------------------

def _zipf(rng, n, b, s=1.1):
    """gid with p_g ~ (g + 1)^-s over [0, b): searchsorted on the CDF."""
    cdf = np.cumsum(np.arange(1, b + 1, dtype=np.float64) ** -s)
    return np.minimum(np.searchsorted(cdf / cdf[-1], rng.random(n),
                                      side="right"), b - 1)


def _cpu_cols(rng, n, b, prebucketed, gid=None, valid=None):
    gid, size, blocks, age = _inputs(int(rng.integers(1 << 30)), n, b) \
        if gid is None else (gid, *_inputs(0, n, b)[1:])
    rows = [gid, size, blocks, age]
    kw = dict(n_groups=b, valid_col=4)
    if prebucketed:
        rows += [size_buckets_np(size), age_buckets_np(age)]
        kw = dict(n_groups=b, valid_col=6, sb_col=4, ab_col=5)
    if valid is None:
        valid = rng.integers(0, 8, n) > 0
    return torch.from_numpy(np.stack(rows + [valid]).astype(np.float64)), kw


@pytest.mark.parametrize("prebucketed", [False, True])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 7])
def test_banded_ref_matches_plain_version_across_band_edges(b, prebucketed):
    """band = 3: B = 1, band - 1, band, band + 1 and 2 band + 1."""
    cols, kw = _cpu_cols(np.random.default_rng(b), 997, b, prebucketed)
    want = tref.profile_cube_ref(cols, **kw)
    got = tref.banded_cube_ref(cols, **kw, band=3)
    assert got.dtype == torch.float64
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["ragged", "all_invalid", "one_cell",
                                  "zipf", "out_of_range"])
def test_banded_ref_matches_plain_version_on_edge_inputs(case):
    rng = np.random.default_rng(5)
    n, b, band = 1001, 11, 3
    gid = valid = None
    if case == "ragged":
        n = 3 * 64 + 5
    elif case == "all_invalid":
        gid = rng.integers(-50, 5000, n)            # garbage, clipped
        valid = np.zeros(n)
    elif case == "zipf":
        gid = _zipf(rng, n, b)
    elif case == "out_of_range":
        gid = rng.integers(-3, b + 4, n)
    cols, kw = _cpu_cols(rng, n, b, True, gid=gid, valid=valid)
    if case == "one_cell":
        cols[0] = b - 1
        cols[4] = 3
        cols[5] = 2
    want = tref.profile_cube_ref(cols, **kw)
    got = tref.banded_cube_ref(cols, **kw, band=band)
    assert torch.equal(got, want)
    if case == "all_invalid":
        assert not got.any()
    if case == "one_cell":
        assert int((got[0] != 0).sum()) == 1


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["jax_kernel", "jax_ref"])
@pytest.mark.parametrize("layout", ["raw", "prebucketed"])
@pytest.mark.parametrize("seed,n,b", CASES)
def test_banded_ref_matches_jax(seed, n, b, layout, use_kernel):
    """The banded mirror on f32 columns (every cell sum below 2^24) against
    ``repro``'s ``profile_cube``, with a band narrower than B."""
    jpc = _jax_profile_cube()
    gid, size, blocks, age = _inputs(seed, n, b)
    kw, rows = {}, [gid, size, blocks, age]
    tkw = dict(n_groups=b, valid_col=-1)
    if layout == "prebucketed":
        kw = dict(sb=size_buckets_np(size), ab=age_buckets_np(age))
        rows += [kw["sb"], kw["ab"]]
        tkw.update(sb_col=4, ab_col=5)
    want = jpc(gid, size, blocks, age, n_groups=b, use_kernel=use_kernel,
               **kw)
    cols = torch.from_numpy(np.stack(rows).astype(np.float32))
    got = tref.banded_cube_ref(cols, **tkw, band=max(1, b // 3))
    np.testing.assert_array_equal(got.numpy(), want)


# -- on the card ------------------------------------------------------------

def _card_cols(rng, n, b, prebucketed, small, gids="uniform"):
    """Seeded columns: sizes/blocks below 2^11 (``small``) or multiples of
    4 KiB below 2^36, so every f64 sum is exact. ``gids``: "uniform";
    "zipf" (p_g ~ (g + 1)^-1.1); "hot" (every row in one cell, the last
    group); "fractional" (1 row in 16 has a size of k + 0.5, k < 2^11, an
    f64 side-cube row)."""
    unit = 1 if small else 4096
    hi = 1 << (11 if small else 24)
    gid = _zipf(rng, n, b) if gids == "zipf" else rng.integers(0, b, n)
    size = rng.integers(0, hi, n) * unit
    blocks = rng.integers(0, hi, n) * unit
    age = rng.integers(-100, 400 * 86400, n).astype(np.float32)
    if gids == "hot":
        gid[:] = b - 1
        size = ((1 << 10) + rng.integers(0, 32, n)) * unit   # one bucket
        age[:] = 100.0
    size = size.astype(np.float64)
    if gids == "fractional":
        odd = rng.integers(0, 16, n) == 0
        size[odd] = rng.integers(0, 1 << 11, int(odd.sum())) + 0.5
    valid = (rng.integers(0, 64, n) > 0)
    rows = [gid, size, blocks, age]
    kw = dict(n_groups=b, gid_col=0, size_col=1, blocks_col=2, age_col=3,
              valid_col=4, sb_col=-1, ab_col=-1)
    if prebucketed:
        rows += [size_buckets_np(size), age_buckets_np(age)]
        kw.update(valid_col=6, sb_col=4, ab_col=5)
    return np.stack(rows + [valid]).astype(np.float32), kw


# B at the edges of a block's private cube (band = tk.band_groups())
BAND_EDGES = {"band-1": (-1, 1), "band": (0, 1), "band+1": (1, 1),
              "2band+1": (1, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("gids", ["uniform", "zipf", "hot", "fractional"])
@pytest.mark.parametrize("prebucketed", [False, True])
@pytest.mark.parametrize("n,b", [(1, 1), (17, 3), (2049, 64), (100_003, 64),
                                 (100_003, 138), (100_003, 139),
                                 (300_007, 4096), (100_003, "band-1"),
                                 (100_003, "band"), (100_003, "band+1"),
                                 (300_007, "2band+1")])
def test_cuda_kernel_matches_plain_version(cuda_device, n, b, prebucketed,
                                           gids):
    if isinstance(b, str):
        plus, times = BAND_EDGES[b]
        b = times * tk.band_groups() + plus
    rng = np.random.default_rng(n + b)
    for small in (True, False):
        host, kw = _card_cols(rng, n, b, prebucketed, small, gids)
        cols = torch.from_numpy(host).to(cuda_device)
        before = tk.profile_cube_launches
        got = tk.profile_cube_cuda(cols, **kw)
        assert tk.profile_cube_launches == before + 1
        again = tk.profile_cube_cuda(cols, **kw)
        f64 = tref.profile_cube_ref(cols.double(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)            # reproducible
        assert torch.equal(got, f64.float())      # exact sums, one rounding
        assert int(got[0].double().sum()) == int(host[kw["valid_col"]].sum())
        if f64.max() < F32_EXACT:                 # exact in f32 as well
            assert torch.equal(got, tref.profile_cube_ref(cols, **kw))
    assert (tk.design(b) == "shared") == (b <= tk.band_groups())
    with pytest.raises(ValueError):
        tops.profile_cube(np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3),
                          n_groups=3, use_kernel=False, device=cuda_device)
