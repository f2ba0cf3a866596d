"""rwkv6_step: the port's plain version and op against the JAX package.

The same numpy inputs, made from a seed, go through ``repro``'s
``rwkv6_step_ref`` and its ``rwkv6_step`` op (the Pallas kernel, in
interpret mode off-TPU) and through ``repro_torch``'s plain version on the
CPU, at the reference sweep's shapes (``tests/kernels/test_kernels.py``).
The port's sequence form ``models.rwkv6.wkv_chunked`` is held to the
reference's and to the port's own step oracle ``wkv_ref``. Tolerances: f32
``rtol=1e-5`` with atol ``1e-5 * sum_i |r_i| (|S_ij| + |u_i k_i v_j|)`` for
y (one f32 sum of hd products, in another order) and ``rtol=atol=1e-6`` for
the state (two products and an add); bf16 vectors ``2e-2`` (y rounded to
bf16, 2^-8 apart near 1). Tests marked ``cuda`` hold the CUDA kernel to the
plain version on the card and skip where there is none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rwkv6_step import kernel as tk
from repro_torch.kernels.rwkv6_step import ops as tops
from repro_torch.kernels.rwkv6_step import ref as tref

SWEEP = [(1, 2, 16), (2, 4, 64), (4, 8, 32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rwkv6_step kernel runs only "
                    "there")
    return torch.device("cuda")


def _inputs(seed, B, H, hd):
    """The reference sweep's inputs: w uniform in [0.3, 1)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = mk(B, H, hd), mk(B, H, hd), mk(B, H, hd)
    w = rng.uniform(0.3, 1.0, (B, H, hd)).astype(np.float32)
    u, s0 = mk(H, hd), mk(B, H, hd, hd)
    return r, k, v, w, u, s0


def _torch(arrs, device="cpu", dtype=torch.float32):
    vecs = tuple(torch.from_numpy(a).to(device, dtype) for a in arrs[:5])
    return vecs + (torch.from_numpy(arrs[5]).to(device),)


def _y_atol(arrs) -> np.ndarray:
    """1e-5 * sum_i |r_i| (|S_ij| + |u_i k_i v_j|): the scale of y's sum."""
    r, k, v, _, u, s = (np.abs(a.astype(np.float64)) for a in arrs)
    kv = k[..., :, None] * v[..., None, :]
    return 1e-5 * np.einsum("bhi,bhij->bhj", r, s + u[None, :, :, None] * kv)


@pytest.mark.parametrize("shape", SWEEP)
def test_plain_version_matches_reference_and_pallas(shape):
    import jax.numpy as jnp
    from repro.kernels.rwkv6_step.ops import rwkv6_step
    from repro.kernels.rwkv6_step.ref import rwkv6_step_ref
    arrs = _inputs(shape[2], *shape)
    y, s = (t.numpy() for t in tref.rwkv6_step_ref(*_torch(arrs)))
    atol = _y_atol(arrs)
    for fn in (rwkv6_step_ref, rwkv6_step):
        yj, sj = (np.asarray(t) for t in fn(*(jnp.asarray(a) for a in arrs)))
        assert (np.abs(y - yj) <= atol + 1e-5 * np.abs(yj)).all()
        np.testing.assert_allclose(s, sj, rtol=1e-6, atol=1e-6)


def test_bf16_vectors_match_pallas():
    """bf16 r, k, v, w and u: y comes back bf16, as the Pallas kernel's."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6_step.ops import rwkv6_step
    arrs = _inputs(7, 2, 4, 32)
    y, s = tref.rwkv6_step_ref(*_torch(arrs, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    jv = [jnp.asarray(a, jnp.bfloat16) for a in arrs[:5]]
    yj, sj = rwkv6_step(*jv, jnp.asarray(arrs[5]))
    assert yj.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yj, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("S,chunk", [(16, 4), (64, 64), (20, 4)])
def test_wkv_chunked_matches_reference_and_step_oracle(S, chunk):
    """The chunked sequence form against the reference's (same chunk) and
    against the port's loop of decode steps, from a nonzero state."""
    import jax.numpy as jnp
    from repro.models.rwkv6 import wkv_chunked as jax_chunked
    from repro_torch.models.rwkv6 import wkv_chunked, wkv_ref
    B, H, hd = 2, 3, 8
    rng = np.random.default_rng(S)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    lw = (-np.exp(rng.standard_normal((B, S, H, hd)) - 2)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    arrs = (r, k, v, lw, u, s0)
    yj, sj = (np.asarray(t) for t in jax_chunked(
        *(jnp.asarray(a) for a in arrs), chunk=chunk))
    tv = tuple(torch.from_numpy(a) for a in arrs)
    y, s = wkv_chunked(*tv, chunk=chunk)
    yr, sr = wkv_ref(*tv)
    for want_y, want_s in ((yj, sj), (yr.numpy(), sr.numpy())):
        np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_last", [True, False])
def test_token_shift_and_ddlerp_match_reference(with_last):
    """bf16, as the model runs them: within 2^-6 max|out| (bf16 products
    rounded at other places)."""
    import jax.numpy as jnp
    from repro.models.rwkv6 import ddlerp as j_ddlerp
    from repro.models.rwkv6 import token_shift as j_shift
    from repro_torch.models.rwkv6 import ddlerp, token_shift
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    last = rng.standard_normal((2, 16)).astype(np.float32)
    mu = (rng.standard_normal(16) * 0.1).astype(np.float32)
    a = (rng.standard_normal((16, 4)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((4, 16)) * 0.3).astype(np.float32)
    J = lambda v: jnp.asarray(v, jnp.bfloat16)                 # noqa: E731
    T = lambda v: torch.from_numpy(v).to(torch.bfloat16)       # noqa: E731
    ws = j_shift(J(x), J(last) if with_last else None)
    gs = token_shift(T(x), T(last) if with_last else None)
    assert torch.equal(gs.float(), torch.from_numpy(
        np.asarray(ws, np.float32)))
    want = np.asarray(j_ddlerp(J(x), ws, J(mu), J(a), J(b)), np.float32)
    got = ddlerp(T(x), gs, T(mu), T(a), T(b)).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


def test_op_runs_plain_version_on_cpu_tensors():
    args = _torch(_inputs(1, 2, 4, 16))
    before = tk.rwkv6_step_launches
    want = tref.rwkv6_step_ref(*args)
    for got in (tops.rwkv6_step(*args),
                tops.rwkv6_step(*args, use_kernel=False)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        tops.rwkv6_step(*args, use_kernel=True)
    assert tk.rwkv6_step_launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _torch(_inputs(2, 1, 2, 8))
    before = tk.rwkv6_step_launches
    with pytest.raises(ValueError):
        tk.rwkv6_step_cuda(*args)
    with pytest.raises(TypeError):
        tk.rwkv6_step_cuda(args[0].numpy(), *args[1:])
    assert tk.rwkv6_step_launches == before


# -- on the card -----------------------------------------------------------


# the sweep; rwkv6-1.6b's head (hd 64) at a batch of 64; hd 256 (the
# limit), an odd hd, B = 1
CUDA_CASES = SWEEP + [(64, 32, 64), (2, 2, 256), (3, 5, 24), (1, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    arrs = _inputs(sum(case), *case)
    args = _torch(arrs, cuda_device)
    before = tk.rwkv6_step_launches
    y, s = tops.rwkv6_step(*args)
    y2, s2 = tk.rwkv6_step_cuda(*args)
    torch.cuda.synchronize()
    assert tk.rwkv6_step_launches == before + 2
    assert torch.equal(y, y2) and torch.equal(s, s2)
    yw, sw = tref.rwkv6_step_ref(*args)
    yw = yw.cpu().numpy()
    assert (np.abs(y.cpu().numpy() - yw)
            <= _y_atol(arrs) + 1e-5 * np.abs(yw)).all()
    np.testing.assert_allclose(s.cpu().numpy(), sw.cpu().numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_kernel_bf16_and_checks(cuda_device):
    arrs = _inputs(5, 2, 4, 64)
    args = _torch(arrs, cuda_device, torch.bfloat16)
    y, s = tk.rwkv6_step_cuda(*args)
    yw, sw = tref.rwkv6_step_ref(*args)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yw.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(s.cpu().numpy(), sw.cpu().numpy(), rtol=1e-6,
                               atol=1e-6)
    f32 = _torch(arrs, cuda_device)
    with pytest.raises(TypeError):
        tk.rwkv6_step_cuda(f32[0], args[1], *f32[2:])
    with pytest.raises(TypeError):
        tk.rwkv6_step_cuda(*f32[:5], f32[5].double())
    big = _torch(_inputs(6, 1, 1, 257), cuda_device)
    with pytest.raises(ValueError):
        tk.rwkv6_step_cuda(*big)
    with pytest.raises(ValueError):
        tops.rwkv6_step(*f32, use_kernel=False)
