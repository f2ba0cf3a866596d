"""rglru_scan: the port's plain version and op against the JAX package.

The same numpy inputs, made from a seed, go through ``repro``'s
``rglru_ref`` and its ``rglru_scan`` op (the Pallas kernel, in interpret
mode off-TPU) and through ``repro_torch``'s plain version on the CPU, at
the reference sweep's shapes (``tests/kernels/test_kernels.py``). Ragged
shapes, which the Pallas kernel refuses (``R % r_tile``, ``S % block_s``),
are held to ``rglru_ref``. The port's ``components.rglru_scan`` (the op,
walking time in order) is held to the reference's associative scan, which
folds ``h0`` into the first step. Tolerance ``rtol=1e-5, atol=1e-6``: the
same f32 recurrence, with exp from two libraries and, against the
associative scan, products in another order. Tests marked ``cuda`` hold
the CUDA kernel to the plain version on the card and skip where there is
none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru_scan import kernel as tk
from repro_torch.kernels.rglru_scan import ops as tops
from repro_torch.kernels.rglru_scan import ref as tref

SWEEP = [(1, 16, 128), (2, 64, 256), (3, 128, 128)]
# S = 20 at R = 64 (the smoke model's prefill), the decode step S = 1, a
# channel count that is no multiple of anything, no time steps
RAGGED = [(2, 20, 64), (3, 1, 64), (2, 37, 100), (1, 5, 1), (2, 0, 8)]
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rglru_scan kernel runs only "
                    "there")
    return torch.device("cuda")


def _inputs(seed, B, S, R):
    """The reference sweep's inputs: log_a = -0.2 |N(0, 1)|."""
    rng = np.random.default_rng(seed)
    la = (-np.abs(rng.standard_normal((B, S, R))) * 0.2).astype(np.float32)
    b = rng.standard_normal((B, S, R)).astype(np.float32)
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    return la, b, h0


def _torch(arrs, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


def _jax_ref(arrs):
    import jax.numpy as jnp
    from repro.kernels.rglru_scan.ref import rglru_ref
    return np.asarray(rglru_ref(*(jnp.asarray(a) for a in arrs)))


@pytest.mark.parametrize("shape", SWEEP)
def test_plain_version_matches_reference_and_pallas(shape):
    import jax.numpy as jnp
    from repro.kernels.rglru_scan.ops import rglru_scan
    arrs = _inputs(shape[1], *shape)
    got = tref.rglru_ref(*_torch(arrs)).numpy()
    np.testing.assert_allclose(got, _jax_ref(arrs), **TOL)
    pallas = np.asarray(rglru_scan(*(jnp.asarray(a) for a in arrs)))
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("shape", RAGGED)
def test_ragged_shapes_match_reference(shape):
    arrs = _inputs(sum(shape), *shape)
    got = tops.rglru_scan(*_torch(arrs))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_ref(arrs), **TOL)


def test_missing_h0_is_zeros():
    la, b, _ = _torch(_inputs(4, 2, 9, 16))
    assert torch.equal(tops.rglru_scan(la, b),
                       tops.rglru_scan(la, b, torch.zeros(2, 16)))


@pytest.mark.parametrize("with_h0", [True, False])
def test_component_matches_associative_scan(with_h0):
    """The port's model component (the op) against the reference model's
    associative scan, ``h0`` folded into its first step."""
    import jax.numpy as jnp
    from repro.models.components import rglru_scan as jax_scan
    from repro_torch.models.components import rglru_scan, rglru_step
    la, b, h0 = _inputs(11, 2, 20, 64)
    want = np.asarray(jax_scan(jnp.asarray(la), jnp.asarray(b),
                               jnp.asarray(h0) if with_h0 else None))
    tla, tb, th0 = _torch((la, b, h0))
    got = rglru_scan(tla, tb, th0 if with_h0 else None).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the decode step is the op with S = 1
    h = th0 if with_h0 else torch.zeros_like(th0)
    step = rglru_step(tla[:, 0], tb[:, 0], h).numpy()
    np.testing.assert_allclose(step, want[:, 0], **TOL)


def test_op_runs_plain_version_on_cpu_tensors():
    la, b, h0 = _torch(_inputs(1, 2, 16, 32))
    before = tk.rglru_scan_launches
    want = tref.rglru_ref(la, b, h0)
    assert torch.equal(tops.rglru_scan(la, b, h0), want)
    assert torch.equal(tops.rglru_scan(la, b, h0, use_kernel=False), want)
    with pytest.raises(ValueError):
        tops.rglru_scan(la, b, h0, use_kernel=True)
    assert tk.rglru_scan_launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    la, b, h0 = _torch(_inputs(2, 1, 4, 8))
    before = tk.rglru_scan_launches
    with pytest.raises(ValueError):
        tk.rglru_scan_cuda(la, b, h0)
    with pytest.raises(ValueError):
        tk.rglru_scan_cuda(la, b)
    with pytest.raises(TypeError):
        tk.rglru_scan_cuda(la.numpy(), b)
    assert tk.rglru_scan_launches == before


# -- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP + RAGGED + [(8, 300, 4096)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, with_h0):
    la, b, h0 = _torch(_inputs(sum(shape), *shape), cuda_device)
    h0 = h0 if with_h0 else None
    before = tk.rglru_scan_launches
    got = tops.rglru_scan(la, b, h0)
    again = tk.rglru_scan_cuda(la, b, h0)
    torch.cuda.synchronize()
    assert tk.rglru_scan_launches == before + (2 if la.numel() else 0)
    assert torch.equal(got, again)
    zeros = torch.zeros((shape[0], shape[2]), device=cuda_device)
    want = tref.rglru_ref(la, b, zeros if h0 is None else h0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_cuda_kernel_checks_its_inputs(cuda_device):
    la, b, h0 = _torch(_inputs(3, 2, 8, 16), cuda_device)
    with pytest.raises(TypeError):
        tk.rglru_scan_cuda(la.double(), b, h0)
    with pytest.raises(ValueError):
        tk.rglru_scan_cuda(la, b[:, :4].contiguous(), h0)
    with pytest.raises(ValueError):
        tk.rglru_scan_cuda(la, b, h0[:1].contiguous())
    with pytest.raises(ValueError):
        tk.rglru_scan_cuda(la.transpose(1, 2), b.transpose(1, 2), h0)
    with pytest.raises(ValueError):
        tops.rglru_scan(la, b, h0, use_kernel=False)
