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


# The ring kernels' shape in csrc/rglru_scan.cu: tiles of RING_STEPS time
# steps, rings of FWD_STAGES (forward) and BWD_STAGES (gradient) tiles; a
# shorter S, a width that is no multiple of 4 or an unaligned tensor takes
# the direct kernels. The sweep crosses each of those edges, a channel
# group's tail (R = 33, 100) and both rings' wrap.
RING_STEPS, FWD_STAGES, BWD_STAGES = 32, 6, 4
EDGE_R = [1, 31, 33, 100, 4096]
EDGE_S = [1, RING_STEPS - 1, RING_STEPS, RING_STEPS + 1,
          BWD_STAGES * RING_STEPS + 1, FWD_STAGES * RING_STEPS + 1, 2016]
EDGE_B = [1, 3]


def _grad_inputs(seed, B, S, R, device):
    """log_a, b, h0 of :func:`_inputs` and a standard normal gh."""
    la, b, h0 = _inputs(seed, B, S, R)
    gh = np.random.default_rng(seed + 1).standard_normal(
        (B, S, R)).astype(np.float32)
    return _torch((la, b, h0, gh), device)


@pytest.mark.cuda
def test_cuda_ring_shape_is_the_sweeps(cuda_device):
    fwd, bwd = tk.ring_shape(False), tk.ring_shape(True)
    assert (fwd["steps"], fwd["stages"], bwd["steps"], bwd["stages"]) == (
        RING_STEPS, FWD_STAGES, RING_STEPS, BWD_STAGES)
    assert fwd["blocks_per_sm"] >= 1 and bwd["blocks_per_sm"] >= 1
    assert tk.uses_ring(RING_STEPS, 4096)
    assert not tk.uses_ring(RING_STEPS - 1, 4096)
    assert tk.uses_ring(2016, 100) and not tk.uses_ring(2016, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("S", EDGE_S)
@pytest.mark.parametrize("R", EDGE_R)
def test_cuda_forward_bit_for_bit_at_every_edge(cuda_device, B, S, R):
    la, b, h0, _ = _grad_inputs(7 * B + S + R, B, S, R, cuda_device)
    for h0_arg in (h0, None):
        want = tref.rglru_ref(la, b, h0 if h0_arg is not None
                              else torch.zeros_like(h0))
        before = tk.rglru_scan_launches
        got = tk.rglru_scan_cuda(la, b, h0_arg)
        again = tk.rglru_scan_cuda(la, b, h0_arg)
        torch.cuda.synchronize()
        assert tk.rglru_scan_launches == before + 2
        assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("S", EDGE_S)
@pytest.mark.parametrize("R", EDGE_R)
def test_cuda_gradient_bit_for_bit_at_every_edge(cuda_device, B, S, R):
    la, b, h0, gh = _grad_inputs(5 * B + S + R, B, S, R, cuda_device)
    h = tref.rglru_ref(la, b, h0)
    for h0_arg in (h0, None):
        want = tref.rglru_bwd_ref(la, h, gh, h0 if h0_arg is not None
                                  else torch.zeros_like(h0))
        before = tk.rglru_scan_bwd_launches
        got = tk.rglru_scan_bwd_cuda(la, h, gh, h0_arg)
        again = tk.rglru_scan_bwd_cuda(la, h, gh, h0_arg)
        torch.cuda.synchronize()
        assert tk.rglru_scan_bwd_launches == before + 2
        for x, y, w in zip(got, again, want):
            assert torch.equal(x, w) and torch.equal(y, w)


@pytest.mark.cuda
def test_cuda_unaligned_tensors_take_the_direct_kernels(cuda_device):
    """Contiguous views that start 4 B past a 16 B boundary: 16 B copies
    cannot read them, so the launch takes the direct kernel, and the
    results are the same bits."""
    B, S, R = 2, 3 * RING_STEPS + 5, 64
    la, b, h0, gh = _grad_inputs(9, B, S, R, cuda_device)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 == 4
        return out

    assert tk.uses_ring(S, R)
    h = tref.rglru_ref(la, b, h0)
    got = tk.rglru_scan_cuda(shifted(la), shifted(b), h0)
    dgot = tk.rglru_scan_bwd_cuda(shifted(la), shifted(h), shifted(gh), h0)
    torch.cuda.synchronize()
    assert torch.equal(got, h)
    for x, w in zip(dgot, tref.rglru_bwd_ref(la, h, gh, h0)):
        assert torch.equal(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1, 4096), (2, 2 * RING_STEPS + 3, 100),
                                   (2, 300, 4096)])
def test_cuda_graph_replay_equals_eager_one_launch_a_call(cuda_device,
                                                          shape):
    """Forward and gradient captured into one CUDA graph (after an eager
    warm-up on a side stream, as ``GraphedServeStep`` captures): the
    capture records one launch of each, a replay adds one to each counter
    and gives the eager call's bits."""
    from repro_torch.kernels import _launches
    la, b, h0, gh = _grad_inputs(sum(shape), *shape, cuda_device)
    h_eager = tk.rglru_scan_cuda(la, b, h0)
    g_eager = tk.rglru_scan_bwd_cuda(la, h_eager, gh, h0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.rglru_scan_bwd_cuda(la, tk.rglru_scan_cuda(la, b, h0), gh, h0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = (tk.rglru_scan_launches, tk.rglru_scan_bwd_launches)
    with _launches.capturing() as tally:
        with torch.cuda.graph(graph):
            h = tk.rglru_scan_cuda(la, b, h0)
            g = tk.rglru_scan_bwd_cuda(la, h, gh, h0)
    assert dict(tally) == {(tk.__name__, "rglru_scan_launches"): 1,
                           (tk.__name__, "rglru_scan_bwd_launches"): 1}
    assert (tk.rglru_scan_launches, tk.rglru_scan_bwd_launches) == before
    for n in (1, 2):
        graph.replay()
        _launches.replayed(tally)
        torch.cuda.synchronize()
        assert (tk.rglru_scan_launches, tk.rglru_scan_bwd_launches) == (
            before[0] + n, before[1] + n)
        assert torch.equal(h, h_eager)
        for x, w in zip(g, g_eager):
            assert torch.equal(x, w)
