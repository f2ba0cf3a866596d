"""wkv_chunked: RWKV6's chunked sequence form, the plain version and op on
the CPU, the CUDA kernel on the card.

On the CPU: the op's plain path is ``ref.wkv_chunked_ref``, the chain
``models.rwkv6.wkv_chunked`` ran before the kernel, and the model's
``wkv_chunked`` goes through the op, so all three agree bit for bit; the
dispatch follows the device; the kernel wrapper's checks of kinds, shapes,
head widths and gradients raise before any device is touched; the op's
autograd function, its kernel forward stood in for by the plain version,
gives the plain version's gradients. Tests marked ``cuda`` hold the kernel
to the step oracle ``wkv_ref`` and to the plain chain on the card, within
the ``rtol=atol=1e-4`` of
``test_wkv_chunked_matches_reference_and_step_oracle`` (f32 sums of hd and
C products in another order, the exponentials by the SFU's ex2), its
gradients to the plain version's, take one rwkv6 training step, and skip
where there is no card.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.wkv_chunked import kernel as tk
from repro_torch.kernels.wkv_chunked import ops as tops
from repro_torch.kernels.wkv_chunked import ref as tref
from repro_torch.configs import get_config as torch_config
from repro_torch.models import Model
from repro_torch.models import rwkv6 as rk
from repro_torch.optim import AdamW
from repro_torch.train import init_train_state, make_train_step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wkv_chunked kernel runs only "
                    "there")
    return torch.device("cuda")


def _inputs(seed, B, S, H, hd, with_state=True):
    """The reference test's inputs: r, k, v and the start state N(0, 1),
    lw = -exp(N(0, 1) - 2), u 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    lw = (-np.exp(rng.standard_normal((B, S, H, hd)) - 2)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) \
        if with_state else None
    return r, k, v, lw, u, s0


def _torch(arrs, device="cpu"):
    return tuple(None if a is None else torch.from_numpy(a).to(device)
                 for a in arrs)


@pytest.mark.parametrize("S,chunk", [(16, 4), (64, 64), (20, 4), (128, 64),
                                     (100, 20)])
@pytest.mark.parametrize("with_state", [True, False])
def test_plain_path_equals_the_model_chain_bit_for_bit(S, chunk, with_state):
    args = _torch(_inputs(S, 2, S, 3, 8, with_state))
    before = tk.wkv_chunked_launches
    want = tref.wkv_chunked_ref(*args, chunk=chunk)
    for got in (tops.wkv_chunked(*args, chunk=chunk),
                tops.wkv_chunked(*args, chunk=chunk, use_kernel=False),
                rk.wkv_chunked(*args, chunk=chunk)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.wkv_chunked_launches == before


def test_dispatch_follows_the_device():
    args = _torch(_inputs(1, 1, 8, 2, 16))
    before = tk.wkv_chunked_launches
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA "
                       "tensors: the wkv_chunked kernel does not run on cpu"):
        tops.wkv_chunked(*args, chunk=8, use_kernel=True)
    assert tk.wkv_chunked_launches == before


def _bad(case):
    """A call of the kernel wrapper on CPU tensors with one fault."""
    r, k, v, lw, u, s0 = _torch(_inputs(2, 1, 8, 2, 16))
    if case == "not a tensor":
        return (r.numpy(), k, v, lw, u, s0)
    if case == "dims":
        return (r, k, v, lw, u[None], s0)
    if case == "dtype":
        return (r, k.double(), v, lw, u, s0)
    if case == "state dtype":
        return (r, k, v, lw, u, s0.double())
    if case == "contiguous":
        return (r, k, v.transpose(1, 2).contiguous().transpose(1, 2), lw, u,
                s0)
    if case == "shape":
        return (r, k, v[:, :4], lw, u, s0)
    if case == "head width":
        w = _torch(_inputs(2, 1, 8, 2, 32))
        return w
    if case == "u shape":
        return (r, k, v, lw, u[:1], s0)
    if case == "state shape":
        return (r, k, v, lw, u, s0[:, :1])
    if case == "grad":
        return (r.requires_grad_(), k, v, lw, u, s0)
    if case == "device":
        return (r, k, v, lw, u, s0)
    raise AssertionError(case)


@pytest.mark.parametrize("case,err,match", [
    ("not a tensor", TypeError, "r must be a tensor"),
    ("dims", ValueError, "u must have 2 dimensions"),
    ("dtype", TypeError, "k must be torch.float32"),
    ("state dtype", TypeError, "state must be torch.float32"),
    ("contiguous", ValueError, "v must be contiguous"),
    ("shape", ValueError, "v .* differs from r"),
    ("head width", ValueError, "head_dim 32"),
    ("u shape", ValueError, "u must be"),
    ("state shape", ValueError, "state must be"),
    ("grad", RuntimeError, "no backward"),
    ("device", ValueError, "takes CUDA tensors only")])
def test_kernel_wrapper_checks(case, err, match):
    args = _bad(case)
    before = tk.wkv_chunked_launches
    with pytest.raises(err, match=match):
        tk.wkv_chunked_cuda(*args)
    assert tk.wkv_chunked_launches == before


def test_grad_check_follows_the_grad_mode():
    """Under no_grad an input that requires a gradient records nothing,
    so the wrapper goes on to the device check."""
    args = _bad("grad")
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="takes CUDA tensors only"):
        tk.wkv_chunked_cuda(*args)


@pytest.mark.parametrize("S,want", [(4096, 64), (128, 64), (0, 64),
                                    (96, 32), (100, 4), (20, 4), (7, 1)])
def test_plain_chunk_divides_S(S, want):
    assert tops.plain_chunk(S) == want


@pytest.mark.parametrize("S", [20, 100])
def test_plain_path_tiles_a_ragged_S_itself(S):
    args = _torch(_inputs(S, 2, S, 3, 8))
    got = tops.wkv_chunked(*args)
    want = tref.wkv_chunked_ref(*args, chunk=4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _grads(outs, inputs, gy, gs):
    """The gradients of ``inputs`` that require one, of y . gy + state .
    gs."""
    pairs = [(o, g) for o, g in zip(outs, (gy, gs)) if o.requires_grad]
    return torch.autograd.grad(
        [o for o, _ in pairs],
        [t for t in inputs if t is not None and t.requires_grad],
        [g for _, g in pairs])


@pytest.mark.parametrize("S", [64, 100])
@pytest.mark.parametrize("needs", ["all", "r", "state", "no state"])
def test_autograd_function_gives_the_plain_gradients(monkeypatch, S, needs):
    """``WKVChunked`` with the plain version in the kernel's place: the
    gradients of the inputs that require one equal those of autograd
    through the plain version (the same graph, recomputed), the others
    get none."""
    def plain_forward(*a):
        return tref.wkv_chunked_ref(*a, chunk=tops.plain_chunk(S))
    monkeypatch.setattr(tops, "wkv_chunked_cuda", plain_forward)
    arrs = _inputs(S + 3, 2, S, 3, 8, with_state=needs != "no state")
    rng = np.random.default_rng(S)
    gy = torch.from_numpy(rng.standard_normal((2, S, 3, 8)).astype(
        np.float32))
    gs = torch.from_numpy(rng.standard_normal((2, 3, 8, 8)).astype(
        np.float32))
    grads = []
    for fn in (tops.WKVChunked.apply, plain_forward):
        args = list(_torch(arrs))
        for i, t in enumerate(args):
            if t is not None and (needs in ("all", "no state")
                                  or (needs, i) in (("r", 0), ("state", 5))):
                t.requires_grad_()
        grads.append(_grads(fn(*args), args, gy, gs))
    got, want = grads
    assert len(got) == len(want) == {"all": 6, "no state": 5}.get(needs, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- on the card -----------------------------------------------------------


def _card_case(device, seed, B, S, H, hd, with_state=True):
    arrs = _inputs(seed, B, S, H, hd, with_state)
    args = _torch(arrs, device)
    before = tk.wkv_chunked_launches
    y, s = tops.wkv_chunked(*args)
    y2, s2 = tk.wkv_chunked_cuda(*args)
    torch.cuda.synchronize()
    assert tk.wkv_chunked_launches == before + 2
    assert torch.equal(y, y2) and torch.equal(s, s2)
    return args, y, s


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S", [20, 64, 100, 4096])
@pytest.mark.parametrize("with_state", [True, False])
def test_cuda_kernel_matches_oracle_and_plain_chain(cuda_device, hd, S,
                                                    with_state):
    args, y, s = _card_case(cuda_device, S + hd, 2, S, 3, hd, with_state)
    with torch.no_grad():
        yr, sr = rk.wkv_ref(*args)
        yc, sc = tref.wkv_chunked_ref(*args, chunk=math.gcd(S, 64))
    for want_y, want_s in ((yr, sr), (yc, sc)):
        _close(y, want_y)
        _close(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4096, 32, 64), (256, 128, 32, 64)])
def test_cuda_kernel_at_the_cells_shapes(cuda_device, shape):
    """rwkv6-prefill's (8 x 4,096) and rwkv6-decode's prefill (256 x
    128), from a nonzero state."""
    args, y, s = _card_case(cuda_device, 7, *shape)
    with torch.no_grad():
        yr, sr = rk.wkv_ref(*args)
        _close(y, yr)
        _close(s, sr)
        del yr, sr
        yc, sc = tref.wkv_chunked_ref(*args)
        _close(y, yc)
        _close(s, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1, 2), (2, 32)])
def test_cuda_kernel_with_fewer_blocks_than_sms(cuda_device, B, H):
    """Few (b, h) pairs, a block each, against the step oracle."""
    args, y, s = _card_case(cuda_device, B * H, B, 200, H, 64)
    with torch.no_grad():
        yr, sr = rk.wkv_ref(*args)
    _close(y, yr)
    _close(s, sr)


@pytest.mark.cuda
def test_cuda_kernel_edges_and_checks(cuda_device):
    """S = 0 returns the start state; the kernel wrapper raises on a
    grad-requiring input while autograd records; non-f32 or misaligned
    inputs raise."""
    args = _torch(_inputs(9, 2, 0, 3, 64), cuda_device)
    y, s = tk.wkv_chunked_cuda(*args)
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 3, 64) and torch.equal(s, args[5])
    args = _torch(_inputs(9, 2, 70, 3, 64), cuda_device)
    before = tk.wkv_chunked_launches
    with pytest.raises(RuntimeError, match="no backward"):
        tk.wkv_chunked_cuda(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(TypeError):
        tk.wkv_chunked_cuda(args[0].half(), *args[1:])
    odd = torch.empty(args[0].numel() + 1, device=cuda_device)[1:]
    odd = odd.view(args[0].shape).copy_(args[0])
    with pytest.raises(ValueError, match="16 bytes"):
        tk.wkv_chunked_cuda(odd, *args[1:])
    with pytest.raises(ValueError):
        tops.wkv_chunked(*args, use_kernel=False)
    assert tk.wkv_chunked_launches == before
    with torch.no_grad():
        y, _ = tops.wkv_chunked(args[0].clone().requires_grad_(), *args[1:])
    assert tk.wkv_chunked_launches == before + 1


@pytest.mark.cuda
def test_cuda_launch_shape_two_blocks_an_sm(cuda_device):
    shape = tk.launch_shape(64)
    assert shape["threads"] == 256 and shape["chunk"] == 64
    assert shape["blocks_per_sm"] >= 2
    assert shape["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 100])
def test_cuda_op_gradient_matches_the_plain_version(cuda_device, S):
    """Through the op with every input requiring a gradient: one kernel
    launch forward, the plain version's gradients within the forward's
    tolerance (the backward recomputes the plain version)."""
    arrs = _inputs(S + 11, 2, S, 3, 64)
    rng = np.random.default_rng(S)
    gy = torch.from_numpy(rng.standard_normal((2, S, 3, 64)).astype(
        np.float32)).to(cuda_device)
    gs = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(
        np.float32)).to(cuda_device)
    got = []
    for fn in (tops.wkv_chunked, lambda *a: tref.wkv_chunked_ref(
            *a, chunk=tops.plain_chunk(S))):
        args = [t.requires_grad_() for t in _torch(arrs, cuda_device)]
        before = tk.wkv_chunked_launches
        outs = fn(*args)
        got.append((outs, _grads(outs, args, gy, gs),
                    tk.wkv_chunked_launches - before))
    torch.cuda.synchronize()
    (outs, grads, n), (outs_p, grads_p, n_p) = got
    assert (n, n_p) == (1, 0)
    for g, w in zip((*outs, *grads), (*outs_p, *grads_p)):
        _close(g.detach(), w.detach())


@pytest.mark.cuda
def test_cuda_rwkv6_train_step(cuda_device):
    """rwkv6 smoke (3 layers of hd 16), accum 2, a ragged S: each
    microbatch runs the kernel once a layer and again in the remat
    recompute; the loss and every updated parameter are finite."""
    model = Model(torch_config("rwkv6_1p6b", smoke=True), kv_chunk=8)
    opt = AdamW(lr=3e-3, weight_decay=0.01)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    state = init_train_state(model, opt, gen)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 2, 40))).to(
        cuda_device)
    before = tk.wkv_chunked_launches
    state, metrics = step(state, {"tokens": toks, "labels": toks})
    torch.cuda.synchronize()
    assert tk.wkv_chunked_launches - before == 3 * 2 * 2
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(p).all())
               for p in state["params"].values())
