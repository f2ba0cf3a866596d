"""decode_attention: the plain version against ``attention``'s direct path,
the op's refusals, and (marked ``cuda``) the CUDA kernel against the plain
version on the card.

On the CPU the plain version must equal ``models.components.attention`` at
one query position bit for bit (the same operations in the same order),
over GQA and MHA, the softcap, a sliding window over a ring cache, empty
slots and rows with every position masked: ``attention`` keeps its plain
path on the CPU, so the tests that hold the port against the JAX package
read as before.

On the card the kernel computes the same function with an online softmax
over tiles and splits, sums in other orders and f32 fused multiply-adds.
Tolerances: an f32 output within ``rtol=1e-5, atol=1e-5`` of the plain
version's (the scores are dot products of up to 256 f32 terms, then exp and
sums over up to 8,192 positions, each rounded at other places: errors of a
few 2^-24 of O(1) values); a bf16 output within one bf16 step of it
(``2^-7`` of the larger magnitude, plus 1e-6: the two f32 values may round
to neighbouring bf16 values). Two runs must agree bit for bit.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.models.components import attention


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode_attention kernel runs "
                    "only there")
    return torch.device("cuda")


def _kv_pos(L: int, pos: int, mask: str, device="cpu") -> torch.Tensor:
    """The decode step's positions of L cache slots at position ``pos``:
    ``full`` slots 0..pos hold positions 0..pos, the rest are empty (-1);
    ``ring`` a ring of L slots (slot i holds the latest position = i mod L,
    -1 before it is written); ``empty`` no slot written; ``cross`` every
    slot valid (cross-attention, q_pos past the end)."""
    idx = torch.arange(L, device=device)
    p = torch.tensor([pos], device=device)
    if mask == "ring":
        kv = p - torch.remainder(p - idx, L)
        return torch.where(kv >= 0, kv, -1)
    if mask == "empty":
        return torch.full((L,), -1, dtype=torch.int64, device=device)
    if mask == "cross":
        return idx
    return torch.where(idx <= p, idx, -1)


def _inputs(seed, B, H, K, hd, L, dtype, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, H, hd), generator=g)
    k = torch.randn((B, L, K, hd), generator=g)
    v = torch.randn((B, L, K, hd), generator=g)
    return tuple(t.to(device, dtype) for t in (q, k, v))


# B, H, K, hd, L, pos, mask, causal, window, softcap, dtype
CPU_CASES = [
    (2, 12, 2, 16, 40, 25, "full", True, 0, None, torch.float32),
    (2, 12, 2, 16, 40, 39, "full", True, 0, None, torch.bfloat16),
    (3, 4, 4, 8, 24, 10, "full", True, 0, None, torch.float32),      # MHA
    (2, 8, 2, 32, 64, 50, "full", True, 0, 30.0, torch.bfloat16),    # cap
    (2, 8, 2, 16, 32, 77, "ring", True, 20, None, torch.float32),    # window
    (2, 8, 1, 16, 32, 20, "ring", True, 4096, None, torch.bfloat16),
    (2, 6, 2, 16, 48, 47, "empty", True, 0, None, torch.float32),    # masked
    (2, 6, 2, 16, 48, 3, "full", True, 2, 50.0, torch.float32),
    (2, 16, 2, 16, 30, 30, "cross", False, 0, None, torch.bfloat16),
]


@pytest.mark.parametrize("case", CPU_CASES)
def test_plain_version_equals_attention_direct_path(case):
    B, H, K, hd, L, pos, mask, causal, window, cap, dtype = case
    q, k, v = _inputs(L + pos, B, H, K, hd, L, dtype)
    q_pos = torch.tensor([pos])
    kv_pos = _kv_pos(L, pos, mask)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    want = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_chunk=L, **kw)
    got = dref.decode_attention_ref(q, k, v, q_pos, kv_pos, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    if mask == "empty":
        assert not got.any()
    # the op on CPU tensors is the plain version
    assert not dops.takes(q, k, v)
    assert torch.equal(dops.decode_attention(q, k, v, q_pos, kv_pos, **kw),
                       want)


def test_plain_version_takes_head_dim_scale():
    """``scale`` stands for the whole head's 1 / sqrt(head_dim) where q and
    k hold a chunk of it (``attention(head_dim=...)``)."""
    q, k, v = _inputs(5, 2, 4, 2, 8, 12, torch.float32)
    q_pos, kv_pos = torch.tensor([9]), _kv_pos(12, 9, "full")
    want = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, head_dim=32,
                     kv_chunk=12)
    got = dref.decode_attention_ref(q, k, v, q_pos, kv_pos,
                                    scale=1.0 / math.sqrt(32))
    assert torch.equal(got, want)


def _bad(name):
    q, k, v = _inputs(1, 2, 4, 2, 16, 8, torch.bfloat16)
    if name == "float16 q":
        q = q.half()
    elif name == "float64 k and v":
        k, v = k.double(), v.double()
    elif name == "k and v dtypes differ":
        v = v.float()
    elif name == "two query positions":
        q = torch.cat([q, q], dim=1)
    elif name == "head_dim 12":
        q, k, v = (t[..., :12].contiguous() for t in (q, k, v))
    elif name == "head_dim 264":
        q, k, v = _inputs(1, 2, 4, 2, 264, 8, torch.bfloat16)
    elif name == "query heads not a multiple":
        q = q[:, :, :3].contiguous()
    elif name == "v shape":
        v = v[:, :4]
    elif name == "strides off 16 B":
        k = torch.randn(2, 8, 2, 20).to(torch.bfloat16)[..., 2:18]
    elif name == "q not contiguous":
        q = torch.randn(2, 1, 16, 4).to(torch.bfloat16).transpose(2, 3)
    return q, k, v


REFUSED = ["float16 q", "float64 k and v", "k and v dtypes differ",
           "two query positions", "head_dim 12", "head_dim 264",
           "query heads not a multiple", "v shape", "strides off 16 B",
           "q not contiguous"]


@pytest.mark.parametrize("name", REFUSED)
def test_op_refuses_what_the_kernel_does_not_take(name):
    """The refusals are the op's engagement condition: ``attention`` keeps
    its plain path for these, and the kernel's wrapper raises on them."""
    q, k, v = _bad(name)
    assert dk.refusal(q, k, v) is not None
    assert not dops.takes(q, k, v)
    with pytest.raises(ValueError, match="decode_attention"):
        dk.decode_attention_cuda(q, k, v, torch.tensor([3]),
                                 torch.arange(k.shape[1]))


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_positions():
    q, k, v = _inputs(2, 2, 4, 2, 16, 8, torch.bfloat16)
    assert dk.refusal(q, k, v) is None
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dk.decode_attention_cuda(q, k, v, torch.tensor([3]), torch.arange(8))
    with pytest.raises(ValueError, match="kv_pos"):
        dk.decode_attention_cuda(q, k, v, torch.tensor([3]), torch.arange(7))
    with pytest.raises(ValueError, match="q_pos"):
        dk.decode_attention_cuda(q, k, v, torch.tensor([3, 4]),
                                 torch.arange(8))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _close(got: torch.Tensor, want: torch.Tensor) -> bool:
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-6
    else:
        tol = 1e-5 + 1e-5 * w.abs()
    return bool(((g - w).abs() <= tol).all())


def _card_case(device, seed, B, G, K, hd, L, pos, mask, dtype, cap=None,
               window=0, causal=True, q_dtype=None):
    q, k, v = _inputs(seed, B, G * K, K, hd, L, dtype, device)
    if q_dtype is not None:
        q = q.to(q_dtype)
    q_pos = torch.tensor([pos], device=device)
    kv_pos = _kv_pos(L, pos, mask, device)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    got = dk.decode_attention_cuda(q, k, v, q_pos, kv_pos, **kw)
    again = dk.decode_attention_cuda(q, k, v, q_pos, kv_pos, **kw)
    want = dref.decode_attention_ref(q, k, v, q_pos, kv_pos, **kw)
    torch.cuda.synchronize()
    return got, again, want


def _sweep():
    """G x hd x L, each with its own mask, dtype, batch and softcap mixed
    over the three axes: full and ring masks, windows, empty slots; bf16
    and f32; B 4 with 2 KV heads (8 blocks: more than one split where L
    allows) or B 64 (one split)."""
    out = []
    for a, G in enumerate((1, 2, 6, 8)):
        for b, hd in enumerate((64, 128, 256)):
            for c, L in enumerate((16, 512, 4096, 8192)):
                mask = ("full", "ring", "full", "empty")[(a + b + c) % 4]
                pos = {"full": (L - 1, L // 3)[(a + c) % 2],
                       "ring": L + L // 3, "empty": L // 2}[mask]
                dtype = (torch.bfloat16, torch.float32)[(a + c) % 2]
                B = 64 if (a + b) % 3 == 0 and L <= 512 else 4
                cap = 50.0 if (b + c) % 3 == 0 else None
                window = L // 2 if mask == "ring" and a % 2 else 0
                out.append((G, hd, L, B, pos, mask, dtype, cap, window))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep())
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    G, hd, L, B, pos, mask, dtype, cap, window = case
    got, again, want = _card_case(cuda_device, G * hd + L, B, G, 2, hd, L,
                                  pos, mask, dtype, cap, window)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    assert _close(got, want), (got.float() - want.float()).abs().max()
    if mask == "empty":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [255, 383, 511])
def test_cuda_kernel_at_mixtral_decode_shape(cuda_device, pos):
    """mixtral-decode's shape (B 64, L 512, K 8, G 6, hd 128, bf16, a ring
    of 512 under a 4,096 window): one split, bit for bit twice."""
    got, again, want = _card_case(cuda_device, pos, 64, 6, 8, 128, 512, pos,
                                  "ring", torch.bfloat16, window=4096)
    assert dk.splits(64, 8, 6, 512, 128, torch.bfloat16) == 1
    assert torch.equal(got, again)
    assert _close(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
def test_cuda_splits_combine_and_head_groups(cuda_device):
    """More than one split (B 1, 8,192 positions) with the combine kernel
    counted; G 16 in two head groups; an f32 q over a bf16 cache; a row
    with every position masked through the combine."""
    assert dk.splits(1, 2, 4, 8192, 128, torch.bfloat16) > 1
    dk.reset_counters()
    got, again, want = _card_case(cuda_device, 1, 1, 4, 2, 128, 8192, 8191,
                                  "full", torch.bfloat16)
    assert (dk.decode_attention_launches,
            dk.decode_attention_combine_launches) == (2, 2)
    assert torch.equal(got, again) and _close(got, want)
    got, again, want = _card_case(cuda_device, 2, 2, 16, 1, 256, 1024, 700,
                                  "ring", torch.bfloat16, window=300)
    assert torch.equal(got, again) and _close(got, want)
    got, again, want = _card_case(cuda_device, 3, 4, 6, 2, 64, 300, 200,
                                  "full", torch.bfloat16,
                                  q_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, again) and _close(got, want)
    got, again, want = _card_case(cuda_device, 4, 1, 8, 1, 128, 4096, 100,
                                  "empty", torch.float32)
    assert not got.any() and not want.any()


@pytest.mark.cuda
def test_cuda_kernel_reads_the_cache_with_its_strides(cuda_device):
    """A cache view (a slice of a wider buffer's heads) is read as it lies."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    big = torch.randn((4, 256, 6, 64), generator=g, device=cuda_device
                      ).to(torch.bfloat16)
    k, v = big[:, :, 1:3], big[:, :, 3:5]
    q = torch.randn((4, 1, 8, 64), generator=g, device=cuda_device
                    ).to(torch.bfloat16)
    q_pos = torch.tensor([200], device=cuda_device)
    kv_pos = _kv_pos(256, 200, "full", cuda_device)
    got = dk.decode_attention_cuda(q, k, v, q_pos, kv_pos)
    want = dref.decode_attention_ref(q, k, v, q_pos, kv_pos)
    assert _close(got, want)


@pytest.mark.cuda
def test_cuda_attention_hands_decode_to_the_kernel(cuda_device):
    """``attention`` launches the kernel for one query position without
    ``scores``, and keeps the plain path for prefill and for ``scores``."""
    q, k, v = _inputs(6, 2, 8, 2, 64, 96, torch.bfloat16, cuda_device)
    kv_pos = torch.arange(96, device=cuda_device)
    q_pos = torch.tensor([95], device=cuda_device)
    dk.reset_counters()
    attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    assert dk.decode_attention_launches == 1
    attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, scores=lambda s: s)
    qq = torch.cat([q, q], dim=1)
    attention(qq, k, v, q_pos=torch.tensor([94, 95], device=cuda_device),
              kv_pos=kv_pos)
    assert dk.decode_attention_launches == 1


@pytest.mark.cuda
def test_cuda_graphed_mixtral_step_launches_once_a_layer(cuda_device):
    """The mixtral smoke configuration's graphed step: each replay adds one
    launch a layer (every layer attends) and reads nothing back."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import make_prefill, make_serve_step
    cfg = get_config("mixtral_8x22b", smoke=True)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Model(cfg).init(gen, cuda_device)
    B, P, n = 2, 20, 5
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                           device=cuda_device)
    step = make_serve_step(model)
    step.capture(B, P + 8)
    last, cache = make_prefill(model, P + 8)(prompt)
    nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    dk.reset_counters()
    for i in range(n):
        nxt, cache = step(cache, nxt, P + i)
    torch.cuda.synchronize()
    assert dk.decode_attention_launches == n * cfg.n_layers
