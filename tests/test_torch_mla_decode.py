"""mla_decode: the plain version against the decode step's chain, the
kernel's split-and-combine order against one softmax, the op's refusals,
and (marked ``cuda``) the CUDA kernel against the plain version on the card.

On the CPU the plain version must equal the chain ``_mla_step_`` ran before
the kernel (scores into f32, the scale, -inf past the position over the
whole static length, an f32 softmax, the probabilities in the cache's
dtype times ``c_kv``) bit for bit, for bf16 and f32 caches.

The kernel's order (``_split_ref``: tiles of 64 positions,
an online softmax in the log2 domain, p rounded to bf16, splits merged in
order) and the kernel itself are held to an exact softmax in f64 over the
same operands. Tolerance: ``2^-7`` of the row's largest output, elementwise.
The output is bf16 (one rounding, 2^-9 of a value) and p is rounded to bf16
before the product in both the plain chain and the kernel (2^-9 of each
weight, which mostly cancels over the positions); the plain chain itself
stays within 2^-8 of a row's largest output here.
"""
import dataclasses
import math
from typing import List, Tuple

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mla_decode import kernel as mk
from repro_torch.kernels.mla_decode import ops as mops
from repro_torch.kernels.mla_decode import ref as mref

R, W = 512, 576                 # Kimi-K2's latent rank and cached width
SCALE = 192 ** -0.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mla_decode kernel runs only "
                    "there")
    return torch.device("cuda")


def _inputs(seed, B, H, L, dtype, device="cpu", width=W):
    g = torch.Generator().manual_seed(seed)
    qf = torch.randn((B, H, width), generator=g)
    lat = torch.randn((B, L, width), generator=g)
    return qf.to(device, dtype), lat.to(device, dtype)


def _chain(qf, lat, pos_t, scale, rank):
    """The decode step's plain chain as it stood before the kernel."""
    if qf.is_cuda and qf.dtype == lat.dtype == torch.bfloat16:
        s = torch.bmm(qf, lat.transpose(1, 2), out_dtype=torch.float32)
    else:
        s = qf.float() @ lat.transpose(1, 2).float()
    s = s * scale
    idx = torch.arange(lat.shape[1], device=qf.device)
    s = s.masked_fill(idx > pos_t, float("-inf"))
    return torch.bmm(torch.softmax(s, dim=-1).to(lat.dtype), lat[..., :rank])


def _exact(qf, lat, pos, scale=SCALE, rank=R):
    """Softmax attention in f64 over the same operands."""
    s = (qf.double() @ lat.double().transpose(1, 2)) * scale
    idx = torch.arange(lat.shape[1], device=qf.device)
    s = s.masked_fill(idx > pos, -math.inf)
    return torch.softmax(s, dim=-1) @ lat[..., :rank].double()


def _err(got, exact):
    """The largest error of each (b, h) row over that row's largest
    output."""
    d = (got.double() - exact).abs().amax(dim=-1)
    return (d / exact.abs().amax(dim=-1).clamp(min=1e-30)).max().item()


def _split_tiles(n_tiles: int, splits: int) -> List[Tuple[int, int]]:
    """The kernel's tiles [t0, t1) of each split, of ``n_tiles`` tiles
    holding a valid position: even shares, some empty past ``n_tiles``."""
    return [(s * n_tiles // splits, (s + 1) * n_tiles // splits)
            for s in range(splits)]


def _split_ref(qf: torch.Tensor, latent: torch.Tensor, pos: int,
               scale: float, rank: int, splits: int,
               tile: int = 64) -> torch.Tensor:
    """``ref.mla_decode_ref``'s function in the kernel's order, in f32 on
    any device: positions 0..pos (all L past the end) in tiles of
    ``tile``, each split's online softmax (max and sum in f32, log2
    domain, p rounded to bf16 for the product), the splits' sums merged in
    order. Returns (B, H, rank) bf16."""
    B, H, _ = qf.shape
    L = latent.shape[1]
    n = min(max(pos + 1, 0), L)
    q, lat = qf.float(), latent.float()
    c = scale * math.log2(math.e)
    parts = []
    for t0, t1 in _split_tiles(-(-n // tile), splits):
        if t0 == t1:
            continue
        m = torch.full((B, H), -math.inf, device=qf.device)
        l = torch.zeros((B, H), device=qf.device)
        acc = torch.zeros((B, H, rank), device=qf.device)
        for t in range(t0, t1):
            a, e = t * tile, min((t + 1) * tile, L)
            s = torch.einsum("bhw,bpw->bhp", q, lat[:, a:e]) * c
            s = s.masked_fill(torch.arange(a, e, device=qf.device) >= n,
                              -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhp,bpr->bhr", p.to(torch.bfloat16).float(),
                lat[:, a:e, :rank])
            m = m_new
        parts.append((acc, m, l))
    if not parts:
        return torch.zeros((B, H, rank), dtype=torch.bfloat16,
                           device=qf.device)
    M = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    num = torch.zeros((B, H, rank), device=qf.device)
    den = torch.zeros((B, H), device=qf.device)
    for acc, m, l in parts:
        w = torch.exp2(m - M)
        num = num + w[..., None] * acc
        den = den + w * l
    return (num / den[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("where", ["start", "middle", "end", "past"])
def test_plain_version_equals_the_step_chain(dtype, where):
    L = 200
    pos = {"start": 0, "middle": 97, "end": L - 1, "past": L + 30}[where]
    qf, lat = _inputs(len(where), 2, 8, L, dtype)
    pos_t = torch.tensor(pos)
    got = mref.mla_decode_ref(qf, lat, pos_t, SCALE, R)
    assert got.dtype == dtype and got.shape == (2, 8, R)
    assert torch.equal(got, _chain(qf, lat, pos_t, SCALE, R))
    assert _err(got, _exact(qf, lat, pos)) <= 2.0 ** -7


def test_plain_version_takes_a_one_element_position():
    qf, lat = _inputs(3, 1, 4, 40, torch.float32)
    assert torch.equal(
        mref.mla_decode_ref(qf, lat, torch.tensor([17]), SCALE, R),
        mref.mla_decode_ref(qf, lat, torch.tensor(17), SCALE, R))


@pytest.mark.parametrize("tiles,splits", [(1, 1), (5, 1), (5, 2), (7, 3),
                                          (3, 5), (2, 7)])
def test_split_tiles_cover_every_tile_once(tiles, splits):
    bounds = _split_tiles(tiles, splits)
    assert len(bounds) == splits
    assert [t for a, b in bounds for t in range(a, b)] == list(range(tiles))
    sizes = [b - a for a, b in bounds]
    assert max(sizes) - min(sizes) <= 1


# L, pos, splits: uneven splits, splits left empty by pos, a ragged last
# tile, the cache's end, a position past it
SPLIT_CASES = [(300, 299, 1), (300, 299, 3), (300, 150, 4), (300, 40, 5),
               (300, 0, 7), (200, 230, 2), (513, 512, 6)]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_and_combine_order_against_one_softmax(case):
    L, pos, splits = case
    qf, lat = _inputs(L + pos + splits, 2, 8, L, torch.bfloat16)
    got = _split_ref(qf, lat, pos, SCALE, R, splits)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    exact = _exact(qf, lat, pos)
    assert _err(got, exact) <= 2.0 ** -7
    plain = mref.mla_decode_ref(qf, lat, torch.tensor(pos), SCALE, R)
    assert _err(plain, exact) <= 2.0 ** -7


def test_split_order_with_one_split_a_tile_equals_one_split():
    """Splits only regroup the tiles' sums: one split a tile and one split
    over all of them agree to f32 rounding before the bf16 output."""
    qf, lat = _inputs(11, 1, 4, 256, torch.float32)
    a = _split_ref(qf, lat, 255, SCALE, R, 1).float()
    b = _split_ref(qf, lat, 255, SCALE, R, 4).float()
    assert ((a - b).abs() <= 2.0 ** -8 * a.abs().amax()).all()


def _bad(name):
    qf, lat = _inputs(1, 2, 64, 16, torch.bfloat16)
    rank = R
    if name == "float32 cache":
        lat = lat.float()
    elif name == "float32 qf":
        qf = qf.float()
    elif name == "32 heads":
        qf = qf[:, :32].contiguous()
    elif name == "96 heads":
        qf = torch.cat([qf, qf[:, :32]], dim=1)
    elif name == "rank 448":
        rank = 448
    elif name == "width 520":
        qf, lat = _inputs(1, 2, 64, 16, torch.bfloat16, width=520)
    elif name == "batch differs":
        lat = lat[:1]
    elif name == "cache strides off 16 B":
        lat = torch.randn(2, 16, W + 4).to(torch.bfloat16)[..., 2:W + 2]
    elif name == "cache last dim strided":
        lat = torch.randn(2, W, 16).to(torch.bfloat16).transpose(1, 2)
    elif name == "qf not contiguous":
        qf = torch.randn(2, W, 64).to(torch.bfloat16).transpose(1, 2)
    elif name == "no positions":
        lat = lat[:, :0]
    return qf, lat, rank


REFUSED = ["float32 cache", "float32 qf", "32 heads", "96 heads", "rank 448",
           "width 520", "batch differs", "cache strides off 16 B",
           "cache last dim strided", "qf not contiguous", "no positions"]


@pytest.mark.parametrize("name", REFUSED)
def test_op_refuses_what_the_kernel_does_not_take(name):
    """The refusals are the op's engagement condition: ``_mla_step_``
    keeps the plain chain for these, and the kernel's wrapper raises."""
    qf, lat, rank = _bad(name)
    assert mk.refusal(qf, lat, rank) is not None
    assert not mops.takes(qf, lat, rank)
    with pytest.raises(ValueError, match="mla_decode"):
        mk.mla_decode_cuda(qf, lat, torch.tensor(3), SCALE, rank)


def test_op_takes_no_cpu_tensors_and_wrapper_refuses_them():
    qf, lat = _inputs(2, 2, 128, 16, torch.bfloat16)
    assert mk.refusal(qf, lat, R) is None
    assert not mops.takes(qf, lat, R)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mk.mla_decode_cuda(qf, lat, torch.tensor(3), SCALE, R)
    with pytest.raises(ValueError, match="pos_t"):
        mk.mla_decode_cuda(qf, lat, torch.tensor([3, 4]), SCALE, R)
    with pytest.raises(ValueError, match="pos_t"):
        mk.mla_decode_cuda(qf, lat, torch.tensor(3.0), SCALE, R)
    # the op keeps the plain version for CPU tensors
    pos_t = torch.tensor(9)
    assert torch.equal(mops.mla_decode(qf, lat, pos_t, SCALE, R),
                       mref.mla_decode_ref(qf, lat, pos_t, SCALE, R))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card(device, seed, B, H, L, pos, lat=None):
    qf, lat0 = _inputs(seed, B, H, L, torch.bfloat16, device)
    lat = lat0 if lat is None else lat
    pos_t = torch.tensor(pos, device=device)
    got = mk.mla_decode_cuda(qf, lat, pos_t, SCALE, R)
    again = mk.mla_decode_cuda(qf, lat, pos_t, SCALE, R)
    plain = _chain(qf, lat, pos_t, SCALE, R)
    torch.cuda.synchronize()
    return got, again, plain, _exact(qf, lat, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [4095, 4351, 4607])
def test_cuda_kernel_at_kimi_decode_shape(cuda_device, pos):
    """kimi-k2-decode's shape: B 32, H 64, the 4,608-position cache."""
    got, again, plain, exact = _card(cuda_device, pos, 32, 64, 4608, pos)
    assert got.dtype == torch.bfloat16 and got.shape == (32, 64, R)
    assert torch.equal(got, again)
    assert _err(plain, exact) <= 2.0 ** -7
    assert _err(got, exact) <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 100, 2000, 4607, 5000])
def test_cuda_one_sequence_many_splits(cuda_device, pos):
    """B 1: a split a tile or more, most left empty at small positions,
    the combine merging them; 128 heads in two head groups."""
    assert mk.splits(1, 128, 4608) > 1
    mk.reset_counters()
    got, again, plain, exact = _card(cuda_device, 7 + pos, 1, 128, 4608,
                                     pos)
    assert (mk.mla_decode_launches, mk.mla_decode_combine_launches) == (2, 2)
    assert torch.equal(got, again)
    assert _err(got, exact) <= 2.0 ** -7


@pytest.mark.cuda
def test_cuda_kernel_reads_the_cache_with_its_strides(cuda_device):
    """A cache view (every other sequence of a wider buffer, its rows
    padded) is read as it lies."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    big = torch.randn((8, 700, 640), generator=g, device=cuda_device
                      ).to(torch.bfloat16)
    lat = big[::2, 50:, :W]
    assert not lat.is_contiguous() and mk.refusal(
        torch.empty((4, 64, W), dtype=torch.bfloat16), lat, R) is None
    got, _, plain, exact = _card(cuda_device, 3, 4, 64, 650, 600, lat=lat)
    assert _err(got, exact) <= 2.0 ** -7
    assert _err(plain, exact) <= 2.0 ** -7


def _mla_cfg():
    """Two latent-attention layers at Kimi-K2's latent widths (64 heads,
    rank 512, rotary 64), the rest small."""
    from repro_torch.configs.kimi_k2 import SMOKE
    from repro_torch.models.config import (ATTN_MLA, FFN_DENSE, LayerSpec,
                                           MlaSpec)
    spec = LayerSpec(mix=ATTN_MLA, ffn=FFN_DENSE)
    return dataclasses.replace(
        SMOKE, name="mla_decode_test", n_layers=2, d_model=256, n_heads=64,
        n_kv=64, head_dim=96, d_ff=256, vocab=512, lead=(spec,),
        pattern=(spec,),
        mla=MlaSpec(q_lora_rank=128, kv_lora_rank=512, qk_nope_head_dim=32,
                    qk_rope_head_dim=64, v_head_dim=32))


def _exact_attend(qf, lat, pos_t, scale, rank):
    """The plain version's function in f64 (the exact step)."""
    return _exact(qf, lat, pos_t.reshape(()), scale, rank).to(lat.dtype)


@pytest.mark.cuda
def test_cuda_graphed_mla_step_against_the_plain_step(cuda_device,
                                                      monkeypatch):
    """A graphed two-layer step through the kernel against the same graphed
    step on the plain chain, over replays at advancing positions fed the
    same tokens: each one's logits against the graphed step with the
    attention in f64, the kernel's path no farther than twice the plain
    chain's (both round the attention to bf16 and carry it through the
    layers and the cache); one launch of each kernel a layer a replay,
    none in the plain steps."""
    from repro_torch.models import Model
    from repro_torch.serve import make_prefill, make_serve_step
    cfg = _mla_cfg()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Model(cfg).init(gen, cuda_device)
    B, P, n, L = 4, 700, 6, 1024
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                           device=cuda_device)
    feed = torch.randint(0, cfg.vocab, (n, B, 1), generator=gen,
                         device=cuda_device).to(torch.int32)

    def graphed():
        """The logits of n replays, and the launches they counted."""
        step = make_serve_step(model)
        step.capture(B, L)
        _, cache = make_prefill(model, L)(prompt)
        mk.reset_counters()
        out = []
        for i in range(n):
            step(cache, feed[i], P + i)
            out.append(step.logits.float().clone())
        torch.cuda.synchronize()
        return out, (mk.mla_decode_launches, mk.mla_decode_combine_launches)
    kernel, launches = graphed()
    assert launches == (n * 2, n * 2)
    monkeypatch.setattr(mops, "takes", lambda *a: False)
    plain, launches = graphed()
    assert launches == (0, 0)
    monkeypatch.setattr(mref, "mla_decode_ref", _exact_attend)
    exact, _ = graphed()
    err_k = max((g - x).abs().max().item() for g, x in zip(kernel, exact))
    err_p = max((p - x).abs().max().item() for p, x in zip(plain, exact))
    scale = max(x.abs().max().item() for x in exact)
    assert err_k <= 2 * err_p + 1e-3 * scale, (err_k, err_p, scale)
