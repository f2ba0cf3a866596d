"""The policy-tiered KV cache: the port's ``TieredKvCache`` against the JAX
package's.

Both caches run the same operations on one counter clock each (a clock that
returns 1, 2, 3, ... so LRU order never rests on ties): the same pages are
released and restored in the same order, and the cold set, tier and
residency reports and every page's contents agree exactly (the payloads
are copied, never computed).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kvcache import PagePool, SequencePages, TieredKvCache


def _counter():
    c = itertools.count(1)
    return lambda: float(next(c))


def test_kv_tiering_watermark_and_restore():
    """``tests/test_system.py``'s tiering test, on the port (CPU pool)."""
    pool = PagePool(n_pages=8, page_size=4, n_kv=2, head_dim=8, device="cpu")
    tc = TieredKvCache(pool, high_wm=75.0, low_wm=40.0)
    tc.admit(1)
    tc.admit(2)
    k = np.ones((2, 8), np.float32)
    for t in range(24):          # 6 pages for seq 1
        tc.append_token(1, k * t, k * (t + 100))
    for t in range(16):          # 4 pages for seq 2 -> pool pressure
        tc.append_token(2, k * 50, k * 51)
    rep = tc.tier_report()
    assert rep["cold_pages"] > 0, "watermark eviction must have fired"
    # touching seq1 restores its pages with intact contents
    tc.page_table(1, 8)
    assert tc.restores > 0
    sp = tc.sequences[1]
    page0 = sp.page_ids[0]
    np.testing.assert_allclose(pool.k[page0, 1].numpy(), k * 1)   # t=1
    np.testing.assert_allclose(pool.v[page0, 3].numpy(), k * 103)
    # O(1) per-sequence residency stats
    r = tc.residency_report(1)
    assert r and r[0]["count"] == 6


def _script(rng, n_seqs=4, steps=90):
    """A seeded mix of the serving calls: admit, append_token, page_table
    + unpin, maybe_run_policies, finish."""
    ops = [("admit", s) for s in range(n_seqs)]
    live = set(range(n_seqs))
    for i in range(steps):
        s = int(rng.choice(sorted(live)))
        ops.append(("append", s, rng.standard_normal((2, 2, 8))
                    .astype(np.float32)))
        if i % 3 == 2:
            ops.append(("table", s, 8))
        if i % 7 == 6:
            ops.append(("policy",))
        if i == steps // 2:
            ops.append(("finish", 0))
            live.discard(0)
    ops += [("table", s, 8) for s in sorted(live)]
    return ops


def _drive(tc, ops):
    """Run ``ops``; returns the trace after each op: (op, releases so far,
    restores, sorted cold fids, pool used)."""
    released = []
    release = tc._release_page

    def recording_release(fid):
        ok = release(fid)
        released.append((fid, ok))
        return ok
    tc._release_page = recording_release
    trace = []
    for op in ops:
        if op[0] == "admit":
            tc.admit(op[1])
        elif op[0] == "append":
            tc.append_token(op[1], op[2][0], op[2][1])
        elif op[0] == "table":
            tc.page_table(op[1], op[2])
            tc.unpin()
        elif op[0] == "policy":
            tc.maybe_run_policies()
        else:
            tc.finish(op[1])
        trace.append((op[0], len(released), tc.restores,
                      sorted(tc.cold), tc.pool.used))
    return trace, released


def test_matches_reference_cache_op_for_op():
    pytest.importorskip("jax")
    from repro.kvcache import PagePool as RefPool
    from repro.kvcache import TieredKvCache as RefCache
    ops = _script(np.random.default_rng(11))
    ref = RefCache(RefPool(10, 4, 2, 8), 70.0, 40.0, clock=_counter())
    port = TieredKvCache(PagePool(10, 4, 2, 8, device="cpu"), 70.0, 40.0,
                         clock=_counter())
    ref_trace, ref_rel = _drive(ref, ops)
    port_trace, port_rel = _drive(port, ops)
    assert port_rel == ref_rel and any(ok for _, ok in ref_rel)
    assert port_trace == ref_trace
    assert ref.restores > 0 and port.tier_report() == ref.tier_report()
    assert port.page_bytes == ref.page_bytes
    for s in sorted(ref.sequences):
        assert port.residency_report(s) == ref.residency_report(s)
        a, b = port.sequences[s], ref.sequences[s]
        assert (a.page_ids, a.length) == (b.page_ids, b.length)
    for fid, (k, v) in ref.cold.items():
        np.testing.assert_array_equal(port.cold[fid][0], k)
        np.testing.assert_array_equal(port.cold[fid][1], v)
    np.testing.assert_array_equal(port.pool.k.numpy(), ref.pool.k)
    np.testing.assert_array_equal(port.pool.v.numpy(), ref.pool.v)


def test_page_pool_on_its_device():
    pool = PagePool(3, 4, 2, 8, device="cpu")
    assert pool.k.shape == (3, 4, 2, 8) and pool.k.is_contiguous()
    assert pool.k.dtype == torch.float32 and pool.device.type == "cpu"
    page = pool.alloc()
    k = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    pool.write_token(page, 1, k, -k)                # tensors
    pool.write_token(page, 2, k.numpy() + 1, k.numpy())   # numpy
    hk, hv = pool.read_page(page)
    assert isinstance(hk, np.ndarray) and hk.shape == (4, 2, 8)
    np.testing.assert_array_equal(hk[1], k.numpy())
    np.testing.assert_array_equal(hv[2], k.numpy())
    hk[1] = 7                                       # a copy, not a view
    assert pool.k[page, 1].equal(k)
    pool.free(page)
    assert pool.used == 0 and not pool.k.any() and not pool.v.any()
    pool.write_page(pool.alloc(), hk, hv)
    assert (pool.k[page, 1] == 7).all()
    assert pool.usage_pct == 100.0 / 3
    bf = PagePool(2, 4, 2, 8, dtype=torch.bfloat16, device="cpu")
    assert bf.k.dtype == bf.v.dtype == torch.bfloat16


def _bits(a) -> np.ndarray:
    """A bf16 array (numpy's ml_dtypes, a torch tensor or the int16 view
    the port's host tier holds) as its int16 bits."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def test_bf16_pages_match_reference_bit_for_bit():
    """bf16 pools in both packages: the same tokens written, pages released
    to the host and restored through ``TieredKvCache``; every page, hot or
    cold, has the same bits, and a page weighs 2 bytes an element."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kvcache import PagePool as RefPool
    from repro.kvcache import TieredKvCache as RefCache
    ops = _script(np.random.default_rng(12))
    ref = RefCache(RefPool(10, 4, 2, 8, dtype=jnp.bfloat16), 70.0, 40.0,
                   clock=_counter())
    port = TieredKvCache(PagePool(10, 4, 2, 8, dtype=torch.bfloat16,
                                  device="cpu"), 70.0, 40.0,
                         clock=_counter())
    assert ref.pool.k.dtype.name == "bfloat16"
    assert port.pool.k.dtype == torch.bfloat16
    ref_trace, ref_rel = _drive(ref, ops)
    port_trace, port_rel = _drive(port, ops)
    assert port_rel == ref_rel and any(ok for _, ok in ref_rel)
    assert port_trace == ref_trace
    assert ref.restores > 0 and port.restores == ref.restores
    assert port.page_bytes == ref.page_bytes == 4 * 2 * 8 * 2 * 2
    assert port.cold.keys() == ref.cold.keys() and ref.cold
    for fid, (k, v) in ref.cold.items():
        assert port.cold[fid][0].dtype == np.int16
        np.testing.assert_array_equal(port.cold[fid][0], _bits(k))
        np.testing.assert_array_equal(port.cold[fid][1], _bits(v))
    np.testing.assert_array_equal(_bits(port.pool.k), _bits(ref.pool.k))
    np.testing.assert_array_equal(_bits(port.pool.v), _bits(ref.pool.v))
    assert (_bits(port.pool.k) != 0).any()
    # any bits, out to the host and back, every bit kept
    pool = PagePool(2, 4, 2, 8, dtype=torch.bfloat16, device="cpu")
    page = pool.alloc()
    bits = np.random.default_rng(3).integers(-2**15, 2**15, (4, 2, 8))
    pool.write_page(page, bits.astype(np.int16), bits.astype(np.int16))
    hk, hv = pool.read_page(page)
    np.testing.assert_array_equal(hk, bits)
    np.testing.assert_array_equal(hv, bits)


def test_sequence_table():
    sp = SequencePages(3, page_ids=[5, 2])
    np.testing.assert_array_equal(sp.table(4), [5, 2, -1, -1])
