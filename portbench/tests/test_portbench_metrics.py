"""The benchmark's arithmetic on synthetic inputs: device busy time is
the union of the operations' intervals, percentiles are over every
sample, and each reader reads what is there or nothing."""
import statistics

import pytest

from portbench import stats
from portbench.count import PEAK_HBM_BYTES_PER_S
from portbench.count.rwkv6 import rwkv6_step_bytes
from portbench.harness import Window, load_config
from portbench.metrics import Run, reader
from portbench import count, traffic


def test_overlapping_operations_count_once():
    ops = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.8), (5.0, 6.0)]
    assert stats.union(ops) == [(0.0, 3.0), (5.0, 6.0)]
    assert stats.covered(ops, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.covered(ops, 1.0, 5.5) == pytest.approx(2.5)
    # summing durations would read 4.3 + 1 = 5.3 s busy
    assert sum(e - s for s, e in ops) == pytest.approx(5.3)
    assert stats.gaps(ops, 0.0, 7.0) == [(3.0, 5.0), (6.0, 7.0)]
    assert stats.gaps(ops, -1.0, 1.0) == [(-1.0, 0.0)]


def test_percentile_is_over_every_sample():
    xs = [1.0] * 90 + [10.0] * 10
    chunks = [xs[i:i + 10] for i in range(0, 100, 10)]
    of_medians = statistics.median(stats.percentile(c, 95) for c in chunks)
    assert of_medians == 1.0                       # hides the tail
    assert stats.percentile(xs, 95) == 10.0
    assert stats.percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.5
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_quartile_spread():
    assert stats.quartile_spread([10.0] * 6) == 0.0
    xs = [9.0, 10.0, 10.0, 10.0, 10.0, 11.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.quartile_spread(xs) == pytest.approx((q3 - q1) / q2)


def _run(cell_traffic="reasoning-b256-p128-g1024", **window):
    cfg = load_config("rwkv6-1.6b")
    w = Window(prefill_batch=512, prefill_len=128, **window)
    return Run(config=cfg, traffic=traffic.load(cell_traffic),
               count=count.family("rwkv6"), setup_s=12.5, window=w)


def test_readers_read_the_window():
    run = _run(seconds=2.0, gen_tokens=4096, prompt_tokens=65536,
               prefills=1, steps=7, step_s=[0.01] * 19 + [0.03],
               step_pos=list(range(128, 148)), prefill_s=[1.5, 2.5])
    assert reader("setup_s").read(run) == 12.5
    assert reader("gen_tokens_per_s").read(run) == 2048.0
    assert reader("prompt_tokens_per_s").read(run) == 32768.0
    assert reader("itl_p95_ms").read(run) == pytest.approx(
        stats.percentile(run.window.step_s, 95) * 1e3)
    assert reader("decode_step_ms").read(run) == pytest.approx(10.0)
    assert reader("prefill_ms").read(run) == pytest.approx(2000.0)
    c = count.family("rwkv6")
    flops = sum(c.decode_flops(run.config, 512, p) for p in range(128, 148))
    assert reader("mfu.decode").read(run) == pytest.approx(
        100 * flops / (0.22 * 989e12))
    least = sum(max(c.decode_flops(run.config, 512, p) / 989e12,
                    c.decode_bytes(run.config, 512, p) / 3.35e12)
                for p in range(128, 148))
    assert reader("roofline.decode").read(run) == pytest.approx(
        100 * least / 0.22)
    assert reader("mfu.prefill").read(run) == pytest.approx(
        100 * 2 * c.prefill_flops(run.config, 512, 128) / (4.0 * 989e12))


def test_readers_with_nothing_to_read_return_nothing():
    run = _run()
    for name in ("gen_tokens_per_s", "itl_p95_ms", "prompt_tokens_per_s",
                 "decode_step_ms", "prefill_ms", "mfu.decode", "mfu.prefill",
                 "roofline.decode", "rwkv6_step_roofline",
                 "idle_share.decode", "idle_share.prefill"):
        assert reader(name).read(run) is None, name


def test_trace_readers():
    ops = {"void rwkv6_step_kernel<float>(...)": (24 * 0.0005, 24),
           "nvjet_gemm": (0.004, 100)}
    trace = {"busy_s": 0.18, "window_s": 0.3, "ops": ops}
    # the trace alone: busy 0.18 s of a 0.3 s traced window; the host's
    # untraced steps do not enter
    run = _run(trace=trace, step_s=[0.008, 0.012] * 5)
    assert reader("idle_share.decode").read(run) == pytest.approx(40.0)
    assert reader("idle_share.prefill").read(run) is None
    least = rwkv6_step_bytes(512, 32, 64) / PEAK_HBM_BYTES_PER_S
    assert reader("rwkv6_step_roofline").read(run) == pytest.approx(
        100 * least / 0.0005)
    batch = _run("docqa-b8-p4096-g16", trace=trace)
    assert reader("idle_share.prefill").read(batch) == pytest.approx(40.0)
    assert reader("idle_share.decode").read(batch) is None


def _picks(sequences, B, finished, seed=2**31 + 5):
    from types import SimpleNamespace
    from portbench.harness import Batch, Session
    s = SimpleNamespace(traffic={"check": {"sequences": sequences}}, B=B)
    w = Window(finished=[Batch(None, None)] * finished)
    return Session.picks(s, seed, w)


@pytest.mark.parametrize("sequences,B,finished", [
    (8, 256, 2), (8, 64, 1), (32, 8, 11), (32, 8, 4), (32, 8, 3)])
def test_picks_are_distinct_and_cover_every_part_of_a_batch(
        sequences, B, finished):
    picks = _picks(sequences, B, finished)
    n = min(sequences, B * finished)
    assert len(picks) == n == len(set(picks))
    assert all(0 <= b < finished and 0 <= r < B for b, r in picks)
    k = min(n, B)
    edges = [round(i * B / k) for i in range(k + 1)]
    for j, (_, r) in enumerate(picks):
        assert edges[j % k] <= r < max(edges[j % k + 1], edges[j % k] + 1)
    if sequences > B and finished >= 4:
        assert len({b for b, _ in picks}) >= 4     # spread over batches
