"""The FLOP and byte counts pinned to hand counts and to the port's own
parameter layout."""
import json

import pytest
import torch

from portbench.count import family, least_seconds
from portbench.count.moe_transformer import (decode_bytes, decode_flops,
                                             layer_params, prefill_flops)
from portbench.count.rwkv6 import rwkv6_step_bytes
from portbench.harness import load_config
from portbench.models import moe_transformer, rwkv6

MIXTRAL = load_config("mixtral-8x22b-8L")
RWKV = load_config("rwkv6-1.6b")


def test_rwkv6_step_bytes_at_256_32_64():
    # r, k, v, w, y f32 (5 x 2,097,152), u 8,192, the state read and written
    assert rwkv6_step_bytes(256, 32, 64) == 278_929_408


def test_mixtral_8_layers():
    assert layer_params(MIXTRAL) == 2_504_060_928
    outer = 2 * 32768 * 6144 + 6144
    assert outer == 402_659_328
    assert family("moe_transformer").parameters(MIXTRAL) == \
        20_435_146_752 == 8 * 2_504_060_928 + outer
    four = dict(MIXTRAL, n_layers=4)
    assert family("moe_transformer").parameters(four) == 10_418_903_040


def test_rwkv6_whole():
    assert family("rwkv6").parameters(RWKV) == 1_599_670_272 == \
        RWKV["parameters"]


@pytest.mark.parametrize("name,fam", [("rwkv6-1.6b", rwkv6),
                                      ("mixtral-8x22b-8L", moe_transformer)])
def test_layout_and_count_match_the_port(name, fam):
    """At the smoke sizes: the benchmark's layout covers every parameter
    of the port's model with its shape, and the count module counts
    them."""
    from repro_torch.models import Model
    cfg = load_config(name, smoke=True)
    model = Model(fam.port_config(cfg)).init(
        torch.Generator().manual_seed(0), "cpu")
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ours = {leaf.port: leaf.shape for g in fam.layout(cfg) for leaf in g}
    assert ours == port
    count = family(cfg["family"])
    assert count.parameters(cfg) == sum(
        p.numel() for p in model.parameters())


def test_mixtral_decode_counts():
    B, pos = 64, 300
    # every expert is reached at B = 64, top 2 of 8
    experts = 8 * 8 * 3 * 6144 * 16384 * 2
    other = (8 * (88_080_384 + 6144 * 8 + 2 * 6144) + 32768 * 6144
             + 6144) * 2 + B * 6144 * 2
    kv = 2 * 8 * B * (pos + 1) * 8 * 128 * 2 + 2 * 8 * B * 8 * 128 * 2
    assert decode_bytes(MIXTRAL, B, pos) == experts + other + kv + 2 * B * 4
    per_tok = 8 * (2 * (88_080_384 + 6144 * 8 + 2 * 3 * 6144 * 16384)
                   + 4 * 48 * 128 * (pos + 1)) + 2 * 6144 * 32768
    assert decode_flops(MIXTRAL, B, pos) == B * per_tok
    # causal prefill: positions attend to 1..P keys
    P = 4
    attn = 4 * 48 * 128 * (1 + 2 + 3 + 4)
    prod = 2 * (88_080_384 + 6144 * 8 + 2 * 3 * 6144 * 16384)
    assert prefill_flops(MIXTRAL, 1, P) == 8 * (P * prod + attn) + \
        2 * 6144 * 32768


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(989e12, 0) == pytest.approx(1.0)
    assert least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert least_seconds(989e12, 6.7e12) == pytest.approx(2.0)


def test_benchmark_names_each_config_file():
    bench = json.load(open(
        __import__("portbench.harness").harness.ROOT / "BENCHMARK.json"))
    for c in bench["configs"]:
        cfg = load_config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"]
        assert c["source"] == cfg["source"]
