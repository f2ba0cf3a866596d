"""Per-arch smoke tests of the port (``tests/models/test_smoke.py`` on
``repro_torch``): every one of the 10 archs at its smoke config on the
CPU, one forward and three train steps, and the published full configs.

* the forward's logits have shape (B, S, V) and no NaN, the aux loss is
  finite;
* three ``make_train_step`` steps on one batch (``extras`` too, with a
  leading ``accum`` axis), AdamW without weight decay: every loss finite,
  the last below the first (the same batch must overfit);
* the full configs carry the published numbers, and the MoE configs'
  parameter counts the published totals and active shares.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.train import init_train_state, make_train_step

B, S = 2, 32


def _extras(cfg):
    if cfg.encoder is not None:
        return {"frames": torch.ones((B, cfg.encoder.n_frames, cfg.d_model),
                                     dtype=torch.bfloat16) * 0.01}
    if cfg.n_img_tokens:
        return {"img": torch.ones((B, cfg.n_img_tokens, cfg.d_model),
                                  dtype=torch.bfloat16) * 0.01}
    return None


def _tokens(cfg, shape):
    return torch.randint(0, cfg.vocab, shape,
                         generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_no_nans(arch):
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, kv_chunk=16).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    logits, aux, _ = m(_tokens(cfg, (B, S)), _extras(cfg))
    assert logits.shape == (B, S, cfg.vocab)
    assert not bool(torch.isnan(logits).any())
    assert math.isfinite(float(aux))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_decreases_loss_or_finite(arch):
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, kv_chunk=16)
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    state = init_train_state(m, opt, torch.Generator().manual_seed(0))
    step = make_train_step(m, opt)
    toks = _tokens(cfg, (1, B, S))
    batch = {"tokens": toks, "labels": toks}
    ex = _extras(cfg)
    if ex is not None:
        batch["extras"] = {k: v[None] for k, v in ex.items()}
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]      # same batch -> must overfit


def test_full_configs_match_assignment():
    """The exact published numbers from the assignment block."""
    spec = {
        "recurrentgemma_9b": (38, 4096, 16, 1, 12288, 256000),
        "mixtral_8x22b": (56, 6144, 48, 8, 16384, 32768),
        "llama4_maverick_400b_a17b": (48, 5120, 40, 8, 8192, 202048),
        "rwkv6_1p6b": (24, 2048, 32, 32, 7168, 65536),
        "gemma2_9b": (42, 3584, 16, 8, 14336, 256000),
        "chatglm3_6b": (28, 4096, 32, 2, 13696, 65024),
        "codeqwen1p5_7b": (32, 4096, 32, 32, 13440, 92416),
        "deepseek_coder_33b": (62, 7168, 56, 8, 19200, 32256),
        "whisper_large_v3": (32, 1280, 20, 20, 5120, 51866),
        "llama3p2_vision_11b": (40, 4096, 32, 8, 14336, 128256),
    }
    for arch, (L, D, H, K, F, V) in spec.items():
        cfg = get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
                cfg.vocab) == (L, D, H, K, F, V), arch


def test_moe_param_counts():
    cfg = get_config("mixtral_8x22b")
    total = cfg.param_count()
    active = cfg.active_param_count()
    assert 120e9 < total < 160e9          # ~141B
    assert 35e9 < active < 50e9           # ~39B active (top-2 of 8)
    cfg4 = get_config("llama4_maverick_400b_a17b")
    assert 350e9 < cfg4.param_count() < 450e9
    assert 12e9 < cfg4.active_param_count() < 25e9


@pytest.mark.parametrize("arch", ["mixtral_8x22b",
                                  "llama4_maverick_400b_a17b"])
def test_moe_model_holds_the_counted_expert_parameters(arch):
    """The smoke model's expert and router tensors hold exactly what
    ``param_count`` counts for its MoE layers (E * 3 * D * F + D * E a
    layer, 3 * D * F more with the shared expert)."""
    cfg = get_config(arch, smoke=True)
    m = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    per_layer = D * E + E * 3 * D * F + (3 * D * F if
                                         cfg.moe.shared_expert else 0)
    n_moe = sum(s.ffn == "moe" for s in cfg.layers)
    held = sum(p.numel() for n, p in m.named_parameters()
               if ".ffn." in n and cfg.layers[int(n.split(".")[1])].ffn
               == "moe")
    assert n_moe >= 1 and held == n_moe * per_layer


@pytest.mark.parametrize("smoke", [False, True])
def test_every_config_constructs(smoke):
    """``Model(cfg)`` holds no parameters until ``init``, so the published
    configs construct here too; none of the 10 archs is refused."""
    for arch in ARCH_IDS:
        m = Model(get_config(arch, smoke=smoke))
        assert m.cfg.name == get_config(arch, smoke=smoke).name
        assert not list(m.parameters())
