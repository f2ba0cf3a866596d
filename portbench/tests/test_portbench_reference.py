"""The plain float32 references against the port's CPU model at the
configurations' smoke sizes: the port cast to float32 gives the same
logits (the reference follows the port's equations, term by term), and
the bfloat16 port, served through prefill and the decode step, puts the
reference's best token first within bf16's rounding."""
import importlib

import pytest
import torch

from portbench import weights
from portbench.harness import load_config

CASES = [("rwkv6-1.6b", 1), ("rwkv6-1.6b", 2**31 + 5),
         ("mixtral-8x22b-8L", 3), ("mixtral-8x22b-8L", 2**31 + 7)]


def _model(name, seed):
    from repro_torch.models import Model
    cfg = load_config(name, smoke=True)
    fam = importlib.import_module(f"portbench.models.{cfg['family']}")
    ref = importlib.import_module(f"portbench.reference.{cfg['family']}")
    model = Model(fam.port_config(cfg)).init(
        torch.Generator().manual_seed(0), "cpu")
    groups = fam.layout(cfg)
    weights.bind(model, groups, seed)
    return cfg, model, groups, ref


@pytest.mark.parametrize("name,seed", CASES)
def test_reference_is_the_port_in_float32(name, seed):
    cfg, model, groups, ref = _model(name, seed)
    model.float()
    g = torch.Generator().manual_seed(seed % 1000)
    tokens = torch.randint(0, cfg["vocab"], (3, 40), generator=g)
    with torch.no_grad():
        port, _, _ = model.forward(tokens)
    get = weights.reference_weights(groups, seed, torch.device("cpu"))
    ours = ref.logits(cfg, get, tokens, 0)
    scale = port.abs().max()
    assert torch.allclose(ours, port, atol=2e-5 * scale, rtol=0), \
        (ours - port).abs().max() / scale


@pytest.mark.parametrize("name,seed", CASES)
def test_served_bf16_agrees_with_the_reference(name, seed):
    """Prefill then decode through the cache in bf16: the served greedy
    tokens' logits lie within bf16 rounding of the reference's best."""
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    cfg, model, groups, ref = _model(name, seed)
    B, P, G = 3, 24, 10
    g = torch.Generator().manual_seed(seed % 997)
    prompts = torch.randint(0, cfg["vocab"], (B, P), generator=g)
    prefill, step = make_prefill(model, P + G), make_serve_step(model)
    logits, cache = prefill(prompts)
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    served = [nxt]
    for i in range(1, G):
        nxt, cache = step(cache, nxt, P + i - 1)
        served.append(nxt)
    served = torch.cat(served, dim=1).long()
    get = weights.reference_weights(groups, seed, torch.device("cpu"))
    full = torch.cat([prompts, served[:, :-1]], dim=1)
    rl = ref.logits(cfg, get, full, P - 1)
    gap = rl.max(-1).values - rl.gather(-1, served[..., None])[..., 0]
    spread = rl.std()
    assert float(gap.max()) < 0.05 * float(spread), (gap.max(), spread)


def test_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path
    here = Path(__file__).resolve().parents[1] / "reference"
    for path in here.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "jaxlib", "flax",
                    "portbench"), f"{path.name} imports {n}"


def test_float8_products_round_both_operands():
    from portbench.reference.common import mm
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 256, generator=g)
    w = torch.randn(256, 128, generator=g) / 16
    exact = x @ w
    assert torch.equal(mm(x, w), exact)
    err = (mm(x, w, "fp8") - exact).norm() / exact.norm()
    assert 1e-3 < float(err) < 0.1          # e4m3 keeps 3 mantissa bits
    with pytest.raises(ValueError):
        mm(x, w, "int4")
