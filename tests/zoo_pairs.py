"""Reference/port pairs of the model zoo's smoke configs for the
differential tests (``test_torch_zoo*.py``, ``test_torch_train.py``,
``test_torch_serve_graph.py``): the JAX package's model with its
parameters, every cross-attention ``gate`` set to ``GATE`` (the reference
draws them 0, and ``tanh(0) = 0`` would hide the cross path from every
comparison), and the port's model holding the same parameters through
``convert.model_state_dict``, on the CPU, with one seeded token batch and
seeded bf16 ``extras`` (image tokens or encoder frames). ``arch:int8``
names the same config with ``kv_cache_dtype="int8"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.models import Model

KEY = jax.random.PRNGKey(3)
B, S, P = 2, 24, 20
GATE = 0.5
ARCHS = ["mixtral_8x22b", "llama4_maverick_400b_a17b", "llama3p2_vision_11b",
         "whisper_large_v3"]
INT8 = ["llama3p2_vision_11b:int8", "whisper_large_v3:int8"]
CROSS = ["llama3p2_vision_11b", "whisper_large_v3"]


def bound(scale: float) -> float:
    return 0.05 * scale + 0.05


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def configs(name: str, dropless: bool = False):
    """(reference config, port config) of ``arch[:int8]``; ``dropless``
    sets the MoE capacity factor to E / k (the reference's
    decode-consistency test's)."""
    arch, _, kind = name.partition(":")
    out = []
    for get in (get_config, torch_config):
        cfg = get(arch, smoke=True)
        if kind == "int8":
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        if dropless and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)
                / cfg.moe.top_k))
        out.append(cfg)
    return tuple(out)


def with_gates(params, value: float):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, value)
        if getattr(path[-1], "key", None) == "gate" else a, params)


def extras_np(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    if cfg.encoder is not None:
        return {"frames": (rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)}
    if cfg.n_img_tokens:
        return {"img": (rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)) * 0.1).astype(np.float32)}
    return None


def jx(extras):
    return None if extras is None else {
        k: jnp.asarray(v, jnp.bfloat16) for k, v in extras.items()}


def tx(extras):
    return None if extras is None else {
        k: torch.from_numpy(v).to(torch.bfloat16) for k, v in extras.items()}


class Pair:
    """The reference model with its (gated) parameters and the port's with
    the same parameters, on the CPU, plus one seeded token batch and
    ``extras``."""

    def __init__(self, name: str, dropless: bool = False):
        self.cfg, tcfg = configs(name, dropless)
        self.ref = JaxModel(self.cfg, kv_chunk=8)
        self.params = with_gates(self.ref.init(KEY), GATE)
        self.pnp = jax.tree.map(np.asarray, self.params)
        self.port = Model(tcfg, kv_chunk=8).init(
            torch.Generator().manual_seed(0), device="cpu")
        self.port.load_state_dict(convert.model_state_dict(self.pnp,
                                                           self.cfg))
        self.tokens = np.array(jax.random.randint(
            jax.random.fold_in(KEY, 1), (B, S), 0, self.cfg.vocab))
        self.extras = extras_np(self.cfg)
        self._full = None

    def ref_layer(self, n: int):
        period = len(self.cfg.pattern)
        i, j = divmod(n, period)
        if i < self.cfg.n_super:
            return jax.tree.map(lambda a: a[i], self.params["scan"][j])
        return self.params[f"tail{n - self.cfg.n_super * period}"]

    def full(self):
        """Both packages' forward logits over the whole token batch."""
        if self._full is None:
            want, _, _ = self.ref.forward(self.params,
                                          jnp.asarray(self.tokens),
                                          jx(self.extras))
            got, _, _ = self.port(torch.from_numpy(self.tokens),
                                  tx(self.extras))
            self._full = (to_np(want), to_np(got))
        return self._full


PAIRS = {}


def get_pair(name: str, dropless: bool = False) -> Pair:
    if (name, dropless) not in PAIRS:
        PAIRS[(name, dropless)] = Pair(name, dropless)
    return PAIRS[(name, dropless)]


def close_bf16(got, want, what: str, tol=None) -> None:
    got, want = to_np(got), to_np(want)
    tol = 2.0 ** -6 * float(np.abs(want).max()) if tol is None else tol
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} > {tol}"


def close_state(got, want, what: str) -> None:
    got, want = to_np(got), to_np(want)
    tol = 1e-3 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} > {tol}"


def close_blob(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for key in want:
        if want[key].dtype == jnp.float32:
            close_state(got[key], want[key], f"{what} {key}")
        elif want[key].dtype == jnp.int8:
            assert got[key].dtype == torch.int8
            close_bf16(got[key], want[key], f"{what} {key}",
                        tol=2.0 ** -6 * 127)
        else:
            close_bf16(got[key], want[key], f"{what} {key}")


def dequantized(layer: dict) -> dict:
    """A cache layer with int8 k/v replaced by k * kscale (f32)."""
    out = {k: v.float() for k, v in layer.items()
           if not k.endswith("scale")}
    for key in ("k", "v"):
        if key + "scale" in layer:
            out[key] = layer[key].float() * layer[key + "scale"]
    return out
