"""catalog_from_columns: the reference catalog's state, carried over.

The port catalog built from the reference ``Catalog.arrays()`` columns and
the reference string table must return the same ``arrays()``: every
column equal in value and dtype, the same row order, the same string codes.

The model zoo's parameters and decode caches (``model_state_dict``,
``model_cache``) for the MoE, cross-attention and encoder archs: every
leaf of the reference's tree comes back bit for bit from the port's
per-layer tensors.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import Catalog as JCatalog, Entry as JEntry
from repro.core import FsType as JFsType, HsmState as JHsmState
from repro_torch.convert import catalog_from_columns


def _reference_catalog(seed, n=300, n_shards=4):
    rng = np.random.default_rng(seed)
    cat = JCatalog(n_shards=n_shards)
    cat.upsert_batch([JEntry(
        fid=i + 1, parent_fid=int(rng.integers(0, 50)), name=f"f{i}",
        path=f"/p/d{i % 7}/f{i}",
        type=JFsType(int(rng.integers(0, 3))),
        size=int(rng.integers(0, 1 << 40)), blocks=int(rng.integers(0, 1 << 30)),
        owner=f"user{int(rng.integers(0, 5))}",
        group=f"grp{int(rng.integers(0, 3))}",
        mode=int(rng.integers(0, 0o777)), nlink=int(rng.integers(1, 4)),
        atime=float(rng.random() * 1e9), mtime=float(rng.random() * 1e9),
        ctime=float(rng.random() * 1e9), ost_idx=int(rng.integers(-1, 8)),
        pool=["", "ssd", "hdd"][int(rng.integers(0, 3))],
        hsm_state=JHsmState(int(rng.integers(0, 7))),
        archive_id=int(rng.integers(0, 3)),
        status=["", "new", "done"][int(rng.integers(0, 3))],
        dirty=bool(rng.integers(0, 2))) for i in range(n)])
    # holes and updates: removed rows are reused out of order
    for fid in rng.choice(np.arange(1, n + 1), n // 10, replace=False):
        cat.remove(int(fid))
    for fid in range(n + 1, n + 1 + n // 20):
        cat.upsert(JEntry(fid=fid, name=f"n{fid}", path=f"/new/n{fid}",
                          owner="late-owner", size=fid))
    cat.update_fields(2 if cat.get(2) else 3, owner="renamed")
    return cat


def _strings(cat):
    return [cat.strings.lookup(i) for i in range(len(cat.strings))]


@pytest.mark.parametrize("seed,n_shards", [(0, 4), (1, 1), (2, 8)])
def test_catalog_from_columns_round_trips(seed, n_shards):
    ref = _reference_catalog(seed, n_shards=n_shards)
    want = ref.arrays()
    port = catalog_from_columns(want, _strings(ref), n_shards=n_shards)
    got = port.arrays()
    assert len(port) == len(ref)
    numeric = [k for k in want.keys() if not k.startswith("_")]
    assert sorted(got.keys()) == sorted(numeric)
    for k in numeric:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert list(got["_names"]) == list(want["_names"])
    assert list(got["_paths"]) == list(want["_paths"])
    assert _strings(port) == _strings(ref)


def test_catalog_from_columns_rejects_bad_string_tables():
    ref = _reference_catalog(3, n=20)
    with pytest.raises(ValueError):
        catalog_from_columns(ref.arrays(), ["x"] + _strings(ref)[1:])
    with pytest.raises(ValueError):
        catalog_from_columns(ref.arrays(), _strings(ref) + ["user0"])


# -- the model zoo's parameters and caches ------------------------------------

ZOO = ["mixtral_8x22b", "llama4_maverick_400b_a17b", "llama3p2_vision_11b",
       "whisper_large_v3"]


def _leaves(tree):
    """(path of keys, numpy array) of every leaf of a reference pytree."""
    import jax
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        out.append((keys, np.asarray(leaf)))
    return out


def _back(flat, keys, cfg):
    """The reference leaf at ``keys`` rebuilt from the port's per-layer
    tensors ``flat`` (name -> tensor): the inverse of the converter's cut
    (``scan`` row i of slot j is layer i * period + j, tail t layer
    n_super * period + t, ``encoder.layers`` row i ``encoder.layers.i``)."""
    import torch
    period = len(cfg.pattern)

    def arr(name):
        t = flat[name]
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    if keys[0] == "scan":
        rest = ".".join(str(k) for k in keys[2:])
        return np.stack([arr(f"layers.{i * period + keys[1]}.{rest}")
                         for i in range(cfg.n_super)])
    if str(keys[0]).startswith("tail"):
        n = cfg.n_super * period + int(keys[0][4:])
        return arr(f"layers.{n}." + ".".join(keys[1:]))
    if keys[:2] == ["encoder", "layers"]:
        rest = ".".join(keys[2:])
        return np.stack([arr(f"encoder.layers.{i}.{rest}")
                         for i in range(cfg.encoder.n_layers)])
    return arr(".".join(keys))


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ZOO)
def test_model_state_dict_round_trips_every_leaf(arch):
    """Every leaf of the reference's parameters (the 3-D experts, the
    per-layer gates, ``pos_embed``, the stacked encoder) comes back bit for
    bit from the port's state dict, after a load into the port's model."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    from repro_torch.configs import get_config as torch_config
    from repro_torch.convert import model_state_dict
    from repro_torch.models import Model
    cfg = get_config(arch, smoke=True)
    params = JaxModel(cfg).init(jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map_with_path(    # distinct gates a layer
        lambda p, a: a + 0.25 * jnp.arange(a.size, dtype=a.dtype).reshape(
            a.shape) if getattr(p[-1], "key", None) == "gate" else a, params)
    sd = model_state_dict(jax.tree.map(np.asarray, params), cfg)
    port = Model(torch_config(arch, smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(sd)
    flat = port.state_dict()
    leaves = _leaves(params)
    assert sum(a.size for _, a in leaves) == sum(t.numel()
                                                 for t in flat.values())
    for keys, want in leaves:
        got = _back(flat, keys, cfg)
        assert got.shape == want.shape, keys
        np.testing.assert_array_equal(got, _bits(want), err_msg=str(keys))


@pytest.mark.parametrize("name", ZOO + ["llama3p2_vision_11b:int8",
                                        "whisper_large_v3:int8"])
def test_model_cache_round_trips_every_leaf(name):
    """A reference cache with seeded contents in every leaf (ring k/v,
    cross-attention xk/xv, int8 k/v and their f32 scales) comes back bit
    for bit from the port's per-layer cache."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    from repro_torch.convert import model_cache
    arch, _, kind = name.partition(":")
    cfg = get_config(arch, smoke=True)
    if kind:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kind)
    rng = np.random.default_rng(7)

    def fill(a):
        if a.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape), jnp.int8)
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32),
                           a.dtype)
    cache = jax.tree.map(fill, JaxModel(cfg).init_cache(2, 40))
    layers = model_cache(jax.tree.map(np.asarray, cache), cfg)
    flat = {f"layers.{n}.{k}": t for n, layer in enumerate(layers)
            for k, t in layer.items()}
    leaves = _leaves(cache)
    assert len(flat) == sum(
        cfg.n_super if keys[0] == "scan" else 1 for keys, _ in leaves)
    for keys, want in leaves:
        np.testing.assert_array_equal(_back(flat, keys, cfg), _bits(want),
                                      err_msg=str(keys))
