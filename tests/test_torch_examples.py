"""The six ``examples/torch_*.py`` on the CPU, held against the reference's
``examples/*.py``.

Each example is loaded by path and its ``main(device="cpu")`` runs in this
process with stdout captured, as ``chip_smoke.py``'s ``[examples]`` phase
runs it on the card; the reference's example runs the same way (JAX on
the CPU). ``quickstart``, ``lustre_sim_hsm``, ``fs_profiles`` and
``fs_top`` (one frame) must print what the reference prints, under
``chip_smoke.EXAMPLE_MASKS``: wall times, fs_top's rates and latencies,
temporary directory names and the five inode-ordered paths quickstart's
find lists first. ``serve_kv_tiering`` draws its weights from
``torch.Generator``, so the reference engine's weights are carried into
the port's through ``convert.paged_lm_state_dict``; the generated tokens
and tier reports must then be equal. ``train_lm`` runs 2 steps.
"""
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (stdlib only at import)


def _port(name, **kw):
    text, out, _ = cs.run_example(cs.load_example(f"torch_{name}", "test"),
                                  device="cpu", **kw)
    return text, out


def _reference(name, **kw):
    pytest.importorskip("jax")
    return cs.run_example(cs.load_example(name, "test"), **kw)[0]


@pytest.mark.parametrize("name, kw", [
    ("quickstart", {}), ("lustre_sim_hsm", {}), ("fs_profiles", {}),
    ("fs_top", {"n_frames": 1})], ids=["quickstart", "lustre_sim_hsm",
                                        "fs_profiles", "fs_top"])
def test_example_prints_what_the_reference_prints(name, kw):
    got, _ = _port(name, **kw)
    want = _reference(name, **kw)
    assert got.strip() and cs.mask_stdout(got) == cs.mask_stdout(want)


def test_fs_top_sweeps_run_through_the_store():
    _, sweeps = _port("fs_top", n_frames=1)
    assert [r.evaluator for r in sweeps] == ["policy_scan_mesh"]
    assert sweeps[0].matched > 0 and sweeps[0].fallback_reason == ""


def test_serve_kv_tiering_with_the_reference_weights():
    from repro_torch.convert import paged_lm_state_dict
    pytest.importorskip("jax")
    import numpy as np
    ref_mod = cs.load_example("serve_kv_tiering", "test")
    made = []
    base = ref_mod.ServingEngine

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    ref_mod.ServingEngine = Recorded
    want, _, _ = cs.run_example(ref_mod)
    (ref_eng,) = made
    weights = paged_lm_state_dict(
        np.asarray(ref_eng.embed), np.asarray(ref_eng.head),
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in ref_eng.layers])
    mod = cs.load_example("torch_serve_kv_tiering", "test")
    ported = cs.serving_recorder(mod, weights)
    got, _, _ = cs.run_example(mod, device="cpu")
    assert got == want
    (eng,) = ported
    assert len(eng.seen) == 5 * (10 + 12 - 1)     # the token steps it ran


def test_train_lm_two_steps_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    text, out = _port("train_lm", argv=["--steps", "2"])
    assert len(out["history"]) == 2
    assert all(math.isfinite(x) for x in out["history"])
    assert "done: 2 steps" in text
    assert Path(out["ckpt"].dir).is_relative_to(tmp_path)
