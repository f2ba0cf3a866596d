"""What a run may load, and where it refuses to print a result."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax", "repro"]


def test_a_cell_loads_no_forbidden_module():
    code = ("import sys, json, torch; sys.path[:0] = [%r, %r]; "
            "from portbench import run; "
            "bench = json.load(open(%r)); "
            "r, _ = run.run_cell(bench, 'mixtral-decode', 11, 2.0, False, "
            "torch.device('cpu'), smoke=True); "
            "print(json.dumps([r['correct'], run.forbidden_modules(), "
            "sorted(m for m in sys.modules if m.split('.')[0] == "
            "'repro_torch')[:3]]))"
            % (str(ROOT), str(ROOT / "src"), str(ROOT / "BENCHMARK.json")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, found, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and found == [] and port


def _cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "rwkv6-decode",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=120, env=env, cwd=cwd)


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_the_port_must_be_in_the_checkout(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "ROOT", tmp_path)
    with pytest.raises(FileNotFoundError):
        run.use_checkout()
