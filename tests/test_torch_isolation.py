"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

``repro_torch``, ``chip_smoke.py`` and ``examples/torch_*.py`` must import
neither ``jax`` nor any module of the JAX package; a policy must run (through ``policy_scan`` and,
over a ``DeviceColumnStore``, ``policy_scan_mesh``), a profile cube and its
reports must build, the paged serving engine must serve requests over
its tiered KV cache, and the model zoo's recurrent, MoE and encoder-decoder
archs must prefill and decode, with both blocked (and a tenant's scoped queries
served from the store, and a policy run over a store whose groups are
demoted to packed segments and streamed, and three steps of the training
launcher with a checkpoint restored); the default device must raise when
CUDA is absent; and the kernel path must refuse CPU tensors instead of
quietly running the plain version.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_BLOCKED_RUN = r'''
import sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
for mod in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]:
    del sys.modules[mod]

from repro_torch.core import (Catalog, Entry, FsType, PolicyDefinition,
                              PolicyEngine)
from repro_torch.convert import catalog_from_columns
from repro_torch.kernels.policy_scan import kernel, ops, ref

cat = Catalog()
cat.upsert_batch([Entry(fid=i + 1, name=f"f{i}", path=f"/f{i}",
                        type=FsType.FILE, size=i * 4096, atime=float(i))
                  for i in range(200)])
acted = []
def act(e, params):
    acted.append(e.fid)
    return True
eng = PolicyEngine(cat, clock=lambda: 1e6, device="cpu")
eng.register(PolicyDefinition.from_config(
    "p", act, scope="type == file", rules=[("big", "size > 400K", {})],
    sort_by="atime", mutates=False))
r = eng.run("p", evaluator="policy_scan")
assert r.evaluator == "policy_scan" and r.fallback_reason == "", r
assert acted == list(range(102, 201)), acted[:5]

from repro_torch.core import DeviceColumnStore
eng.attach_device_store(DeviceColumnStore(cat, groups=3, device="cpu"))
acted.clear()
rm = eng.run("p", evaluator="policy_scan_mesh")
assert rm.evaluator == "policy_scan_mesh" and rm.fallback_reason == "", rm
assert acted == list(range(102, 201)), acted[:5]
assert kernel.policy_scan_store_launches == 0
assert kernel.policy_scan_store_lean_launches == 0

from repro_torch.core import ProfileCube, Reports
from repro_torch.kernels.profile_cube import kernel as pc_kernel
cube = ProfileCube(cat, clock=lambda: 1e6, use_kernel=True,
                   device="cpu").attach()
host = ProfileCube(cat, clock=lambda: 1e6, device="cpu")
host.rebuild()
assert (cube.cube() == host.cube()).all()
rep = Reports(cat, profiles=cube, clock=lambda: 1e6)
assert rep.report_user("root")[0]["count"] == 200, rep.report_user("root")
assert rep.du("/")["files"] == 200
assert pc_kernel.profile_cube_launches == 0

from repro_torch.core import GrantTable
grants = GrantTable()
grants.add_subject("half", owners=(), subtrees=("/f1",))
store = DeviceColumnStore(cat, groups=2, device="cpu")
pc_s = ProfileCube(cat, clock=lambda: 1e6, device="cpu").attach_device_store(store)
pc_s.attach_grants(grants)
rep_s = Reports(cat, profiles=pc_s, clock=lambda: 1e6).attach_device_store(
    store).attach_grants(grants)
pc_h = ProfileCube(cat, clock=lambda: 1e6, device="cpu")
pc_h.attach_grants(grants)
pc_h.rebuild()
rep_h = Reports(cat, profiles=pc_h, clock=lambda: 1e6).attach_grants(grants)
seen = rep_s.find("size >= 0", subject="half")
assert seen == rep_h.find("size >= 0", subject="half") == ["/f1"]
assert rep_s.top_files(k=3, subject="half") == rep_h.top_files(k=3, subject="half")
assert rep_s.du("/", subject="half") == rep_h.du("/", subject="half")
assert rep_s.report_types(subject="half") == rep_h.report_types(subject="half")
assert rep_s.host_served == 0 and store.perm_materializations == 2
assert kernel.policy_scan_store_scoped_lean_launches == 0
assert pc_kernel.profile_cube_scoped_launches == 0

tiered = DeviceColumnStore(cat, groups=2, device="cpu", tile=32,
                           hbm_budget_rows=200, window_rows=32)
eng.attach_device_store(tiered)
acted.clear()
rt = eng.run("p", evaluator="policy_scan_mesh")
assert rt.evaluator == "policy_scan_mesh" and rt.fallback_reason == "", rt
assert acted == list(range(102, 201)), acted[:5]
assert rt.tiering["demoted_groups"] >= 1, rt.tiering
assert rt.tiering["windows_streamed"] > 0, rt.tiering
assert kernel.policy_scan_store_lean_launches == 0

from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.serve import PagedLMConfig, Request, ServingEngine
cfg = PagedLMConfig(n_pages=4, page_size=4, n_layers=2, high_wm=70.0,
                    low_wm=40.0)
srv = ServingEngine(cfg, seed=2, device="cpu")
done = srv.run([Request(req_id=i, prompt=[3 * i + j for j in range(5)],
                        max_new=4) for i in range(3)])
assert all(r.done and len(r.generated) == 4 for r in done)
assert all(t["hot_pages"] == 0 for t in srv.tier_report())
assert sum(t["restores"] for t in srv.tier_report()) > 0
assert pa_kernel.paged_attention_launches == 0

import torch
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import kernel as rg_kernel
from repro_torch.kernels.rwkv6_step import kernel as rw_kernel
from repro_torch.models import Model
from repro_torch.serve import make_prefill, make_serve_step
for arch in ("rwkv6_1p6b", "recurrentgemma_9b", "mixtral_8x22b",
             "whisper_large_v3"):
    cfg = get_config(arch, smoke=True)
    model = Model(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    prompt = torch.arange(12).reshape(2, 6) % cfg.vocab
    extras = ({"frames": torch.ones((2, cfg.encoder.n_frames, cfg.d_model),
                                    dtype=torch.bfloat16)}
              if cfg.encoder is not None else None)
    last, cache = make_prefill(model, cache_len=9)(prompt, extras)
    nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    step = make_serve_step(model)
    for pos in range(6, 9):
        nxt, cache = step(cache, nxt, pos)
        assert nxt.shape == (2, 1) and bool(((nxt >= 0) & (nxt < cfg.vocab)).all())
    assert len(cache) == cfg.n_layers
assert rg_kernel.rglru_scan_launches == 0
assert rw_kernel.rwkv6_step_launches == 0

import contextlib, io, tempfile
from repro_torch.launch import train as launch_train
printed = io.StringIO()
with tempfile.TemporaryDirectory() as ck, contextlib.redirect_stdout(printed):
    out = launch_train.main(["--arch", "recurrentgemma-9b", "--smoke",
                             "--steps", "3", "--batch", "4", "--seq", "16",
                             "--accum", "2", "--device", "cpu",
                             "--ckpt-dir", ck, "--ckpt-interval", "2"])
    assert len(out["history"]) == 3 and out["restarts"] == 0
    assert all(l == l for l in out["history"])
    assert out["ckpt"].steps() == [2]
    restored, step = out["ckpt"].restore(like=out["state"])
    assert step == 2 and int(restored["step"]) == 2
assert printed.getvalue().startswith("step     0 loss"), printed.getvalue()
assert "done: 3 steps, restarts=0" in printed.getvalue()
assert rg_kernel.rglru_scan_launches == 0
assert rg_kernel.rglru_scan_bwd_launches == 0

import socket
import torch.distributed as dist
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import init_error_state, make_compressed_allreduce
from repro_torch.runtime.elastic import reshard_state, state_shardings
from repro_torch.runtime.sharding import ShardingRules
with socket.socket() as sock:
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=0, world_size=1)
mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
state = out["state"]
laid = reshard_state(state, state_shardings(out["model"].cfg, mesh, state))
with tempfile.TemporaryDirectory() as ck, contextlib.redirect_stdout(
        io.StringIO()):
    out2 = launch_train.run(launch_train.parse_args(
        ["--arch", "recurrentgemma-9b", "--smoke", "--steps", "2",
         "--batch", "4", "--seq", "16", "--accum", "2", "--device", "cpu",
         "--ckpt-dir", ck, "--mesh", "1x1x1"]))
assert len(out2["history"]) == 2
g = {"w": torch.ones(8)}
mean, err = make_compressed_allreduce(mesh, "data")(g, init_error_state(g))
assert torch.equal(mean["w"], g["w"]) and not bool(err["w"].any())
dist.destroy_process_group()
assert roofline.roofline_terms(989e12, 0.0, 0.0)["compute_s"] == 1.0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert not loaded, loaded
print("OK", r.matched)
'''


def test_policy_runs_with_jax_and_repro_blocked():
    """Also runs the policy through ``policy_scan_mesh`` over a
    ``DeviceColumnStore(groups=3, device="cpu")``, builds a
    ``ProfileCube(use_kernel=True)`` and ``Reports``, runs a scoped
    ``find``, ``top_files``, ``du`` and cube through a store with a
    ``GrantTable``,
    serves requests through ``ServingEngine(device="cpu").run``, runs a
    prefill and three decode steps of both recurrent smoke models, of
    mixtral smoke (MoE) and of whisper smoke (its encoder's frames), and
    trains recurrentgemma smoke three steps through ``launch.train.main``
    (a checkpoint saved and restored), then on a 1x1 mesh of a one-rank
    gloo group lays the state out (``runtime.elastic``), trains two steps
    through ``launch.train.run --mesh 1x1x1`` and runs the compressed
    all-reduce, with the dry run and the roofline imported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "OK 99"


def test_default_device_without_cuda_raises(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import Catalog, PolicyEngine
    from repro_torch.kernels.policy_scan import ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        PolicyEngine(Catalog())
    from repro_torch.core import DeviceColumnStore
    cat = Catalog()
    with pytest.raises(RuntimeError):
        DeviceColumnStore(cat)
    assert not cat._hooks                  # raised before subscribing
    from repro_torch.core.policy import KERNEL_COLUMNS
    with pytest.raises(RuntimeError):
        ops.column_stack({c: np.zeros(3) for c in KERNEL_COLUMNS})
    from repro_torch.kernels.profile_cube.ops import profile_cube
    with pytest.raises(RuntimeError):
        profile_cube(*(np.zeros(3),) * 4, n_groups=2)
    from repro_torch.kvcache import PagePool
    from repro_torch.serve import PagedLMConfig, ServingEngine
    with pytest.raises(RuntimeError):
        ServingEngine(PagedLMConfig())
    with pytest.raises(RuntimeError):
        PagePool(4, 4, 2, 8)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    with pytest.raises(RuntimeError):
        Model(get_config("rwkv6_1p6b", smoke=True)).init(torch.Generator())
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError):
        launch_train.main(["--smoke", "--steps", "1"])
    from repro_torch.launch import mesh as launch_mesh
    with pytest.raises(RuntimeError):
        launch_mesh.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError):
        launch_mesh.make_production_mesh()
    with pytest.raises(RuntimeError):
        launch_mesh.make_shards_mesh(1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_path_refuses_cpu_tensors():
    from repro_torch.kernels.policy_scan import kernel, ops
    cols = torch.zeros((17, 8))
    prog = (torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((2, 3), dtype=torch.float32))
    before = (kernel.policy_scan_launches, kernel.policy_scan_batch_launches)
    with pytest.raises(ValueError):
        ops.policy_scan_batch(cols, *prog, use_kernel=True)
    with pytest.raises(ValueError):
        ops.policy_scan(cols, *(p[0] for p in prog), use_kernel=True)
    with pytest.raises(ValueError):
        kernel.policy_scan_batch_cuda(cols, *prog)
    with pytest.raises(ValueError):
        kernel.policy_scan_cuda(cols, *(p[0] for p in prog))
    assert (kernel.policy_scan_launches,
            kernel.policy_scan_batch_launches) == before
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention import ops as pa_ops
    q, pages = torch.zeros((1, 4, 8)), torch.zeros((2, 4, 2, 8))
    table = torch.zeros((1, 1), dtype=torch.int32)
    length = torch.ones(1, dtype=torch.int32)
    before = pa_kernel.paged_attention_launches
    with pytest.raises(ValueError):
        pa_kernel.paged_attention_cuda(q, pages, pages, table, length)
    with pytest.raises(ValueError):
        pa_ops.paged_attention(q, pages, pages, table, length,
                               use_kernel=True)
    assert pa_kernel.paged_attention_launches == before
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rwkv6_step import kernel as rw_kernel
    from repro_torch.kernels.rwkv6_step import ops as rw_ops
    la = torch.zeros((1, 3, 8))
    vec, u, s = torch.zeros((1, 2, 4)), torch.zeros((2, 4)), \
        torch.zeros((1, 2, 4, 4))
    before = (rg_kernel.rglru_scan_launches, rw_kernel.rwkv6_step_launches)
    with pytest.raises(ValueError):
        rg_ops.rglru_scan(la, la, use_kernel=True)
    with pytest.raises(ValueError):
        rg_kernel.rglru_scan_cuda(la, la)
    with pytest.raises(ValueError):
        rg_kernel.rglru_scan_bwd_cuda(la, la, la)
    with pytest.raises(ValueError):
        rw_ops.rwkv6_step(vec, vec, vec, vec, u, s, use_kernel=True)
    with pytest.raises(ValueError):
        rw_kernel.rwkv6_step_cuda(vec, vec, vec, vec, u, s)
    assert (rg_kernel.rglru_scan_launches,
            rw_kernel.rwkv6_step_launches) == before


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.MULTILINE)


def test_no_file_of_the_port_imports_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 6           # each of examples/*.py, ported
    files += examples
    assert len(files) > 10 and all(f.exists() for f in files)
    for f in files:
        text = f.read_text()
        hit = _FORBIDDEN.search(text)
        assert hit is None, f"{f.relative_to(ROOT)}: {hit.group(0).strip()}"
        assert "import jax" not in text, f
