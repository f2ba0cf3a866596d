"""The binding every kernel package shares, on the CPU with no ``nvcc``.

``_build.Library`` builds, loads and binds each package's library and
formats its errors; ``_launches.reset`` zeroes a kernel module's launch
counters; ``_launches.kernel_for`` is the ``use_kernel``-versus-device rule
of every public op. The loads here go through fakes of the build and of
``ctypes.CDLL``; the library names are held to the hash they have always
had, so a build directory stays valid across changes to this code.
"""
import ctypes
import hashlib
import importlib
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, _launches

KERNELS = ("decode_attention", "mla_decode", "paged_attention",
           "policy_scan", "profile_cube", "rglru_scan", "rwkv6_step",
           "wkv_chunked")


def _module(name):
    return importlib.import_module(f"repro_torch.kernels.{name}.kernel")


class _FakeFn:
    """A C function of a fake library: takes argtypes and restype, and
    answers calls with ``fn``."""

    def __init__(self, fn=lambda *a: 0):
        self.fn, self.argtypes, self.restype = fn, None, None

    def __call__(self, *args):
        return self.fn(*args)


class _FakeLib:
    """What ``ctypes.CDLL`` returns, with every function a ``_FakeFn`` and
    ``<name>_error_string`` answering ``b"error <code>"``."""

    def __init__(self, path, name):
        self.path = path
        setattr(self, f"{name}_error_string",
                _FakeFn(lambda code: f"error {code}".encode()))

    def __getattr__(self, attr):
        fn = _FakeFn()
        setattr(self, attr, fn)
        return fn


def _fake_library(monkeypatch, name, loads):
    """A fresh ``Library`` with the package's own name, sources and
    ``bind``, whose build and load are fakes that count into ``loads``."""
    real = _module(name).LIBRARY
    binds = []

    def bind(lib):
        binds.append(lib)
        real.bind(lib)
    lib = _build.Library(real.name, real.csrc, real.sources, bind,
                         real.headers)
    monkeypatch.setattr(lib, "build",
                        lambda: Path(f"/nonexistent/lib{name}_fake.so"))

    def cdll(path):
        time.sleep(0.01)             # widen the window for a second load
        loads.append(path)
        return _FakeLib(path, real.name)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    return lib, binds


@pytest.mark.parametrize("name", KERNELS)
def test_reset_zeroes_every_launch_counter_and_nothing_else(monkeypatch,
                                                            name):
    mod = _module(name)
    monkeypatch.setattr(mod, "added_at_test_time_launches", 5,
                        raising=False)
    counters = [k for k, v in vars(mod).items()
                if k.endswith("_launches") and isinstance(v, int)]
    assert len(counters) >= 2        # the module's own and the added one
    for i, k in enumerate(counters):
        monkeypatch.setattr(mod, k, i + 1)
    others = {k: v for k, v in vars(mod).items() if k not in counters}
    mod.reset_counters()
    assert all(getattr(mod, k) == 0 for k in counters)
    assert {k: v for k, v in vars(mod).items() if k not in counters} \
        .keys() == others.keys()
    assert all(getattr(mod, k) is v for k, v in others.items())


@pytest.mark.parametrize("name", KERNELS)
def test_library_loads_and_binds_once_under_eight_threads(monkeypatch, name):
    loads = []
    lib, binds = _fake_library(monkeypatch, name, loads)
    start = threading.Barrier(8)
    got = []

    def first_use():
        start.wait(timeout=10)
        got.append(lib.get())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert len(loads) == 1 and binds == [got[0]]
    err = getattr(got[0], f"{lib.name}_error_string")
    assert err.argtypes == [ctypes.c_int] and err.restype is ctypes.c_char_p
    assert lib.get() is got[0] and len(loads) == 1


@pytest.mark.parametrize("name", KERNELS)
def test_library_check_raises_with_the_library_error_string(monkeypatch,
                                                            name):
    lib, _ = _fake_library(monkeypatch, name, [])
    lib.check(0, "launch")
    with pytest.raises(RuntimeError,
                       match=f"^{name} launch failed: error 700$"):
        lib.check(700, "launch")


@pytest.mark.parametrize("name", KERNELS)
def test_library_path_keeps_its_hash(monkeypatch, tmp_path, name):
    """sha256 of the joined flags, then each source's and header's bytes:
    the first 16 hex digits name the library."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    mod = _module(name)
    files = tuple(mod.SOURCES) + tuple(getattr(mod, "HEADERS", ()))
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in files:
        h.update((mod.CSRC / f).read_bytes())
    want = tmp_path / f"lib{name}_{h.hexdigest()[:16]}.so"
    assert mod.LIBRARY.path() == want
    assert mod.LIBRARY.name == name and mod.LIBRARY.csrc == mod.CSRC


@pytest.mark.parametrize("use_kernel, device, want", [
    (None, "cpu", False), (False, "cpu", False), (None, "cuda", True),
    (True, "cuda", True), (True, "cpu", "use_kernel=True needs CUDA"),
    (False, "cuda", "use_kernel=False on CUDA")])
def test_kernel_for_follows_the_device(use_kernel, device, want):
    args = (torch.device(device), use_kernel, "rwkv6_step",
            "ref.rwkv6_step_ref")
    if isinstance(want, bool):
        assert _launches.kernel_for(*args) is want
    else:
        with pytest.raises(ValueError, match=want):
            _launches.kernel_for(*args)


def _cpu_calls():
    """kernel -> a call of its public op on CPU tensors with
    ``use_kernel=True``."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.policy_scan.ops import (mesh_policy_scan_batch,
                                                     policy_scan,
                                                     policy_scan_batch)
    from repro_torch.kernels.profile_cube.ops import (mesh_profile_cube,
                                                      profile_cube)
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rwkv6_step.ops import rwkv6_step
    from repro_torch.kernels.wkv_chunked.ops import wkv_chunked
    z = torch.zeros
    prog = (z((1, 2), dtype=torch.int32), z((1, 2), dtype=torch.int32),
            z((1, 2)))
    cube = dict(n_groups=1, gid_col=0, size_col=1, blocks_col=2, sb_col=3,
                ab_col=4, valid_col=5, use_kernel=True)
    return {
        "rwkv6_step": lambda: rwkv6_step(
            z(1, 1, 4), z(1, 1, 4), z(1, 1, 4), z(1, 1, 4), z(1, 4),
            z(1, 1, 4, 4), use_kernel=True),
        "wkv_chunked": lambda: wkv_chunked(
            z(1, 2, 1, 16), z(1, 2, 1, 16), z(1, 2, 1, 16), z(1, 2, 1, 16),
            z(1, 16), use_kernel=True),
        "paged_attention": lambda: paged_attention(
            z(1, 1, 4), z(1, 2, 1, 4), z(1, 2, 1, 4),
            z((1, 1), dtype=torch.int32), z((1,), dtype=torch.int32),
            use_kernel=True),
        "rglru_scan": lambda: rglru_scan(z(1, 2, 4), z(1, 2, 4),
                                         use_kernel=True),
        "policy_scan": lambda: policy_scan(
            z(2, 4), *(p[0] for p in prog), use_kernel=True),
        "policy_scan batch": lambda: policy_scan_batch(
            z(2, 4), *prog, use_kernel=True),
        "policy_scan store": lambda: mesh_policy_scan_batch(
            z(1, 3, 4), z((1, 2)), ops_t=((0, 0),), colidx_t=((0, 0),),
            use_kernel=True),
        "profile_cube": lambda: profile_cube(
            [0], [1.0], [1.0], [1.0], 1, use_kernel=True, device="cpu"),
        "profile_cube store": lambda: mesh_profile_cube(z(1, 6, 4), **cube),
    }


@pytest.mark.parametrize("op", ["rwkv6_step", "paged_attention",
                                "rglru_scan", "policy_scan",
                                "policy_scan batch", "policy_scan store",
                                "profile_cube", "profile_cube store",
                                "wkv_chunked"])
def test_every_op_refuses_use_kernel_true_on_the_cpu(op):
    kernel = op.split()[0]
    with pytest.raises(ValueError, match=f"use_kernel=True needs CUDA "
                       f"tensors: the {kernel} kernel does not run on cpu"):
        _cpu_calls()[op]()
