"""Build the hand-written CUDA kernels into shared libraries with ``nvcc``.

Every kernel package keeps its CUDA C++ in its own ``csrc/`` and compiles
it at first use for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes`` (seconds to build; nothing here includes
PyTorch's headers). A library lands in ``build/repro_torch/`` at the
repository root (or in ``$REPRO_TORCH_BUILD_DIR``), named by a hash of its
sources and the flags, so a changed source is rebuilt and never confused
with an old build. Two packages may build at the same time: each ``nvcc``
writes a temporary file that is renamed into place.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``; else ``build/repro_torch/`` of the
    checkout this file lies in; else, for an installed package, a cache
    under ``$HOME``."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> repository root
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and (root / "src").is_dir():
        return root / "build" / "repro_torch"
    return Path.home() / ".cache" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = Path(cuda_home) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the kernels are built from csrc/ "
                       "with the CUDA toolkit")


def library_path(name: str, csrc: Path, files: Sequence[str]) -> Path:
    """``lib<name>_<hash>.so`` in :func:`build_dir`, the hash taken over
    the flags and every file of ``files`` (sources and headers)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update((csrc / f).read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, csrc: Path, sources: Sequence[str],
          headers: Sequence[str] = ()) -> Path:
    """Compile ``sources`` of ``csrc`` into ``lib<name>_<hash>.so`` unless
    it already exists. Returns its path."""
    out = library_path(name, csrc, tuple(sources) + tuple(headers))
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(csrc / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)             # atomic: concurrent builds race safely
    return out
