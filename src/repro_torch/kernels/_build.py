"""Build the hand-written CUDA kernels into shared libraries with ``nvcc``.

Every kernel package keeps its CUDA C++ in its own ``csrc/`` and compiles
it at first use for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes`` (seconds to build; nothing here includes
PyTorch's headers). A library lands in ``build/repro_torch/`` at the
repository root (or in ``$REPRO_TORCH_BUILD_DIR``), named by a hash of its
sources and the flags, so a changed source is rebuilt and never confused
with an old build. Two packages may build at the same time: each ``nvcc``
writes a temporary file that is renamed into place.

Each package's ``kernel.py`` holds one :class:`Library`: the build, the
load (once, whichever threads ask first), the bindings its ``bind`` sets,
and the library's own text for a CUDA error code its functions return.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

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


class Library:
    """The shared library ``lib<name>_<hash>.so`` of ``sources`` in
    ``csrc`` (``headers`` are hashed, not compiled). ``bind(lib)`` sets the
    argtypes and restypes of its functions once it is loaded;
    ``<name>_error_string`` is bound here."""

    def __init__(self, name: str, csrc: Path, sources: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None],
                 headers: Sequence[str] = ()):
        self.name, self.csrc, self.bind = name, csrc, bind
        self.sources, self.headers = tuple(sources), tuple(headers)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the library lies in :func:`build_dir`, the hash taken over
        the flags and every source and header."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in self.sources + self.headers:
            h.update((self.csrc / f).read_bytes())
        return build_dir() / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the sources unless the library already exists. Returns
        its path."""
        out = self.path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(self.csrc / s) for s in self.sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {self.name} "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)         # atomic: concurrent builds race safely
        return out

    def get(self) -> ctypes.CDLL:
        """The library, built if need be, loaded and bound once however
        many threads ask at first."""
        lib = self._lib
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self.bind(lib)
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str) -> None:
        """Raises ``RuntimeError`` with the library's own text for ``err``,
        a CUDA error code one of its functions returned, unless it is 0."""
        if err != 0:
            text = getattr(self.get(), f"{self.name}_error_string")(err)
            raise RuntimeError(f"{self.name} {what} failed: "
                               f"{text.decode()}")
