"""One reader a metric, ``<name>.py``, found by the metric's name in
``BENCHMARK.json``: ``read(run)`` returns the metric's value from what
the run recorded (:class:`portbench.metrics.Run`), or None where there is
nothing to read, and the harness then leaves the metric out."""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Run:
    """What a reader reads: the cell's configuration and traffic, its
    count module (``portbench.count.<family>``), the set-up seconds and
    the window (``portbench.harness.Window``)."""

    config: Dict
    traffic: Dict
    count: ModuleType
    setup_s: float
    window: object


def reader(name: str) -> ModuleType:
    """The reader module of metric ``name`` (file ``<name>.py`` here)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
