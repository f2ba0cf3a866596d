"""A weight leaf of the benchmark's layout and how it is drawn."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One weight: the benchmark's name, the port's name, its shape, the
    dtype it is served in (``"bf16"`` or ``"f32"``) and how it is drawn:
    ``("normal", mean, std)``, ``("uniform", lo, hi)``."""

    name: str
    port: str
    shape: Tuple[int, ...]
    dtype: str
    init: Tuple[str, float, float]

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def normal(std: float, mean: float = 0.0) -> Tuple[str, float, float]:
    return ("normal", mean, std)


def dense(fan_in: int) -> Tuple[str, float, float]:
    """The port's scale for a product's weight: 1 / sqrt(fan in)."""
    return ("normal", 0.0, 1.0 / math.sqrt(fan_in))


def uniform(lo: float, hi: float) -> Tuple[str, float, float]:
    return ("uniform", lo, hi)
