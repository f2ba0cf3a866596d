"""Model zoo: the reference's backbone for all 10 architectures
(``transformer.Model``), in PyTorch."""
from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                     TRAIN_4K, LayerSpec, ModelConfig, MoeSpec, ShapeSpec,
                     is_subquadratic, shapes_for)
from .transformer import Model

__all__ = ["Model", "ModelConfig", "LayerSpec", "MoeSpec", "ShapeSpec",
           "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K", "is_subquadratic", "shapes_for"]
