from .adamw import AdamW, OptState
from .schedules import cosine_warmup

__all__ = ["AdamW", "OptState", "cosine_warmup"]
