from .adamw import AdamW, OptState
from .schedules import cosine_warmup
from .grad_compression import (compress_int8, decompress_int8,
                               init_error_state, make_compressed_allreduce)

__all__ = ["AdamW", "OptState", "cosine_warmup", "compress_int8",
           "decompress_int8", "init_error_state",
           "make_compressed_allreduce"]
