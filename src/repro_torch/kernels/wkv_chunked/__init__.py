"""RWKV6's chunked sequence form (the prefill's recurrence): ``ref`` (plain
PyTorch), ``kernel`` (CUDA), ``ops``."""
