"""RWKV6 decode-step state update and readout: ``ref`` (plain PyTorch),
``kernel`` (CUDA), ``ops``."""
