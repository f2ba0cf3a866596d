"""Columnar policy scan: ``ref`` (plain PyTorch), ``kernel`` (CUDA), ``ops``."""
