"""Paged decode attention: ``ref`` (plain PyTorch), ``kernel`` (CUDA),
``ops``."""
