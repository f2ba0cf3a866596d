"""Fused profile-cube build: ``ref`` (plain PyTorch), ``kernel`` (CUDA),
``ops``."""
