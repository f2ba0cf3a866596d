"""Latent-attention decode over the latent cache: ``ref`` (plain PyTorch),
``kernel`` (CUDA), ``ops``."""
