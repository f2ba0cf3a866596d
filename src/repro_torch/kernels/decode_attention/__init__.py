"""GQA decode attention over a contiguous cache: ``ref`` (plain PyTorch),
``kernel`` (CUDA), ``ops``."""
