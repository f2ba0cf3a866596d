"""RG-LRU diagonal linear recurrence: ``ref`` (plain PyTorch), ``kernel``
(CUDA), ``ops``."""
