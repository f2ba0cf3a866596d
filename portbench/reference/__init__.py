"""Plain float32 PyTorch forwards of each model family, by which the
served tokens are judged. They import nothing of the port (``repro_torch``)
nor of the JAX package, and take only the benchmark's own weights (drawn
again from the seed) and token ids. Run them with TF32 off."""
