"""PyTorch/CUDA port of the Robinhood policy engine reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``repro_torch.core.policy_engine.PolicyEngine``,
``repro_torch.kernels.policy_scan.ops.match_programs``, ...) and imports
nothing of it. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
