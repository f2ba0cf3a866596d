"""Device resolution for the port's entry points.

Every entry point that touches tensors takes ``device``. The default is
the CUDA card; the CPU is used only when the caller asks for it by name.
There is no silent fallback: with no usable card the default raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# the kernels are compiled for sm_90a only (Hopper: H100 / H200)
REQUIRED_CAPABILITY = (9, 0)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; ``"cpu"`` -> the CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and CUDA is absent, or when the card is not compute
    capability 9.0, the only target the hand-written kernels are built for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch version")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    cap = torch.cuda.get_device_capability(index)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a only")
    return dev
