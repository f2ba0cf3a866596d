"""Launching the hand-written kernels, and launch counts that hold across
CUDA graph capture and replay.

Every kernel wrapper counts its launches in a plain integer on its module,
+1 for each launch that did work (:func:`count`). A launch made while the
current stream is being captured into a CUDA graph does no work yet: it is
recorded into the tally of the capture that is open (:func:`capturing`)
instead. The owner of the graph keeps that tally and hands it to
:func:`replayed` after each replay, which adds it to the module counters,
so a window of launches reads the same whether its kernels ran eagerly or
from a graph. :func:`reset` zeroes a module's counters.

:func:`launch` calls a library's C launch function on the current stream
of the tensors' device, entering that device's context only when it is
not the current one already. These run on CUDA tensors only: on a build
of PyTorch without CUDA the ``torch.cuda`` calls here raise.

:func:`kernel_for` is the rule every public op follows on whether its
kernel runs: the device decides.
"""
from __future__ import annotations

import collections
import contextlib
import sys
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

Tally = Dict[Tuple[str, str], int]

# (module name, counter name) -> launches recorded into the open capture;
# captures made outside :func:`capturing` land here and are never replayed
_tally: collections.Counter = collections.Counter()


def count(module: str, counter: str) -> None:
    """One launch of the kernel that ``module.counter`` counts: +1 there,
    or into the open capture's tally while the stream is capturing."""
    if torch.cuda.is_current_stream_capturing():
        _tally[(module, counter)] += 1
    else:
        mod = sys.modules[module]
        setattr(mod, counter, getattr(mod, counter) + 1)


def reset(module: str) -> None:
    """Zeroes every launch counter of ``module``: each int on it whose name
    ends in ``_launches`` (what the benchmark harness reads)."""
    mod = sys.modules[module]
    for name, value in list(vars(mod).items()):
        if name.endswith("_launches") and isinstance(value, int):
            setattr(mod, name, 0)


@contextlib.contextmanager
def capturing() -> Iterator[collections.Counter]:
    """Collects the launches recorded while the block captures a graph;
    yields the tally, complete when the block ends."""
    global _tally
    outer, _tally = _tally, collections.Counter()
    try:
        yield _tally
    finally:
        _tally = outer


def replayed(tally: Tally) -> None:
    """Adds a graph's tally to the module counters: its launches ran."""
    for (module, counter), n in tally.items():
        mod = sys.modules[module]
        setattr(mod, counter, getattr(mod, counter) + n)


def raw_stream(index: int) -> int:
    """The ``cudaStream_t`` of device ``index``'s current stream, as an
    int (a capture's stream while one is open), without building the
    ``torch.cuda.Stream`` object that ``current_stream`` returns."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(fn: Callable[..., int], index: int, *args) -> int:
    """``fn(*args, stream)`` with device ``index`` current and its current
    stream; returns ``fn``'s CUDA error code."""
    if index == torch.cuda.current_device():
        return fn(*args, raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, raw_stream(index))


def kernel_for(device: torch.device, use_kernel: Optional[bool], kernel: str,
               ref: str) -> bool:
    """Whether an op runs ``kernel`` on ``device``: ``use_kernel=None``
    follows the device (the kernel on CUDA, the plain version elsewhere);
    ``True`` off CUDA raises, there being no kernel to run there, and so
    does ``False`` on CUDA, the plain version serving CPU tensors only
    (``ref`` names what to call to run it on the card)."""
    on_card = device.type == "cuda"
    if use_kernel is None:
        return on_card
    if use_kernel and not on_card:
        raise ValueError("use_kernel=True needs CUDA tensors: the "
                         f"{kernel} kernel does not run on {device}")
    if not use_kernel and on_card:
        raise ValueError("use_kernel=False on CUDA tensors: the plain "
                         f"version serves CPU tensors only (call {ref} "
                         "directly to run it on the card)")
    return bool(use_kernel)
