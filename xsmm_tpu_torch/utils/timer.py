"""Timing on the card with CUDA events.

Reference: src/libxsmm_timer.c.  Launches are asynchronous, so a host clock
around one call measures the enqueue; the time of a kernel is taken between
two ``torch.cuda.Event(enable_timing=True)`` around many launches, after a
warm-up, and divided by the count.
"""

from __future__ import annotations

from typing import Callable


def cuda_time_ms(fn: Callable, *args, warmup: int = 3, iters: int = 20) -> float:
    """Milliseconds per call of ``fn(*args)`` on the card: ``warmup`` calls,
    then ``iters`` calls between two CUDA events, synchronized.  Raises
    without a card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device "
                           "(torch.cuda.is_available() is False)")
    for _ in range(max(warmup, 1)):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters
