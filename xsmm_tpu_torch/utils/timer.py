"""High-resolution timing + benchmark helpers.

Reference: src/libxsmm_timer.c (TSC ticks).  The port of
``xsmm_tpu/utils/timer.py``.  Launches are asynchronous, so a host clock
around one call measures the enqueue: ``bench`` synchronizes the card
around its timed loop, ``cuda_time_ms`` takes the time between two CUDA
events around many launches, and ``device_bench`` differences two CUDA
graphs of N chained calls, which leaves the host's enqueue time out.

Stated differences from the JAX package: ``device_bench``'s ``probe`` has
no effect (PyTorch neither folds nor drops a call whose result is unused),
and a function that cannot be captured into a CUDA graph raises; there is
no fallback to host timing.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple


def tick() -> float:
    """Analog of libxsmm_timer_tick (libxsmm_timer.c:84)."""
    return time.perf_counter()


def duration(t0: float, t1: float) -> float:
    return t1 - t0


def _sync() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def bench(fn: Callable, *args, warmup: int = 3, iters: int = 20,
          min_time: float = 0.05) -> Tuple[float, int]:
    """Time ``fn(*args)`` -> (seconds_per_call, iters_used).

    Synchronizes the card (where one is in use) around the timed loop;
    auto-scales iterations to ``min_time`` so short calls are measured above
    timer noise.
    """
    for _ in range(max(1, warmup)):
        fn(*args)
    _sync()
    # calibrate
    t0 = tick()
    fn(*args)
    _sync()
    t_one = max(tick() - t0, 1e-9)
    n = max(iters, int(min_time / t_one) + 1)
    t0 = tick()
    for _ in range(n):
        fn(*args)
    _sync()
    dt = (tick() - t0) / n
    return dt, n


def gflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e9


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


def device_bench(fn: Callable, *args, iters: int = 32, base_iters: int = 4,
                 feedback: Optional[Callable] = None, repeats: int = 3,
                 probe: str = "sum", stats: bool = False):
    """Per-call device time of ``fn(*args)`` in seconds, free of host time.

    The analog of the JAX version's "N chained iterations inside one jitted
    computation, two N's differenced" (xsmm_tpu/utils/timer.py:67-173):
    ``base_iters`` and ``iters`` calls are each captured into a CUDA graph,
    each graph is replayed ``repeats`` times between two CUDA events, and
    the difference of the two times over ``iters - base_iters`` is the
    time a call.  A replay runs the captured kernels back to back, so
    neither the host's enqueue time (Python, checks, ctypes) nor the graph
    launch is in the difference.  ``iters`` grows until the difference
    reaches 50 ms, as in the JAX version.

    ``feedback(out, args) -> new_args``, if given, runs between iterations
    inside the capture and threads the output into the next call's inputs.
    ``probe`` has no effect (a stated difference: PyTorch neither folds nor
    removes calls).  ``stats=True`` returns ``(dt, info)`` with the JAX
    version's keys {"dts", "median", "spread", "iters", "repeats"}.

    Raises without a card, and raises naming the failure when ``fn`` cannot
    be captured (a host synchronization, a CPU tensor, a copy to the host).
    """
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("device_bench needs a CUDA device "
                           "(torch.cuda.is_available() is False)")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def chain(n, a):
        for _ in range(n):
            out = fn(*a)
            if feedback is not None:
                a = tuple(feedback(out, a))
        return a

    # warm up on the capture stream: anything made lazily per stream (a
    # library handle, a counter) exists before the capture starts
    with torch.cuda.stream(side):
        chain(2, args)
    torch.cuda.synchronize()

    def capture(n):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                chain(n, args)
        except Exception as e:  # noqa: BLE001 - re-raised with the cause
            raise RuntimeError(
                f"device_bench: {getattr(fn, '__name__', fn)!r} cannot be "
                f"captured into a CUDA graph ({type(e).__name__}: {e})"
            ) from e
        return graph

    def t_all(graph):
        graph.replay()   # warm
        torch.cuda.synchronize()
        ts = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) * 1e-3)
        return ts

    g_base = capture(base_iters)
    t_base = min(t_all(g_base))
    target = 0.05
    max_iters = 1 << 16
    while True:
        g_full = capture(iters)
        ts_full = t_all(g_full)
        diff = min(ts_full) - t_base
        del g_full
        if diff >= target or iters >= max_iters:
            break
        if diff <= 1e-4:
            iters = min(max_iters, iters * 16)
        else:
            need = int((iters - base_iters) * target / diff) + base_iters
            iters = min(max_iters, max(need, iters * 2))
    del g_base
    dt = max(diff, 1e-9) / (iters - base_iters)
    if stats:
        dts = sorted(max(tf - t_base, 1e-9) / (iters - base_iters)
                     for tf in ts_full)
        med = dts[len(dts) // 2]
        info = {"dts": dts, "median": med,
                "spread": (dts[-1] - dts[0]) / med if med else 0.0,
                "iters": iters, "repeats": repeats}
        return dt, info
    return dt
