"""Tracing / profiler integration.

Reference observability stack: self-tracing (src/libxsmm_trace.c, env
LIBXSMM_TRACE), JIT kernel naming for profilers (the jit_name scheme,
libxsmm_main.c:1297), perf-map/jitdump/VTune sinks (src/libxsmm_perf.c).
The port of ``xsmm_tpu/utils/trace.py``:

* kernel naming -> ``torch.profiler.record_function`` (a range in the
  profiler's trace) plus an NVTX range (``torch.cuda.nvtx``, only when a
  card is present), so the entry points' calls show by name around the
  kernels they launch;
* perf map / jitdump -> ``torch.profiler`` with CPU and CUDA activities,
  exported as a Chrome trace (readable by Perfetto or chrome://tracing);
* ``XSMM_TRACE=<dir>`` names the default trace directory.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch

_TRACE_DIR = os.environ.get("XSMM_TRACE", "")
_prof = None
_prof_dir = ""


def kernel_name(kind: str, desc) -> str:
    """Descriptive kernel name (the jit_name scheme analog), e.g.
    ``xsmm_tpu_float32_23x23x23_b1024.smm``: the JAX package's string for
    the same descriptor."""
    m = getattr(desc, "m", "")
    n = getattr(desc, "n", "")
    k = getattr(desc, "k", "")
    dt = getattr(desc, "in_dtype", getattr(desc, "dtype", ""))
    b = getattr(desc, "batch", 1)
    return f"xsmm_tpu_{dt}_{m}x{n}x{k}_b{b}.{kind}"


def _nvtx() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def scope(name: str):
    """Annotate a region: a ``record_function`` range in the profiler's
    trace and, where a card is present, an NVTX range.  Only while a
    ``torch.profiler`` capture runs or ``XSMM_TRACE`` is set: otherwise the
    cost is one flag check."""
    if not (_TRACE_DIR or torch.autograd._profiler_enabled()):
        yield
        return
    nvtx = _nvtx()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def named(kind: str):
    """Decorator: run the function inside ``scope(kind)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(kind):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def start_trace(log_dir: Optional[str] = None) -> str:
    """Begin a ``torch.profiler`` capture (CPU, and CUDA where a card is
    present) whose Chrome trace ``stop_trace`` writes under ``log_dir``
    (default: ``XSMM_TRACE``, else ``xsmm_tpu_torch_trace`` in the working
    directory)."""
    global _prof, _prof_dir
    if _prof is not None:
        raise RuntimeError("a trace is already running (stop_trace first)")
    d = log_dir or _TRACE_DIR or os.path.join(os.getcwd(),
                                              "xsmm_tpu_torch_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _prof, _prof_dir = prof, d
    return d


def stop_trace() -> Optional[str]:
    """End the capture and write its Chrome trace; returns the file's path
    (None when no trace was running)."""
    global _prof
    if _prof is None:
        return None
    prof, _prof = _prof, None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(_prof_dir, exist_ok=True)
    path = os.path.join(_prof_dir, f"xsmm_trace_{os.getpid()}_"
                                   f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_region(log_dir: Optional[str] = None):
    """Trace the region; yields the directory the trace is written to."""
    d = start_trace(log_dir)
    try:
        yield d
    finally:
        stop_trace()


def trace_enabled() -> bool:
    return bool(_TRACE_DIR)
