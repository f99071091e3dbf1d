"""Tracing / profiler integration: the port's spans and build counters.

Reference observability stack: self-tracing (src/libxsmm_trace.c, env
LIBXSMM_TRACE), JIT kernel naming for profilers (the jit_name scheme,
libxsmm_main.c:1297), perf-map/jitdump/VTune sinks (src/libxsmm_perf.c).
The port of ``xsmm_tpu/utils/trace.py``:

* kernel naming -> ``scope(kernel_name(...))`` at the entry points: a
  ``torch.profiler.record_function`` range (a range in the profiler's
  trace) plus an NVTX range (``torch.cuda.nvtx``, only when a card is
  present), so the entry points' calls show by name around the kernels
  they launch; only while a profiler runs or ``XSMM_TRACE`` is set;
* spans -> ``span(name)`` at the layer boundaries of the main path, kept
  in memory while ``recording()`` is on (nothing is written during the
  run) and opening no profiler range; an entry point's ``scope`` is the
  outer span of its call (``layer``).  Span names and where they sit:

  ========================  ==============================================
  ``dispatch``              ``ops/smm``'s typed dispatchers and
                            ``mmdispatch``, hit or miss
  ``registry.build``        ``Registry.dispatch``'s call of the builder
  ``create``                ``ops/spgemm.create_csr_soa`` (every create)
  ``create.digest``         the operator's ``Csr.structure_digest()``
  ``frontend``              the entry points' scopes (``BatchedSMM``
                            ``__call__`` / ``packed``, ``CsrSpgemm``
                            ``__call__`` / ``acc_fn``)
  ``wrapper``               the kernel wrappers of ``ops/smm_packed`` and
                            ``ops/spgemm_kernels``: checks, route or
                            staging, output allocation
  ``launch``                ``ops/cuda_build.launch``: the ctypes call to
                            its return code
  ========================  ==============================================

  Spans are stamped on the clock of ``torch.profiler``'s host events
  (Unix-epoch ns): ``time.perf_counter_ns`` read at each end, mapped
  through the (``perf_counter_ns``, ``time_ns``) pairs read when the
  recording starts and when it stops;
* perf map / jitdump -> ``torch.profiler`` with CPU and CUDA activities,
  exported as a Chrome trace (readable by Perfetto or chrome://tracing);
  spans recorded inside ``trace_region`` go into the same file, on a
  thread row of their own;
* ``build_counts()``: what the port has built, compiled, loaded, picked
  and captured so far, from counters that move only on the cold path;
* ``XSMM_TRACE=<dir>`` names the default trace directory.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

_TRACE_DIR = os.environ.get("XSMM_TRACE", "")
_prof = None
_prof_dir = ""

# the recording on, if any: spans check this flag and nothing else when off
_ON = False
_REC: Optional["Recording"] = None
# its log while on: (thread, span name or None for an end, perf_counter_ns)
_LOG: list = []
_clock = time.perf_counter_ns
_thread = threading.get_ident


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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span: its id, its parent's (None at a call's root),
    the call's (the root span's id), its name, and its start and end in
    ns on the profiler's clock."""
    id: int
    parent: Optional[int]
    call: int
    name: str
    start: int
    end: int


class _Null:
    """The shared context of every span while nothing is recorded."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """The context of the spans named ``name`` while a recording is on,
    one for each name, shared by every thread: its start and its end go
    into the recording's log."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _LOG.append((_thread(), self.name, _clock()))
        return None

    def __exit__(self, *exc):
        _LOG.append((_thread(), None, _clock()))
        return False


_SPANS: Dict[str, _Span] = {}


def span(name: str):
    """A span named ``name``, recorded while ``recording()`` is on; when
    it is off, the shared no-op context."""
    if not _ON:
        return _NULL
    got = _SPANS.get(name)
    if got is None:
        got = _SPANS[name] = _Span(name)
    return got


class Recording:
    """What ``recording()`` saw: the log of every span's start and end, in
    any thread, and the clock's anchors."""

    def __init__(self):
        self.log: list = []
        self.anchors = [(_clock(), time.time_ns())]

    def to_clock(self, ns: int) -> int:
        """A ``perf_counter_ns`` reading on the profiler's clock, by the
        line through the anchors (the start's and, once stopped, the
        stop's)."""
        (p0, w0), (p1, w1) = self.anchors[0], self.anchors[-1]
        if p1 == p0:
            return w0 + (ns - p0)
        return w0 + (ns - p0) * (w1 - w0) // (p1 - p0)

    def spans(self) -> List[Span]:
        """Every span that ended, sorted by start, numbered from 1 in that
        order; each thread's spans nest by the order of its log."""
        stacks: Dict[int, list] = {}
        done = []
        for n, (tid, name, t) in enumerate(self.log):
            stack = stacks.setdefault(tid, [])
            if name is not None:
                parent = stack[-1] if stack else None
                stack.append([n, parent, name, t])
            elif stack:
                done.append((*stack.pop(), t))
        done.sort()
        ids = {rec[0]: i for i, rec in enumerate(done, 1)}
        calls: Dict[int, int] = {}
        out = []
        for n, parent, name, t0, t1 in done:
            sid = ids[n]
            pid = ids.get(parent[0]) if parent is not None else None
            calls[sid] = calls[pid] if pid is not None else sid
            out.append(Span(sid, pid, calls[sid], name, self.to_clock(t0),
                            self.to_clock(t1)))
        return out

    def self_ns(self, spans: Optional[List[Span]] = None) -> Dict[int, int]:
        """Each span's self time (its length less those of its children),
        by id."""
        spans = self.spans() if spans is None else spans
        out = {s.id: s.end - s.start for s in spans}
        for s in spans:
            if s.parent in out:
                out[s.parent] -= s.end - s.start
        return out


@contextlib.contextmanager
def recording():
    """Record every span opened in the block, in any thread; yields the
    ``Recording``, whose spans are read once the block ends."""
    global _ON, _REC, _LOG
    if _REC is not None:
        raise RuntimeError("a recording is already on")
    rec = Recording()
    _REC, _LOG, _ON = rec, rec.log, True
    try:
        yield rec
    finally:
        _ON = False
        rec.anchors.append((_clock(), time.time_ns()))
        _REC, _LOG = None, []


def recording_on() -> bool:
    return _ON


# ---------------------------------------------------------------------------
# Named ranges: the entry points' scopes
# ---------------------------------------------------------------------------


def _nvtx() -> bool:
    return torch.cuda.is_available()


class _Scope:
    """A profiler range (and NVTX range) named ``name``, inside the span
    ``layer`` where one is given and a recording is on."""
    __slots__ = ("name", "span", "rf", "nvtx")

    def __init__(self, name: str, layer: Optional[str]):
        self.name = name
        self.span = span(layer) if layer else _NULL

    def __enter__(self):
        self.span.__enter__()
        self.nvtx = _nvtx()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        try:
            try:
                self.rf.__exit__(*exc)
            finally:
                if self.nvtx:
                    torch.cuda.nvtx.range_pop()
        finally:
            self.span.__exit__(*exc)
        return False


def scope(name: str, layer: Optional[str] = None):
    """Annotate a region: a ``record_function`` range in the profiler's
    trace and, where a card is present, an NVTX range, both named
    ``name``, only while a ``torch.profiler`` capture runs or
    ``XSMM_TRACE`` is set; and, while a recording is on, the span
    ``layer`` where one is given.  Otherwise the shared no-op context."""
    if _TRACE_DIR or torch.autograd._profiler_enabled():
        return _Scope(name, layer)
    if _ON and layer:
        return span(layer)
    return _NULL


def named(kind: str):
    """Decorator: run the function inside ``scope(kind)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(kind):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# Build counters
# ---------------------------------------------------------------------------


def build_counts() -> Dict[str, int]:
    """What the port has built so far in this process: CUDA libraries
    compiled and loaded (``ops/cuda_build``), sparse routes picked
    (``ops/spgemm_kernels.pick_route``'s cache misses), kernels built by
    the registry (its ``njit``) and CUDA graphs captured
    (``utils/graphs``).  Each moves only on a cold path."""
    from ..core import registry
    from ..ops import cuda_build, spgemm_kernels
    from . import graphs

    reg = registry._REGISTRY
    return {"compiled": cuda_build.builds["compiled"],
            "loaded": cuda_build.builds["loaded"],
            "routes": spgemm_kernels.routes_picked,
            "jit": reg.stats.njit if reg is not None else 0,
            "captures": graphs.captures}


# ---------------------------------------------------------------------------
# Chrome traces
# ---------------------------------------------------------------------------


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


def _add_spans(path: str, rec: Recording) -> None:
    """Write the recording's finished spans into the Chrome trace at
    ``path``: complete events on the thread row "xsmm_tpu_torch spans" of
    this process, on the trace's own time base."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), "xsmm_tpu_torch spans"
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": tid}})
    for s in rec.spans():
        events.append({"ph": "X", "cat": "xsmm_span", "name": s.name,
                       "pid": pid, "tid": tid, "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"id": s.id, "parent": s.parent,
                                "call": s.call}})
    with open(path, "w") as f:
        json.dump(doc, f)


def stop_trace() -> Optional[str]:
    """End the capture and write its Chrome trace, with the spans recorded
    so far where a recording is on; returns the file's path (None when no
    trace was running)."""
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
    if _REC is not None:
        _add_spans(path, _REC)
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
