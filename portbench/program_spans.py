"""The program's own spans and build counters, read in ``--trace 1`` runs.

xsmm_tpu_torch records spans at its layer boundaries while
``utils/trace.recording()`` is on (``dispatch``, ``create`` and its
``create.digest``, ``frontend``, ``wrapper``, ``launch``; see that
module), each with its parent and the call it belongs to, on the clock of
``torch.profiler``'s host events.

The first of the new per-layer readers to ask (``of``) runs the passes,
once a run, after ``run.traced``'s two captures and after every reader
listed before them, so that no existing metric and not the breakdown
reads a step run with recording on.  The passes drive a second driver of
the cell, made for them from ``SEED`` (their outputs are not checked) and
freed at their end; its loop is ``run.Loop``:

* set-up, recording on: the creates of the sparse driver's set-up, all
  answered by the registry, since the run's own set-up made the handle;
  the last ``CREATE_HITS`` of them feed ``create_digest_us``;
* one step, recording off, then the span pass: ``trace_steps`` steps,
  recording on and no profiler: the host time of each layer a call
  (``frontend_host_us``, ``wrapper_host_us``, ``launch_host_us``) and a
  step (``dispatch_span_us``);
* the span capture: ``trace_steps`` steps, recording on under a capture
  of the card's activity alone (as the first capture of ``run.traced``):
  the card's idle gaps charged to the innermost span at each gap's middle,
  or to the caller where no span of the program is open
  (``idle_in_program_share``);
* the build counters before the second loop's first step and after its
  last (``window_rebuilds``).

A program without spans (no ``trace.recording``) gives None and runs no
pass; one without ``trace.build_counts`` gives no counts.
"""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from . import trace_reader

CALLER = "caller"   # idle time while no span of the program was open
CREATE_HITS = 32
SEED = 2**31 + 7    # the passes' operands; their outputs are not checked
_KEY = "program_spans"


def _trace():
    """The program's ``utils/trace`` where it records spans, else None."""
    try:
        from xsmm_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace if hasattr(trace, "recording") else None


def _build_counts(trace) -> Optional[Dict[str, int]]:
    if not hasattr(trace, "build_counts"):
        return None
    return dict(trace.build_counts())


def _per_call(spans, self_ns) -> dict:
    """Host ns a call of the entry point (a call whose root span is
    ``frontend``), by layer: self time of ``frontend`` and ``wrapper``,
    the length of ``launch``; and the calls counted."""
    roots = {s.id for s in spans if s.parent is None and s.name == "frontend"}
    out = {"calls": len(roots), "frontend": 0, "wrapper": 0, "launch": 0}
    for s in spans:
        if s.call not in roots or s.name not in out:
            continue
        out[s.name] += (s.end - s.start if s.name == "launch"
                        else self_ns[s.id])
    return out


def _lengths(spans, name: str) -> List[int]:
    return [s.end - s.start for s in spans if s.name == name]


def _span_pass(trace, loop, steps: int, stats):
    with trace.recording() as rec:
        for _ in range(steps):
            loop.step(stats)
    spans = rec.spans()
    return _per_call(spans, rec.self_ns(spans)), _lengths(spans, "dispatch")


def _span_capture(trace, loop, steps: int, cuda: bool, stats):
    """The card's idle ns in the capture's window by the innermost span
    open at each gap's middle (``CALLER`` where none was); None where the
    capture holds no operation on the card."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with trace.recording() as rec:
            loop.sync()
            t0 = time.perf_counter_ns()
            for _ in range(steps):
                loop.step(stats)
            t1 = time.perf_counter_ns()
    w0, w1 = rec.to_clock(t0), rec.to_clock(t1)
    dev = trace_reader._device_ops(prof.profiler.kineto_results.events(),
                                   w0, w1)
    if not dev:
        return None
    _, gaps = trace_reader._busy_and_gaps(dev, w0, w1)
    host = [(s.start, s.end, s.name) for s in rec.spans()]
    charged = trace_reader._charge_gaps(gaps, host)
    if "(no host event)" in charged:
        charged[CALLER] = charged.pop("(no host event)")
    return charged


def _passes(ctx) -> Optional[SimpleNamespace]:
    trace = _trace()
    if trace is None:
        return None
    from . import run as harness

    cuda = ctx.window_peak_bytes is not None
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    steps = int(ctx.traffic["trace_steps"])
    driver = importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}")
    with trace.recording() as rec:
        drv = driver.Driver(ctx.config, ctx.traffic, dev, SEED)
    spans = rec.spans()
    creates = (_lengths(spans, "create")[-CREATE_HITS:],
               _lengths(spans, "create.digest")[-CREATE_HITS:])
    try:
        loop = harness.Loop(drv, sync, SEED)
        before = _build_counts(trace)
        loop.step(harness.Stats())
        stats = harness.Stats()
        per_call, dispatch = _span_pass(trace, loop, steps, stats)
        idle = _span_capture(trace, loop, steps, cuda, harness.Stats())
        after = _build_counts(trace)
    finally:
        drv.release()
    return SimpleNamespace(
        steps=len(stats.step_ns), per_call=per_call, dispatch_ns=dispatch,
        lookup_ns=stats.lookup_ns, issue_ns=stats.issue_ns,
        creates=creates, idle_by_span=idle, builds=(before, after))


def of(ctx) -> Optional[SimpleNamespace]:
    """The passes' readings for the run that ``ctx`` describes, made when
    a reader first asks and kept on ``ctx``; None where the program
    records no spans."""
    if not hasattr(ctx, _KEY):
        setattr(ctx, _KEY, _passes(ctx))
    return getattr(ctx, _KEY)


def mean_us(values: List[int]) -> Optional[float]:
    return sum(values) / len(values) / 1e3 if values else None
