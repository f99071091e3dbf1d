"""Reduce the ``torch.profiler`` captures of the traced window to what the
per-layer metrics and the breakdown read.

A traced run makes two captures.  The first records the card's activity
alone, with no host events and no spans, so that the profiler's host-side
cost stays out of the idle share as far as it can: the busy time, the
device operations and the port's kernels come from it (``summarize``).
The second adds the host's events and the benchmark's spans, only to charge
the card's idle gaps to what the host was doing (``idle_by_host``).

Device operations are the CUDA kernels, copies and sets on the card's
timeline (the profiler's annotation spans there are left out).  The port's
own kernels are the ``__global__`` functions of the program's CUDA sources
(``ops/csrc/*.cu``), matched by name.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def port_kernel_names(csrc: Path) -> Set[str]:
    """The names of the ``__global__`` functions in ``csrc/*.cu``: the
    identifier after ``__global__ void`` and any ``__attr__(...)``."""
    names = set()
    for src in sorted(Path(csrc).glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            i = m.end()
            while True:
                attr = re.match(r"__\w+__\s*", text[i:])
                if not attr:
                    break
                i += attr.end()
                if text[i:i + 1] == "(":   # skip the balanced arguments
                    depth = 0
                    while True:
                        depth += {"(": 1, ")": -1}.get(text[i], 0)
                        i += 1
                        if depth == 0:
                            break
                    i += len(text[i:]) - len(text[i:].lstrip())
            ident = re.match(r"\w+", text[i:])
            if ident:
                names.add(ident.group(0))
    return names


_ANON = "(anonymous namespace)::"


def base_name(name: str) -> str:
    """A kernel's identifier from its demangled name: ``void ns::k<T>(..)``
    -> ``k``."""
    s = name.replace(_ANON, "").strip()
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.split("::")[-1].strip()


def short_name(name: str, limit: int = 96) -> str:
    """A device op's name without its argument list, at most ``limit``
    characters."""
    s = name.replace(_ANON, "")
    if not s.startswith("Memcpy"):
        s = s.split("(", 1)[0]
    return s[:limit]


@dataclass
class TraceSummary:
    window_ns: int
    busy_ns: int
    device_ns: Dict[str, int] = field(default_factory=dict)  # by short name
    port_ns: int = 0
    other_ns: int = 0
    idle_by_host: Dict[str, int] = field(default_factory=dict)


def _is_device(ev) -> bool:
    """A kernel, copy or set on the card: by the event's activity type
    where the profiler gives it, else any device event that is not an
    annotation."""
    if not str(ev.device_type()).endswith("CUDA"):
        return False
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind()).lower() in _DEVICE_KINDS
    return not ev.is_user_annotation()


def _device_ops(events, t0_ns: Optional[int] = None,
                t1_ns: Optional[int] = None) -> List[Tuple[int, int, str]]:
    """The device operations, clipped to [t0_ns, t1_ns] where given."""
    out = []
    for ev in events:
        if not _is_device(ev):
            continue
        s, e = ev.start_ns(), ev.end_ns()
        if t0_ns is not None:
            if e <= t0_ns or s >= t1_ns:
                continue
            s, e = max(s, t0_ns), min(e, t1_ns)
        out.append((s, e, ev.name()))
    return sorted(out)


def _busy_and_gaps(dev: List[Tuple[int, int, str]], t0_ns: int,
                   t1_ns: int) -> Tuple[int, List[Tuple[int, int]]]:
    """The union's length of the sorted operations ``dev``, and the gaps
    between them within [t0_ns, t1_ns]."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    last_end = t0_ns
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1_ns > last_end:
        gaps.append((last_end, t1_ns))
    return busy, gaps


def summarize(events, window_ns: int, port_names: Set[str]) -> TraceSummary:
    """A capture of the card's activity alone (no host events, no spans):
    ``window_ns`` is its length on the host's clock, from a synchronize
    before its first step to the one that ends its last, so every
    operation it holds lies inside it."""
    dev = _device_ops(events)
    summ = TraceSummary(window_ns=window_ns, busy_ns=0)
    for s, e, name in dev:
        d = e - s
        key = short_name(name)
        summ.device_ns[key] = summ.device_ns.get(key, 0) + d
        if base_name(name) in port_names:
            summ.port_ns += d
        else:
            summ.other_ns += d
    if dev:
        summ.busy_ns, _ = _busy_and_gaps(dev, dev[0][0], dev[-1][1])
    if summ.busy_ns > window_ns:
        raise ValueError(f"the card was busy {summ.busy_ns} ns in a window "
                         f"of {window_ns} ns")
    return summ


def idle_by_host(events, window: str) -> Dict[str, int]:
    """A capture with host events and spans: the idle gaps of the card
    within the host span named ``window``, in ns, charged to the innermost
    host event that spans each gap's middle."""
    spans = [e for e in events if e.name() == window
             and str(e.device_type()).endswith("CPU")]
    if not spans:
        return {}
    t0_ns, t1_ns = spans[0].start_ns(), spans[0].end_ns()
    host = [(e.start_ns(), e.end_ns(), e.name()) for e in events
            if str(e.device_type()).endswith("CPU")
            and e.end_ns() > t0_ns and e.start_ns() < t1_ns]
    _, gaps = _busy_and_gaps(_device_ops(events, t0_ns, t1_ns), t0_ns, t1_ns)
    return _charge_gaps(gaps, host)


def _charge_gaps(gaps: List[Tuple[int, int]],
                 host: List[Tuple[int, int, str]]) -> Dict[str, int]:
    """Idle ns by the innermost host event spanning each gap's middle."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, int] = {}
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        j = bisect.bisect_right(starts, mid)
        best = None
        for s, e, name in host[max(0, j - 400):j]:
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        label = best[1] if best else "(no host event)"
        out[label] = out.get(label, 0) + (ge - gs)
    return out


def top(d: Dict[str, int], n: int = 10) -> List[List]:
    """The ``n`` largest entries as [[name, seconds], ...]."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in items]
