"""The ring's schedule, read back from a profiler trace: the analog of
``xsmm_tpu/parallel/aot_check.py``'s ``permute_overlap`` and
``check_ring`` (aot_check.py:78-183).

The JAX package compiles the chunked CSR ring for a TPU topology and reads
the scheduled HLO: each collective-permute start/done pair must bracket
compute of the other sub-panels, and the rotation must not be hoisted ahead
of the kernels.  On the card the schedule is what the streams ran, so this
module reads it from a ``torch.profiler`` Chrome trace of
``dist_spmm.ring_spmm_csr``: every device kernel and copy is tied, through
its launch's correlation id, to the ``ring.compute r<e> i<i> s<s>`` or
``ring.hop r<q>->r<e> i<i> s<s>`` range the ring opened around it on the
host.

The criterion is the JAX check's:
* every hop of sub-panel s lies under compute of another sub-panel (the
  copy overlaps a kernel of sub-panel s' != s in time);
* no hop is hoisted: the hop of sub-panel s at step i starts after the
  sending rank's compute of (s, i) ended (the event order of the ring);
* one panel image per chunk is live: on each rank, a sub-panel's images
  overlap in time at most two at once, the one being sent and the one
  arriving (a hoisted rotation holds up to d).

``aot_check.py``'s train-step check (aot_check.py:186-290) asserts a TPU's
scheduled HLO of the sharded train step; it has no CUDA counterpart here
(the port's lock-step executor has no compiler schedule to read) and stays
TPU-only.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

_COMPUTE = re.compile(r"ring\.compute r(\d+) i(\d+) s(\d+)")
_HOP = re.compile(r"ring\.hop r(\d+)->r(\d+) i(\d+) s(\d+)")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def intervals_from_trace(trace) -> List[Dict]:
    """The ring's device intervals from a Chrome trace (a path or the
    loaded dict): one dict a device event, with ``kind`` ("compute" or
    "hop"), ``rank`` (the rank it ran for: the computing or receiving
    rank), ``src`` (a hop's sending rank), ``step``, ``chunk``, ``start``
    and ``end`` (µs), ``name`` (the device event's) and ``cat``.

    A launch belongs to the innermost ring range on its host thread that
    holds its timestamp; its device event carries the same correlation
    id."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if "traceEvents" in trace else trace
    ranges = []
    launches = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        args = ev.get("args") or {}
        if cat in _DEVICE_CATS:
            device.append(ev)
        elif "correlation" in args:
            launches[args["correlation"]] = ev
        elif _COMPUTE.search(name) or _HOP.search(name):
            ranges.append(ev)
    out = []
    for ev in device:
        corr = (ev.get("args") or {}).get("correlation")
        launch = launches.get(corr)
        if launch is None:
            continue
        ts, tid, pid = launch["ts"], launch.get("tid"), launch.get("pid")
        best = None
        for r in ranges:
            if (r.get("tid") == tid and r.get("pid") == pid
                    and r["ts"] <= ts <= r["ts"] + r.get("dur", 0)):
                if best is None or r.get("dur", 0) < best.get("dur", 0):
                    best = r
        if best is None:
            continue
        start = float(ev["ts"])
        item = {"start": start, "end": start + float(ev.get("dur", 0)),
                "name": ev.get("name", ""), "cat": ev.get("cat", ""),
                "stream": (ev.get("args") or {}).get("stream")}
        m = _COMPUTE.search(best["name"])
        if m:
            item.update(kind="compute", rank=int(m.group(1)),
                        step=int(m.group(2)), chunk=int(m.group(3)))
        else:
            m = _HOP.search(best["name"])
            item.update(kind="hop", src=int(m.group(1)), rank=int(m.group(2)),
                        step=int(m.group(3)), chunk=int(m.group(4)))
        out.append(item)
    return out


def _merge(items: List[Dict]) -> Dict[tuple, Dict]:
    """One interval per (kind, rank, step, chunk): a compute may launch
    several kernels and a hop copy two streams."""
    got: Dict[tuple, Dict] = {}
    for it in items:
        key = (it["kind"], it["rank"], it["step"], it["chunk"])
        cur = got.get(key)
        if cur is None:
            got[key] = dict(it)
        else:
            cur["start"] = min(cur["start"], it["start"])
            cur["end"] = max(cur["end"], it["end"])
    return got


def _overlap(a: Dict, b: Dict) -> float:
    return max(0.0, min(a["end"], b["end"]) - max(a["start"], b["start"]))


def hop_overlap(items: List[Dict], chunks: int, d: int) -> Dict:
    """The JAX check's statistics on the ring's intervals (``items`` from
    ``intervals_from_trace`` or made by hand).

    For each hop: the device time it shares with compute of another
    sub-panel (``under_other``), and whether it started after the sending
    rank's compute of its own (step, sub-panel) ended (``ordered``).  Per
    rank and sub-panel, the most panel images live at once: image i of a
    sub-panel on a rank is born when the hop bringing it starts (image 0
    at the start) and dies when the last of its compute and its outgoing
    hop ends."""
    by = _merge(items)
    computes = [v for k, v in by.items() if k[0] == "compute"]
    hop_list = [v for k, v in by.items() if k[0] == "hop"]
    under, ordered = [], []
    for h in hop_list:
        others = sum(_overlap(h, c) for c in computes
                     if c["chunk"] != h["chunk"])
        under.append(others)
        mine = by.get(("compute", h["src"], h["step"], h["chunk"]))
        ordered.append(mine is None or h["start"] >= mine["end"] - 1e-3)
    live = 0
    ranks = sorted({v["rank"] for v in by.values()})
    for r in ranks:
        for s in range(chunks):
            images = []
            for i in range(d):
                hop_in = by.get(("hop", r, i - 1, s)) if i else None
                born = hop_in["start"] if hop_in else float("-inf")
                ends = [v["end"] for v in (
                    by.get(("compute", r, i, s)),
                    next((h for h in hop_list if h["src"] == r
                          and h["step"] == i and h["chunk"] == s), None))
                    if v is not None]
                if ends:
                    images.append((born, max(ends)))
            for b, _ in images:
                live = max(live, sum(1 for b2, e2 in images
                                     if b2 <= b < e2))
    return {
        "hops": len(hop_list),
        "expected_hops": None,
        "under_compute": sum(1 for u in under if u > 0),
        "ordered": sum(ordered),
        "min_under_us": min(under) if under else 0.0,
        "max_live_images": live,
        "computes": len(computes),
    }


def check_schedule(items: List[Dict], chunks: int, d: int,
                   ranks: Optional[int] = None) -> Dict:
    """``hop_overlap`` plus the verdicts: ``overlap_ok`` (every hop under
    compute of another sub-panel), ``order_ok`` (no hop hoisted),
    ``live_ok`` (at most two images of a sub-panel live on a rank) and
    ``hops_ok`` ((d - 1) * chunks hops a rank where ``ranks`` is given)."""
    st = hop_overlap(items, chunks, d)
    if ranks is not None:
        st["expected_hops"] = ranks * (d - 1) * chunks
    st["hops_ok"] = ranks is None or st["hops"] == st["expected_hops"]
    st["overlap_ok"] = st["hops"] > 0 and st["under_compute"] == st["hops"]
    st["order_ok"] = st["ordered"] == st["hops"]
    st["live_ok"] = st["max_live_images"] <= 2
    st["ok"] = all(st[k] for k in ("hops_ok", "overlap_ok", "order_ok",
                                   "live_ok"))
    return st


def replay_overlap(trace) -> Dict:
    """Copies and kernels of a trace without the ring's ranges (a CUDA
    graph's replay carries one correlation id): how many copies overlap a
    kernel in time, and the device time of each kind."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    ev = [e for e in trace.get("traceEvents", trace)
          if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy")]
    ks = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
          if e["cat"] == "kernel"]
    cs = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
          if e["cat"] == "gpu_memcpy"]
    under = sum(1 for a, z in cs
                if any(min(z, kz) - max(a, ka) > 0 for ka, kz in ks))
    span = (max(z for _, z in ks + cs) - min(a for a, _ in ks + cs)
            if ks or cs else 0.0)
    return {"kernels": len(ks), "copies": len(cs),
            "copies_under_kernel": under,
            "kernel_us": sum(z - a for a, z in ks),
            "copy_us": sum(z - a for a, z in cs), "span_us": span}


def check_ring(d: int = 4, chunks: int = 4, n: int = 65536, op=None,
               dtype: str = "float32", f64_schedule: str = "split2",
               trace_path: Optional[str] = None, seed: int = 0,
               graph: bool = False) -> Dict:
    """Run ``ring_spmm_csr`` over ``d`` ranks on the card (virtual ranks on
    ``cuda:0`` when there are fewer cards) in its eager form
    (``compiled=False``) under ``torch.profiler`` and check its schedule
    (the Chrome trace written to ``trace_path``, by default
    ``xsmm_tpu_torch_trace/ring_trace.json`` in the working directory).
    ``op`` is the operator (default: a 150 x 150 operator at 5 % density
    from ``seed``).  Also reports where the hops' copies ran: as copies (a
    copy engine, "gpu_memcpy") or as kernels.  With ``graph``, also the
    compiled form, the entry point's default: the trace of a replay of its
    graph (``replay_overlap``: its ranges are gone, so only the copies
    overlapping kernels are counted), and the ms of the eager call, of the
    compiled call (its replay, the result copied out) and of the replay
    alone.  Needs a card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import dist_spmm
    from .mesh import make_mesh, virtual_devices

    if not torch.cuda.is_available():
        raise RuntimeError("check_ring needs a CUDA card")
    devs = virtual_devices(d)
    mesh = make_mesh((1, d), ("dp", "mp"), devices=devs)
    if op is None:
        rng = np.random.default_rng(seed)
        op = np.where(rng.random((150, 150)) < 0.05,
                      rng.standard_normal((150, 150)), 0.0)
    fn = dist_spmm.ring_spmm_csr(mesh, op, n, dtype=dtype, chunks=chunks,
                                 f64_schedule=f64_schedule, compiled=False)
    n_b = fn.streams[0]
    k = -(-op.shape[1] // d) * d
    gen = torch.Generator(device=devs[0]).manual_seed(seed)
    bs = [dist_spmm.shard_rows(mesh, torch.randn((k, n), generator=gen,
                                                 device=devs[0]))
          for _ in range(n_b)]
    fn(*bs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False) as prof:
        fn(*bs)      # the ring's scopes open ranges under the profiler
        torch.cuda.synchronize()
    path = trace_path or os.path.join("xsmm_tpu_torch_trace",
                                      "ring_trace.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    items = intervals_from_trace(path)
    st = check_schedule(items, chunks, d, ranks=d)
    hop_cats = sorted({it["cat"] for it in items if it["kind"] == "hop"})
    st.update(devices=d, chunks=chunks, dtype=dtype, trace=path,
              hop_device_events=hop_cats,
              device_events=len(items))
    if graph:
        from ..utils.timer import cuda_time_ms

        cfn = dist_spmm.ring_spmm_csr(mesh, op, n, dtype=dtype,
                                      chunks=chunks,
                                      f64_schedule=f64_schedule)
        cfn(*bs)     # the warm-up and the capture
        entry = cfn.entry(*bs)
        entry.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            entry.replay()
            torch.cuda.synchronize()
        gpath = path[:-len(".json")] + "_graph.json" \
            if path.endswith(".json") else path + "_graph"
        prof.export_chrome_trace(gpath)
        st["graph"] = dict(replay_overlap(gpath), trace=gpath,
                           eager_ms=cuda_time_ms(fn, *bs, warmup=1,
                                                 iters=5),
                           call_ms=cuda_time_ms(cfn, *entry.args,
                                                warmup=2, iters=20),
                           replay_ms=cuda_time_ms(entry.replay, warmup=2,
                                                  iters=20))
    return st
