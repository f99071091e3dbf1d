"""Headline benchmark of the port: batched FP64 SMM 23x23x23.

    python -m xsmm_tpu_torch.bench        # on the card
    XSMM_TARGET=cpu python -m xsmm_tpu_torch.bench

The counterpart of the repository's root ``bench.py`` (BASELINE.json config
#1), which measures the JAX package.  Prints ONE JSON line with the root
bench's keys: ``metric`` (the same name), ``value`` (GFLOP/s), ``unit``,
``vs_baseline`` = achieved / (0.80 x roofline) and ``detail``.

* The timed function is the split2_fast kernel (``BatchedSMM.packed``) on
  device-resident packed planes, B = 131072 on the card (512 on the CPU
  target; ``XSMM_BENCH_B`` overrides), timed with ``utils/timer.
  device_bench`` (two CUDA graphs of chained calls, differenced) on the
  card and with ``timer.bench`` on the CPU.
* Two yardsticks: ``roofline_frac`` is the root bench's (f64-equivalent
  I/O, 24 B a problem element: (MK + KN + MN) x 8 B at the card's memory
  rate); ``plane_bound_frac`` counts the bytes the split2_fast planes
  really move (A hi, B hi and lo, C: 16 B a problem element).
* ``detail`` adds the float32 schedule's GFLOP/s, the dispatch hit in µs
  (a memoized ``dmmdispatch``), the whole numpy-f64-in, numpy-f64-out call
  (first and median of 5) beside its link bound (the bytes that cross over
  the measured pinned rates, plus the kernel) and the card's name and power
  limit as ``nvidia-smi`` prints them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# memory rate (bytes/s) by device name: the H100 SXM's HBM3 (NVIDIA's data
# sheet; the PCIe and NVL cards have other rates and are not listed, so they
# raise), and a nominal figure for the CPU target (CI only)
HBM_BW = {
    "H100 80GB HBM3": 3.35e12,
    "cpu": 100e9,
}


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else (
        f"nvidia-smi failed ({r.returncode})")


def pinned_rates(nbytes: int):
    """(host-to-card, card-to-host) bytes/s of one ``copy_`` of ``nbytes``
    between a pinned host buffer and the card, CUDA events around it."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    rates = []
    for dst, src in ((dev, host), (host, dev)):
        dst.copy_(src, non_blocking=True)   # warm
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
        rates.append(nbytes / (min(ms) * 1e-3))
    return tuple(rates)


def run() -> dict:
    """Measure config #1 and return the result dict (main() prints it)."""
    import numpy as np
    import torch

    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.utils import timer

    m = n = k = 23
    dev = xp.platform.device()
    on_card = dev.type == "cuda"
    batch = int(os.environ.get("XSMM_BENCH_B", 131072 if on_card else 512))

    # the headline measures the packed kernel (the default f64 schedule)
    # whatever XSMM_SMM_BACKEND routes to
    xp.set_config(smm_backend="pallas")
    strategy = xp.get_config().f64_strategy
    kern = xp.dmmdispatch(m, n, k, batch=batch, beta=0.0)
    g = torch.Generator(device=dev).manual_seed(0)
    # device-resident operands in the packed layout (hi/lo f32 planes): A is
    # m-leading [M, K, B], B k-leading [K, N, B] (ops/smm.py)
    ah = torch.randn((m, k, batch), generator=g, device=dev)
    bh = torch.randn((k, n, batch), generator=g, device=dev)
    ops = {"split2": (ah, ah * 1e-8, bh, bh * 1e-8),
           "split2_fast": (ah, bh, bh * 1e-8)}.get(strategy, (ah, bh))

    def timed(fn, *args):
        if on_card:
            return timer.device_bench(fn, *args, iters=40, base_iters=8,
                                      stats=True)
        dt_, _ = timer.bench(fn, *args, warmup=1, iters=3)
        return dt_, None

    dt, stats = timed(kern.packed, *ops)
    spread = round(stats["spread"], 3) if stats else None

    flops = 2 * m * n * k * batch
    nbytes = (m * k + k * n + m * n) * batch * 8  # f64-equivalent I/O
    planes = {"split2": (2, 2, 2), "split2_fast": (1, 2, 1)}.get(
        strategy, (1, 1, 1))
    plane_bytes = (planes[0] * m * k + planes[1] * k * n
                   + planes[2] * m * n) * batch * 4
    gflops = flops / dt / 1e9
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    bw = next((v for key, v in HBM_BW.items() if key in kind), None)
    if bw is None:
        raise RuntimeError(f"no memory rate known for {kind!r}")
    roofline = flops / nbytes * bw / 1e9
    target = 0.80 * roofline

    # the float32 schedule on the same planes (hi only)
    prev = xp.get_config().f64_strategy
    try:
        xp.set_config(f64_strategy="float32")
        kf = xp.dmmdispatch(m, n, k, batch=batch, beta=0.0)
        dtf, _ = timed(kf.packed, ah, bh)
    finally:
        xp.set_config(f64_strategy=prev)

    # the dispatch hit: a memoized dmmdispatch, host clock
    xp.dmmdispatch(m, n, k, batch=batch, beta=0.0)
    hits = 20000
    t0 = time.perf_counter()
    for _ in range(hits):
        xp.dmmdispatch(m, n, k, batch=batch, beta=0.0)
    hit_us = (time.perf_counter() - t0) / hits * 1e6

    # the whole call as a user makes it: numpy f64 in, numpy f64 out
    del ops
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((batch, m, k))
    b_np = rng.standard_normal((batch, k, n))
    call_s = []
    for _ in range(6):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern(a_np, b_np)
        call_s.append(time.perf_counter() - t0)
    first_ms, med_ms = call_s[0] * 1e3, sorted(call_s[1:])[2] * 1e3
    link = {}
    if on_card:
        h2d, d2h = pinned_rates(b_np.nbytes)
        # what crosses: A as f32 hi (split2_fast reads no A lo), B as f64
        # (split on the card), C as f64
        bytes_in = (a_np.size * 4 if strategy in ("split2_fast", "float32")
                    else a_np.nbytes) + b_np.nbytes
        bytes_out = batch * m * n * 8
        link = {"whole_call_bytes_in": bytes_in,
                "whole_call_bytes_out": bytes_out,
                "pinned_h2d_gbps": round(h2d / 1e9, 2),
                "pinned_d2h_gbps": round(d2h / 1e9, 2),
                "whole_call_link_bound_ms": round(
                    (bytes_in / h2d + bytes_out / d2h + dt) * 1e3, 3)}

    return {
        "metric": "batched_f64_smm_23x23x23_gflops_per_chip",
        "value": round(gflops, 1),
        "unit": "GFLOP/s",
        "vs_baseline": round(gflops / target, 3),
        "detail": {
            "batch": batch,
            "seconds_per_call": dt,
            "spread": spread,
            "achieved_gbps": round(nbytes / dt / 1e9, 1),
            "roofline_gflops": round(roofline, 1),
            "roofline_frac": round(gflops / roofline, 3),
            "plane_bytes": plane_bytes,
            "plane_bound_frac": round(plane_bytes / bw / dt, 3),
            "device": kind,
            "f64_strategy": strategy,
            "fast_float32_gflops": round(flops / dtf / 1e9, 1),
            "dispatch_hit_us": round(hit_us, 3),
            "whole_call_first_ms": round(first_ms, 3),
            "whole_call_ms": round(med_ms, 3),
            **link,
            "timer": "device_bench" if on_card else "bench (CPU target)",
            "nvidia_smi": nvidia_smi_line() if on_card else None,
        },
    }


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
