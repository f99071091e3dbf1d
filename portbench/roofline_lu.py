"""Operations, bytes and bounds of the packed LU cells' calls, by kernel,
on ``roofline.py``'s rules: the useful operations of the call as its shapes
define them, each input read once and each output written once.

A call factors B blocks of n x n once (unpivoted getrf: n(n-1)/2 divisions
and a multiply and a subtract for each term of the trailing updates,
2 sum_{j<n} j^2), then applies the factors ``applies`` times to r columns:
a forward solve with unit L (a multiply and an add a term of the strict
lower triangle) and a backward solve with U (the same over the strict upper
triangle, and a division a row).  getrf reads A and writes LU; a solve
reads its triangle (with the diagonal where it divides by it), the right
side and writes X.

The per-layer readers take the device time of each kernel by the name of
its ``__global__`` function (``KERNELS``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from . import roofline, trace_reader

F32_BYTES = 4

# part of a call -> the names of the kernels that run it (packed.cu)
KERNELS = {"getrf": ("getrf_tile", "getrf_shared", "getrf_reg"),
           "trsm_lower": ("trsm_shared", "trsm_reg"),
           "trsm_upper": ("trsm_shared_upper", "trsm_reg_upper")}


def getrf_call(n: int, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one unpivoted LU of ``batch`` n x n blocks."""
    ops = n * (n - 1) // 2 + 2 * sum(j * j for j in range(1, n))
    return float(ops * batch), float(2 * n * n * F32_BYTES * batch)


def trsm_call(n: int, rhs: int, batch: int,
              unit: bool) -> Tuple[float, float]:
    """(operations, bytes) of one triangular solve of ``batch`` n x n
    triangles with ``rhs`` columns: unit diagonal, or divided by it."""
    strict = n * (n - 1) // 2
    ops = (2 * strict + (0 if unit else n)) * rhs
    elems = strict + (0 if unit else n) + 2 * n * rhs
    return float(ops * batch), float(elems * F32_BYTES * batch)


def parts(config: dict, traffic: dict) -> Dict[str, Tuple[float, float]]:
    """(operations, bytes) a call of each part: one getrf, ``applies``
    lower (unit) and upper (non-unit) solves."""
    n, rhs, batch = int(config["m"]), int(config["rhs"]), int(config["batch"])
    applies = int(traffic["applies_per_call"])
    lo, up = trsm_call(n, rhs, batch, True), trsm_call(n, rhs, batch, False)
    return {"getrf": getrf_call(n, batch),
            "trsm_lower": (applies * lo[0], applies * lo[1]),
            "trsm_upper": (applies * up[0], applies * up[1])}


def call(config: dict, traffic: dict) -> Tuple[float, float]:
    """(operations, bytes) of a whole call."""
    got = parts(config, traffic).values()
    return sum(p[0] for p in got), sum(p[1] for p in got)


def kernel_ns(summary, part: str) -> int:
    """Device ns of the kernels of ``part`` in a capture's summary."""
    names = KERNELS[part]
    return sum(ns for key, ns in summary.device_ns.items()
               if trace_reader.base_name(key) in names)


def share(ctx, part: str) -> Optional[dict]:
    """The roofline share of ``part``'s kernels in the traced run ``ctx``:
    its least time a call over its device time a call, in %, with the bound
    named; None where the capture holds none of its kernels."""
    t = ctx.trace
    if t is None or not ctx.trace_calls or not ctx.peaks:
        return None
    ns = kernel_ns(t, part)
    if not ns:
        return None
    ops, nbytes = parts(ctx.config, ctx.traffic)[part]
    bound, which = roofline.bound_s(ops, nbytes, ctx.peaks)
    per_call = ns * 1e-9 / ctx.trace_calls
    return {"value": 100.0 * bound / per_call, "bound": which,
            "ms_a_call": per_call * 1e3, "bound_ms": bound * 1e3}
