"""Scalar math utilities (beyond matdiff).

Reference: src/libxsmm_math.c — integer sqrt/cbrt (isqrt2/isqrt_u32/u64,
icbrt), sexp2 fast exponentials (:292-524), and libxsmm_shuffle (coprime
shuffle, :267).  These back test harnesses and shape/tiling heuristics.

The port's own copy of ``xsmm_tpu/utils/mathx.py`` (numpy only): the same
functions with the same results.
"""

from __future__ import annotations

import math

import numpy as np


def isqrt_u64(x: int) -> int:
    """Largest r with r*r <= x (libxsmm_isqrt_u64 semantics)."""
    if x < 0:
        raise ValueError("negative")
    return math.isqrt(x)


def isqrt_u32(x: int) -> int:
    return math.isqrt(x & 0xFFFFFFFF)


def isqrt2(x: int) -> int:
    """Smallest r with r*r >= x (the 'ceiling' isqrt used for tilings)."""
    r = math.isqrt(x)
    return r if r * r == x else r + 1


def icbrt_u64(x: int) -> int:
    """Largest r with r**3 <= x (libxsmm_icbrt_u64)."""
    if x < 0:
        raise ValueError("negative")
    r = int(round(x ** (1.0 / 3.0)))
    while r ** 3 > x:
        r -= 1
    while (r + 1) ** 3 <= x:
        r += 1
    return r


def icbrt_u32(x: int) -> int:
    return icbrt_u64(x & 0xFFFFFFFF)


def sexp2_u8(x: int) -> float:
    """2^(x/256) fast path analog (libxsmm_sexp2_u8: exact semantics)."""
    return float(2.0 ** (x / 256.0))


def sexp2(x: float) -> float:
    """2^x (libxsmm_sexp2 analog)."""
    return float(2.0 ** x)


def gcd(a: int, b: int) -> int:
    return math.gcd(a, b)


def lcm(a: int, b: int) -> int:
    return abs(a * b) // math.gcd(a, b) if a and b else 0


def shuffle(n: int) -> int:
    """Coprime shuffle factor (libxsmm_shuffle, libxsmm_math.c:267):
    returns c coprime to n near n/phi for pseudo-random striding."""
    if n <= 1:
        return 0 if n <= 0 else 1 % max(n, 1)
    c = max(1, int(round(n / 1.6180339887498949)))  # golden-ratio stride
    while math.gcd(c, n) != 1:
        c += 1
        if c >= n:
            c = 1
            break
    return c


def shuffled_indices(n: int) -> np.ndarray:
    """Full-period shuffled index sequence using the coprime stride."""
    c = shuffle(n)
    return (np.arange(n, dtype=np.int64) * c) % n
