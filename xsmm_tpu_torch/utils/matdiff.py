"""Numerical comparison harness — the validation backbone of every test.

Reference: libxsmm_matdiff (src/libxsmm_math.c:48-240) computes L1/L2/Linf
norms of the difference between a test and a reference matrix plus relative
variants; tests gate on ``1.0 < 1000 * normf_rel`` i.e. relative Frobenius
error < 1e-3 (tests/gemm.c:224,245).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MatdiffInfo:
    """Mirrors libxsmm_matdiff_info (include/libxsmm_typedefs.h)."""

    norm1_abs: float = 0.0   # L1 of difference
    norm1_rel: float = 0.0
    normf_abs: float = 0.0   # Frobenius of difference
    normf_rel: float = 0.0   # THE gate: < 1e-3 passes
    normi_abs: float = 0.0   # Linf of difference
    normi_rel: float = 0.0
    linf_abs: float = 0.0    # max elementwise abs diff
    linf_rel: float = 0.0
    l2_abs: float = 0.0
    l2_rel: float = 0.0
    m: int = 0
    n: int = 0
    i: int = -1              # location of max abs diff
    j: int = -1
    v_ref: float = 0.0
    v_tst: float = 0.0

    def ok(self, tol: float = 1e-3) -> bool:
        return self.normf_rel < tol


def matdiff(ref, tst) -> MatdiffInfo:
    """Compare ``tst`` against gold ``ref`` (any shapes broadcastable to 2D)."""
    ref = np.asarray(ref, dtype=np.float64)
    tst = np.asarray(tst, dtype=np.float64)
    if ref.shape != tst.shape:
        raise ValueError(f"shape mismatch: {ref.shape} vs {tst.shape}")
    r2 = ref.reshape(-1, ref.shape[-1]) if ref.ndim > 1 else ref.reshape(1, -1)
    t2 = tst.reshape(-1, tst.shape[-1]) if tst.ndim > 1 else tst.reshape(1, -1)

    diff = t2 - r2
    info = MatdiffInfo(m=r2.shape[0], n=r2.shape[1])

    abs_ref = np.abs(r2)
    abs_diff = np.abs(diff)

    # Matrix 1-norm (max column sum) and inf-norm (max row sum)
    norm1_ref = abs_ref.sum(axis=0).max() if r2.size else 0.0
    normi_ref = abs_ref.sum(axis=1).max() if r2.size else 0.0
    normf_ref = float(np.sqrt((r2 * r2).sum()))

    info.norm1_abs = float(abs_diff.sum(axis=0).max()) if r2.size else 0.0
    info.normi_abs = float(abs_diff.sum(axis=1).max()) if r2.size else 0.0
    info.normf_abs = float(np.sqrt((diff * diff).sum()))
    info.norm1_rel = info.norm1_abs / norm1_ref if norm1_ref > 0 else info.norm1_abs
    info.normi_rel = info.normi_abs / normi_ref if normi_ref > 0 else info.normi_abs
    info.normf_rel = info.normf_abs / normf_ref if normf_ref > 0 else info.normf_abs

    info.l2_abs = info.normf_abs
    info.l2_rel = info.normf_rel

    if r2.size:
        idx = int(abs_diff.argmax())
        i, j = divmod(idx, r2.shape[1])
        info.i, info.j = i, j
        info.v_ref = float(r2[i, j])
        info.v_tst = float(t2[i, j])
        info.linf_abs = float(abs_diff[i, j])
        denom = max(abs(info.v_ref), np.finfo(np.float64).eps)
        info.linf_rel = info.linf_abs / denom
    return info


def check(ref, tst, tol: float = 1e-3, what: str = "") -> MatdiffInfo:
    """Assert-style helper: raises with diagnostics when the gate fails."""
    info = matdiff(ref, tst)
    if not info.ok(tol):
        raise AssertionError(
            f"matdiff{f' [{what}]' if what else ''}: normf_rel="
            f"{info.normf_rel:.3e} >= tol={tol:g} "
            f"(max diff {info.linf_abs:.3e} at [{info.i},{info.j}]: "
            f"ref={info.v_ref:.6g} tst={info.v_tst:.6g})")
    return info
