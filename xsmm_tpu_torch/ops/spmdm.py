"""Dynamic-sparsity sparse x dense multiply (spmdm).

The port of ``xsmm_tpu/ops/spmdm.py``.  Reference: src/libxsmm_spmdm.c —
two-phase API for DNN sparse weights: libxsmm_spmdm_init sizes the block
structure (bm/bk/bn, spmdm.h:42-60), createSparseSlice converts dense A into
blocked CSR slices, then compute does CSR x dense-B per block.  fp32 and
bf16-input variants (libxsmm_spmdm.h:98-127: bf16 inputs, fp32
accumulation).  ``in_dtype="bfloat16"`` selects the same contract: A is
rounded to bf16 at slice time, ELL values are the exact f32 image of those
bf16 values, B is rounded to bf16 and promoted to f32 in the product, and C
is f32.

The structure changes on every call, so there is no per-structure kernel.
The JAX package computes both strategies with XLA ops, no Pallas kernel;
here they are PyTorch ops:

* **"dense"**: the slice phase is a threshold/pass-through and compute is
  one product, ``torch.matmul`` with TF32 off.  bf16 inputs are multiplied
  in f32 from their bf16-rounded values (bf16 values are exact in f32 and
  the sum is f32 either way), on every device.
* **"ell"**: the slice phase packs A into fixed-width ELL (per-row values
  and column indices, width R = max row population rounded up to 8) with
  the JAX package's vectorized numpy pack.  Compute gathers B rows by index
  and accumulates, one ELL column at a time.  The pack is the native C++
  single-pass pack (``native/spmdm.cpp``, through ``core/native_bridge``)
  where the JAX package takes it, else (``XSMM_NATIVE=0``) the JAX
  package's vectorized numpy pack; both give the same arrays.
* **"auto"** (default): packs ELL only below the JAX package's crossover
  (``SpmdmHandle.ELL_CROSSOVER``); otherwise dense.

Entry points take numpy arrays or tensors and return f32 tensors on
``platform.device()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core import platform
from ..core.descriptors import TORCH_DTYPES, dtype_name
from .pack_util import round_up
from .smm import _matmul, as_tensor

F32 = torch.float32


@dataclasses.dataclass
class SparseSlice:
    """The createSparseSlice output (ELL-packed or dense pass-through).

    ``transa`` records the layout A was supplied in (libxsmm passes the
    same flag again at compute time, libxsmm_spmdm.h:91,109); the slice is
    stored normalized to logical [M,K], so compute only validates the echo.
    """

    kind: str                          # "dense" | "ell"
    a: Optional[torch.Tensor] = None   # dense [M,K] (logical)
    values: Optional[torch.Tensor] = None   # [M, R] f32
    cols: Optional[torch.Tensor] = None     # [M, R] int64
    nnz: Union[int, torch.Tensor] = 0
    transa: bool = False


class SpmdmHandle:
    """libxsmm_spmdm_handle analog: fixed (M, N, K, dtypes), dynamic A."""

    # The JAX package's measured ELL-vs-dense crossover (its module notes):
    # dense wins at every DNN sparsity level; ELL only below ~0.5 % density.
    # Kept so both packages choose alike; not measured on the card.
    ELL_CROSSOVER = 0.005

    def __init__(self, m: int, n: int, k: int, in_dtype="float32",
                 strategy: str = "auto"):
        if strategy not in ("auto", "dense", "ell"):
            raise ValueError(f"unknown spmdm strategy: {strategy}")
        self.m, self.n, self.k = m, n, k
        self.in_dtype = TORCH_DTYPES[dtype_name(in_dtype)]
        self.strategy = strategy
        # block sizes for parity with the reference (bm/bk/bn,
        # spmdm.h:42-60); informational
        self.bm, self.bk, self.bn = 128, 128, 128
        platform.device()  # raises without a card unless target="cpu"

    # -- phase 1: createSparseSlice -------------------------------------------
    def create_sparse_slice(self, a, tol: float = 0.0,
                            transa: bool = False) -> SparseSlice:
        """Convert dense A [M,K] into the compute representation.

        ``transa=True`` means A is supplied as [K,M] and the logical operand
        is its transpose (the reference's 'T' char, libxsmm_spmdm.h:91).
        """
        dev = platform.device()
        a = as_tensor(a, dev)
        if transa:
            a = a.T
        if self.strategy == "dense":
            a = a.to(self.in_dtype)
            if tol:
                a = torch.where(a.abs() > tol, a, torch.zeros_like(a))
            # nnz stays a device scalar: no host round trip per step
            return SparseSlice(kind="dense", a=a, nnz=torch.count_nonzero(a),
                               transa=transa)

        if self.in_dtype == torch.bfloat16:
            # reference bf16 slice contract: the input IS bf16; round first
            # so ELL values are the exact f32 image of bf16 values
            a = a.to(torch.bfloat16)
        a_np = np.ascontiguousarray(a.to(F32).cpu().numpy())
        # native single-pass pack (rowmax probe first so "auto" can bail to
        # dense without packing), as xsmm_tpu/ops/spmdm.py:134-151
        from ..core import native_bridge
        lib = native_bridge.get_lib()
        if lib is not None:
            import ctypes
            rmax = lib.xsmm_ell_rowmax(a_np.ctypes.data_as(ctypes.c_void_p),
                                       self.m, self.k, float(tol))
            r = max(1, int(round_up(max(int(rmax), 1), 8)))
            if self.strategy == "auto" and r > self.ELL_CROSSOVER * self.k:
                nz = a_np if not tol else np.where(np.abs(a_np) > tol,
                                                   a_np, 0)
                return SparseSlice(kind="dense",
                                   a=as_tensor(nz, dev, self.in_dtype),
                                   nnz=int(np.count_nonzero(nz)),
                                   transa=transa)
            vals, cols, nnz_total, r = native_bridge.ell_pack_native(
                a_np, float(tol), r=r)   # r precomputed: skip the re-probe
            return SparseSlice(kind="ell", values=as_tensor(vals, dev),
                               cols=as_tensor(cols.astype(np.int64), dev),
                               nnz=nnz_total, transa=transa)
        if tol:
            a_np = np.where(np.abs(a_np) > tol, a_np, 0)
        mask = a_np != 0
        counts = mask.sum(axis=1)
        r = max(1, int(round_up(int(counts.max(initial=0) or 1), 8)))
        if self.strategy == "auto" and r > self.ELL_CROSSOVER * self.k:
            return SparseSlice(kind="dense",
                               a=as_tensor(a_np, dev, self.in_dtype),
                               nnz=int(counts.sum()), transa=transa)
        # left-pack with a computed-position scatter: row-major np.nonzero
        # order gives position = global index minus the row's start
        nnz_total = int(counts.sum())
        rows, colsrc = np.nonzero(mask)
        row_start = np.concatenate(([0], np.cumsum(counts[:-1])))
        pos = np.arange(nnz_total) - row_start[rows]
        vals = np.zeros((self.m, r), np.float32)
        vals[rows, pos] = a_np[mask]
        # padded cols stay 0 (< K, so the gather is in bounds; the zero
        # value annihilates the contribution)
        cols = np.zeros((self.m, r), np.int64)
        cols[rows, pos] = colsrc
        return SparseSlice(kind="ell", values=as_tensor(vals, dev),
                           cols=as_tensor(cols, dev), nnz=nnz_total,
                           transa=transa)

    # -- phase 2: compute -----------------------------------------------------
    def _dense_compute(self, a, b, c, transb, transc, has_beta):
        bb = b.T if transb else b
        if self.in_dtype == torch.bfloat16:
            a, bb = a.to(torch.bfloat16), bb.to(torch.bfloat16)
        out = _matmul(a.to(F32), bb.to(F32))
        if transc:
            out = out.T
        if has_beta:
            out = out + c.to(F32)
        return out

    def _ell_compute(self, values, cols, b, c, transb, transc, has_beta):
        bl = b.T if transb else b   # logical [K, N]
        if has_beta:   # accumulate into C (in its LOGICAL layout)
            acc = (c.T if transc else c).to(F32)
        else:
            acc = torch.zeros((self.m, bl.shape[1]), dtype=F32,
                              device=bl.device)
        for j in range(values.shape[1]):
            # bf16 B promotes to the f32 accumulator in the product
            acc = acc + values[:, j:j + 1] * bl[cols[:, j]].to(F32)
        return acc.T if transc else acc

    def compute(self, slice_: SparseSlice, b, transa: Optional[bool] = None,
                transb: bool = False, transc: bool = False,
                beta: float = 0.0, c=None):
        """C = A_slice @ B [+ beta*C] (libxsmm_spmdm_compute_*_thread analog).

        ``transa`` echoes the slice-time flag; a mismatching echo is an
        error, not a re-transpose.  ``transb``: B is supplied [N,K].
        ``transc``: C is produced (and read, under beta=1) as [N,M].
        ``beta`` in {0, 1}; alpha is ignored like the reference
        (libxsmm_spmdm.h:105 note).  Output is always f32.
        """
        if transa is not None and bool(transa) != slice_.transa:
            raise ValueError(
                f"transa={transa} does not match the slice-time flag "
                f"({slice_.transa}); pass transa to create_sparse_slice")
        if beta not in (0, 1, 0.0, 1.0):
            raise ValueError(f"spmdm supports beta in {{0,1}}, got {beta}")
        has_beta = bool(beta)
        if has_beta and c is None:
            raise ValueError("beta=1 requires c")
        dev = platform.device()
        c = as_tensor(c, dev) if has_beta else None
        if slice_.kind == "dense":
            return self._dense_compute(slice_.a, as_tensor(b, dev), c,
                                       transb, transc, has_beta)
        return self._ell_compute(slice_.values, slice_.cols,
                                 as_tensor(b, dev, self.in_dtype), c,
                                 transb, transc, has_beta)

    def __call__(self, a, b, tol: float = 0.0):
        return self.compute(self.create_sparse_slice(a, tol), b)


def spmdm_init(m: int, n: int, k: int, in_dtype="float32",
               strategy: str = "auto") -> SpmdmHandle:
    """libxsmm_spmdm_init analog.  strategy: "auto" (the ELL/dense
    crossover), "dense", or "ell"."""
    return SpmdmHandle(m, n, k, in_dtype=in_dtype, strategy=strategy)
