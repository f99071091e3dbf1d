"""Fixed-structure sparse x dense kernels (the spgemm domain) on the card.

The port of ``xsmm_tpu/ops/spgemm.py``.  Reference: src/generator_spgemm*.c
JITs kernels with the nonzero structure unrolled into the instruction stream
(CSR A-sparse SOA, register-resident A values, B-sparse variants); runtime
entries libxsmm_create_xcsr_soa / libxsmm_create_dcsr_reg
(libxsmm_main.c:2423-2583).

Two strategies, chosen at create time as in the JAX package:

* **"unroll"** — the JAX package unrolls the structure into a Pallas kernel
  per operator.  Here one hand-written CUDA kernel template computes the
  same function for every structure (``ops/spgemm_kernels.py``,
  ``ops/csrc/spgemm.cu``): the structure and values go to the card once,
  when the kernel is created, and live on the ``CsrSpgemm`` object, which
  the registry caches under the structure digest.  The term order, the
  rounding of each value to f32 and the f64 hi/lo arithmetic are the JAX
  kernels'.  ``UNROLL_MAX`` (``XSMM_SPARSE_UNROLL_MAX``) keeps the JAX
  package's ``auto`` switch, so both packages pick the same strategy.
* **"dense"** — densify A and run one product; the JAX package leaves it to
  XLA (``jnp.matmul`` at ``Precision.HIGHEST``), here ``torch.matmul`` with
  TF32 off (``ops/smm._matmul``).

f64 operands are carried as f32 hi/lo pairs under one of the four stream
schedules (``F64_SCHEDULES``: whether the B-lo plane is read and whether
the C-lo plane is written or folded).  The f64 call takes numpy f64 or
tensors, splits B on the device, and returns numpy f64, like ``BatchedSMM``.
The f32 call returns a tensor on the device.
"""

from __future__ import annotations

import os
from typing import Dict, Union

import numpy as np
import torch

from ..core import platform
from ..core.descriptors import TORCH_DTYPES, SparseDescriptor, dtype_name
from ..core.registry import get_registry
from ..utils.mtx import Csc, Csr
from . import spgemm_kernels as sk
from .pack_util import round_up
from ..utils import trace
from .smm import _matmul, _to_numpy_f64, as_tensor

UNROLL_MAX = int(os.environ.get("XSMM_SPARSE_UNROLL_MAX", 8192))
_SUB = 8  # sublanes of the JAX package's SOA view; sets the bn unit

# f64 stream schedules: name -> (b_lo read?, c_lo written?)
F64_SCHEDULES = {"split2": (True, True), "split2_fast": (True, False),
                 "split2_wout": (False, True), "fold": (False, False)}

_STRATEGY_FLAGS = {"auto": 0, "unroll": 1, "dense": 2}

F32, F64 = torch.float32, torch.float64


def _as_csr(a: Union[np.ndarray, Csr], tol: float = 0.0) -> Csr:
    if isinstance(a, Csr):
        return a
    return Csr.from_dense(np.asarray(a), tol)


def _check_schedule(f64_schedule: str) -> None:
    if f64_schedule not in F64_SCHEDULES:
        raise ValueError(f"unknown f64 schedule {f64_schedule!r}; "
                         f"one of {sorted(F64_SCHEDULES)}")


def lane_block(m: int, k: int, n: int, f64: bool) -> int:
    """The JAX package's lane tile ``bn`` (xsmm_tpu/ops/spgemm.py:170-184),
    by its formula and ``XSMM_SPGEMM_BN``, so ``Fsspmdm.n_chunksize``
    agrees.  The CUDA kernel tiles N its own way (64 columns a block)."""
    unit = _SUB * 128
    per_col = (k + m) * 4 * (2 if f64 else 1) * 2
    bn = min(2048, max(unit, round_up(n, unit)))
    while bn > unit and bn * per_col > 14 * 1024 * 1024:
        bn = max(unit, bn // 2 // unit * unit)
    env_bn = int(os.environ.get("XSMM_SPGEMM_BN", 0))
    if env_bn:
        bn = max(unit, env_bn // unit * unit)
    return bn


class CsrSpgemm:
    """Kernel computing C[M,N] = A_sparse[M,K] @ B[K,N].

    Call: kernel(b) with b [K, N]: f32 (a tensor comes back), or f64 numpy
    or tensor (split on the device; numpy f64 comes back) when the dtype is
    float64.  N is fixed per kernel (shape-keyed like every dispatch
    descriptor).  ``acc_fn`` gives the beta = 1 form.
    """

    def __init__(self, csr: Csr, n: int, dtype="float32",
                 strategy: str = "auto", f64_schedule: str = "split2"):
        self.csr = csr
        self.n = n
        self.dtype = dtype_name(dtype)
        self.is_f64 = self.dtype == "float64"
        _check_schedule(f64_schedule)
        self.f64_schedule = f64_schedule
        self.b_lo, self.c_lo = (F64_SCHEDULES[f64_schedule] if self.is_f64
                                else (False, False))
        if strategy == "auto":
            strategy = "unroll" if csr.nnz <= UNROLL_MAX else "dense"
        if strategy not in ("unroll", "dense"):
            raise ValueError(f"unknown spgemm strategy {strategy!r}")
        self.strategy = strategy
        self.bn = (lane_block(csr.m, csr.k, n, self.is_f64)
                   if strategy == "unroll" else None)
        self._on: Dict[torch.device, object] = {}
        # the profiler's name of this kernel's calls (utils/trace)
        self.name = trace.kernel_name("spgemm", SparseDescriptor(
            kind="csr_asparse", m=csr.m, n=n, k=csr.k, dtype=self.dtype,
            structure_digest=b""))
        self._operand(platform.device())  # to the device once; raises w/o card

    @property
    def stream_bytes(self):
        """(read, write) device bytes per call — the schedule's byte model
        (B streams in, C streams out; A is small and read once)."""
        per = 4 * self.n
        rd = self.csr.k * per * ((1 + self.b_lo) if self.is_f64 else 1)
        wr = self.csr.m * per * ((1 + self.c_lo) if self.is_f64 else 1)
        return rd, wr

    def _operand(self, dev: torch.device):
        """What the strategy computes with, on ``dev``, made once per
        device: the ``SparseOperator`` (unroll) or the dense A, f32 or its
        hi/lo split (dense)."""
        got = self._on.get(dev)
        if got is None:
            if self.strategy == "unroll":
                got = sk.SparseOperator(self.csr, dev)
            else:
                a = torch.as_tensor(self.csr.toarray(), device=dev)
                if self.is_f64:
                    ah = a.to(F64).to(F32)
                    got = (ah, (a.to(F64) - ah.to(F64)).to(F32))
                else:
                    got = a.to(TORCH_DTYPES[self.dtype])
            self._on[dev] = got
        return got

    # -- the product on f32 planes --------------------------------------------
    def _fn(self, *bs):
        """f32: fn(b) -> C in the kernel's dtype.  f64: fn(bh[, bl]) ->
        (ch, cl) or the folded C, per schedule."""
        dev = platform.device()
        op = self._operand(dev)
        bs = [as_tensor(b, dev, F32, slot=f"b{i}").contiguous()
              for i, b in enumerate(bs)]
        if self.strategy == "unroll":
            if not self.is_f64:
                return sk.unroll_f32(op, bs[0]).to(TORCH_DTYPES[self.dtype])
            return sk.unroll_f64(op, *bs, c_lo=self.c_lo)
        if not self.is_f64:
            return _matmul(op.to(F32), bs[0]).to(TORCH_DTYPES[self.dtype])
        ah, al = op
        hi = _matmul(ah, bs[0])
        lo = _matmul(al, bs[0])
        if self.b_lo:
            lo = lo + _matmul(ah, bs[1])
        return (hi, lo) if self.c_lo else hi + lo

    # -- accumulate (beta = 1) ------------------------------------------------
    def _acc(self, *ops):
        with trace.scope(self.name + "_acc", "frontend"):
            dev = platform.device()
            n_c = 2 if self.c_lo else 1
            if self.strategy != "unroll":
                cs = [as_tensor(c, dev, F32, slot=f"c{i}")
                      for i, c in enumerate(ops[:n_c])]
                r = self._fn(*ops[n_c:])
                if not self.is_f64 or not self.c_lo:
                    return cs[0] + r
                return cs[0] + r[0], cs[1] + r[1]
            op = self._operand(dev)
            ops = [as_tensor(x, dev, F32, slot=f"acc{i}").contiguous()
                   for i, x in enumerate(ops)]
            if not self.is_f64:
                return sk.acc_f32(op, *ops)
            cs, bs = ops[:n_c], ops[n_c:]
            return sk.acc_f64(op, cs[0], cs[1] if self.c_lo else None, *bs)

    @property
    def acc_fn(self):
        """fn(c, b) -> c + A@B (f32) / fn(ch[, cl], bh[, bl]) per schedule.
        Functional: new tensors come back and C_in is not written."""
        return self._acc

    def __call__(self, b):
        with trace.scope(self.name, "frontend"):
            if not self.is_f64:
                return self._fn(b)
            dev = platform.device()
            if self.b_lo:   # split on the card: B crosses as f64
                b64 = as_tensor(b, dev, F64, slot="b")
                bh = b64.to(F32)
                bs = [bh, (b64 - bh.to(F64)).to(F32)]
            else:           # hi alone: B crosses as f32
                bs = [as_tensor(b, dev, F32, slot="b")]
            out = self._fn(*bs)
            if self.c_lo:
                out = out[0].to(F64) + out[1].to(F64)
            return _to_numpy_f64(out.to(F64))


class CscBSpgemm:
    """C[M,N] = A_dense[M,K] @ B_sparse[K,N]  (csc_bsparse_soa analog).

    Through the transpose identity C^T = B^T A^T: B^T in CSR runs through
    CsrSpgemm with the M dimension as the column axis.
    """

    def __init__(self, csc: Csc, m: int, dtype="float32",
                 strategy: str = "auto"):
        self.csc = csc
        self.m = m
        bt_csr = Csr(csc.k, csc.m, csc.col_ptr, csc.row_idx, csc.values)
        self._inner = CsrSpgemm(bt_csr, m, dtype=dtype, strategy=strategy)
        self.strategy = self._inner.strategy
        self.is_f64 = self._inner.is_f64

    def __call__(self, a):
        at = as_tensor(a, platform.device()).transpose(-1, -2).contiguous()
        ct = self._inner(at)
        if self.is_f64:  # numpy f64 comes back
            return np.ascontiguousarray(np.swapaxes(ct, -1, -2))
        return ct.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# Dispatch frontends (libxsmm_create_xcsr_soa / dcsr_reg analogs)
# ---------------------------------------------------------------------------


def create_csr_soa(a, n: int, dtype="float32", strategy: str = "auto",
                   tol: float = 0.0,
                   f64_schedule: str = "split2") -> CsrSpgemm:
    """Sparse-A (CSR or dense-with-zeros) x dense-B kernel, cached by
    structure digest (libxsmm_create_xcsr_soa, libxsmm_main.c:2423)."""
    with trace.span("create"):
        csr = _as_csr(a, tol)
        _check_schedule(f64_schedule)
        sched_id = sorted(F64_SCHEDULES).index(f64_schedule)
        with trace.span("create.digest"):
            digest = csr.structure_digest()
        desc = SparseDescriptor(kind="csr_asparse", m=csr.m, n=n, k=csr.k,
                                dtype=dtype_name(dtype),
                                structure_digest=digest,
                                flags=(_STRATEGY_FLAGS[strategy]
                                       | (sched_id << 4)))
        return get_registry().dispatch(
            desc, lambda: CsrSpgemm(csr, n, dtype, strategy, f64_schedule),
            name=f"spgemm_csr_{csr.m}x{n}x{csr.k}_nnz{csr.nnz}")


def create_dcsr_reg(a, n: int, strategy: str = "unroll",
                    f64_schedule: str = "split2") -> CsrSpgemm:
    """FP64 register-sparse analog (libxsmm_create_dcsr_reg): the values
    are carried as hi/lo f32 pairs."""
    return create_csr_soa(a, n, dtype="float64", strategy=strategy,
                          f64_schedule=f64_schedule)


def create_csc_soa(b, m: int, dtype="float32", strategy: str = "auto",
                   tol: float = 0.0) -> CscBSpgemm:
    """Dense-A x sparse-B kernel (libxsmm_create_xcsc_soa analog)."""
    if not isinstance(b, Csc):
        b = Csc.from_dense(np.asarray(b), tol)
    desc = SparseDescriptor(kind="csc_bsparse", m=m, n=b.k, k=b.m,
                            dtype=dtype_name(dtype),
                            structure_digest=Csr(
                                b.k, b.m, b.col_ptr, b.row_idx,
                                b.values).structure_digest(),
                            flags=_STRATEGY_FLAGS[strategy])
    return get_registry().dispatch(
        desc, lambda: CscBSpgemm(b, m, dtype, strategy),
        name=f"spgemm_csc_{m}x{b.k}x{b.m}_nnz{b.nnz}")
