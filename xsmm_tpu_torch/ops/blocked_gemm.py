"""Blocked GEMM (BGEMM): persistent handle with block-laid-out operands.

The port of ``xsmm_tpu/ops/blocked_gemm.py``.  Reference:
src/libxsmm_blocked_gemm.c — handle creation (:47) with block sizes
(bm, bn, bk), copy-in/copy-out converters to the blocked layout (:169-418),
six loop orders (include/libxsmm_blocked_gemm.h:38-45).

The blocked layout is [Mb, Kb, bm, bk] (block-row-major, the reference's
layout); the converters are ``pad`` + ``reshape`` + ``permute`` +
``contiguous``.  The compute contracts over (Kb, bk) in one
``torch.einsum("MKmk,KNkn->MNmn")`` with TF32 off: the JAX package leaves
this product to XLA, so it has no kernel of its own here either.  ``order``
is accepted for API parity and recorded.

float64 goes through the two-float split (three f32 einsums, hi and lo
recombined in f64 on the way out) and returns numpy f64, like every other
f64 path of the package.  Other dtypes return tensors on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import platform
from ..core.descriptors import TORCH_DTYPES, dtype_name
from .pack_util import round_up
from .smm import _einsum, as_tensor, split_f64

ORDERS = ("ijk", "ikj", "jik", "jki", "kij", "kji")  # parity: 6 loop orders

_SPEC = "MKmk,KNkn->MNmn"


class BlockedGemmHandle:
    """C[M,N] (+)= A[M,K] @ B[K,N] over blocked layouts."""

    def __init__(self, m: int, n: int, k: int, bm: int = 64, bn: int = 64,
                 bk: int = 64, dtype="float32", order: str = "ijk"):
        if order not in ORDERS:
            raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
        self.m, self.n, self.k = m, n, k
        self.bm, self.bn, self.bk = bm, bn, bk
        self.order = order
        self.is_f64 = dtype_name(dtype) == "float64"
        self.dtype = TORCH_DTYPES[dtype_name(dtype)]
        self.comp_dt = torch.float32 if self.is_f64 else self.dtype
        self.mp = round_up(m, bm)
        self.np_ = round_up(n, bn)
        self.kp = round_up(k, bk)

    # -- layout converters -----------------------------------------------------
    @staticmethod
    def _block(x: torch.Tensor, rows: int, cols: int, br: int,
               bc: int) -> torch.Tensor:
        x = F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))
        return x.reshape(rows // br, br, cols // bc, bc).permute(
            0, 2, 1, 3).contiguous()

    def _unblk_c(self, c: torch.Tensor) -> torch.Tensor:
        return c.permute(0, 2, 1, 3).reshape(self.mp, self.np_)[
            :self.m, :self.n].contiguous()

    def _copyin(self, x, rows: int, cols: int, br: int, bc: int):
        dev = platform.device()
        if self.is_f64:
            return tuple(self._block(h, rows, cols, br, bc)
                         for h in split_f64(x, dev))
        return self._block(as_tensor(x, dev, self.comp_dt), rows, cols, br, bc)

    # -- copy-in/copy-out (libxsmm_blocked_gemm.c:169-418 analogs) -----------
    # f64 operands return (hi, lo) block pairs.
    def copyin_a(self, a):
        return self._copyin(a, self.mp, self.kp, self.bm, self.bk)

    def copyin_b(self, b):
        return self._copyin(b, self.kp, self.np_, self.bk, self.bn)

    def copyin_c(self, c):
        return self._copyin(c, self.mp, self.np_, self.bm, self.bn)

    def copyout_c(self, c_blk):
        if self.is_f64:
            hi, lo = c_blk
            out = (self._unblk_c(hi).to(torch.float64)
                   + self._unblk_c(lo).to(torch.float64))
            return out.cpu().numpy()
        return self._unblk_c(c_blk)

    # -- execute ----------------------------------------------------------------
    def execute(self, a_blk, b_blk, c_blk=None):
        """Blocked-layout compute (the _st template analog): the product is
        summed in f32 and, with C, ``C + A @ B`` is rounded to the dtype
        once more."""
        if self.is_f64:
            (ah, al), (bh, bl) = a_blk, b_blk
            hi = _einsum(_SPEC, ah, bh)
            lo = _einsum(_SPEC, ah, bl) + _einsum(_SPEC, al, bh)
            if c_blk is not None:
                hi, lo = hi + c_blk[0], lo + c_blk[1]
            return hi, lo
        out = _einsum(_SPEC, a_blk, b_blk)
        if c_blk is not None:
            out = (out.float() + c_blk.float()).to(self.comp_dt)
        return out

    def __call__(self, a, b, c=None):
        """Convenience: unblocked in/out."""
        c_blk = self.copyin_c(c) if c is not None else None
        out = self.execute(self.copyin_a(a), self.copyin_b(b), c_blk)
        return self.copyout_c(out)


def blocked_gemm_handle(m, n, k, bm=64, bn=64, bk=64, dtype="float32",
                        order="ijk") -> BlockedGemmHandle:
    """libxsmm_blocked_gemm_handle_create analog."""
    return BlockedGemmHandle(m, n, k, bm, bn, bk, dtype, order)
