"""Packed (batched, batch-innermost) linear algebra: PGEMM/GETRF/TRMM/TRSM.

The port of ``xsmm_tpu/ops/packed.py``.  Reference:
src/generator_packed_*.c — kernels across a batch of small LAPACK-style
problems, dispatched via libxsmm_dispatch_{pgemm,getrf,trmm,trsm}
(libxsmm_main.c:2318-2422).  "Packed" is the lane-packed layout: one problem
per batch index, the batch innermost.

* **pgemm** — the batched SMM (``ops/smm.py``) under the packed API name.
* **getrf** — unpivoted LU, as the reference's packed getrf, through
  kernel 11 (``getrf_unrolled``) when min(M, N) <= ``getrf_unroll``, else
  kernel 12 (``getrf_loop``) of ``ops/packed_kernels.py``: the JAX
  package's pick.
* **trsm** — a left solve, lower (forward substitution) or upper (the
  kernels' upper variant: backward substitution reading triu(A) in place);
  right and transposed variants are mapped onto a left one by transposes
  before packing; kernel 13 (``trsm_unrolled``) when SM <= ``getrf_unroll``,
  else kernel 14 (``trsm_loop``).  ``packed`` takes the left lower and the
  left upper untransposed forms on packed operands as they are (the
  backward solve on getrf's packed factors, with no copy of them).
* **trmm** — the batched SMM with the triangle masked at pack time.

Entry points take numpy arrays or tensors and run on ``platform.device()``.
FP64: the factorizations compute in f32 and return numpy f64, as the JAX
package does; TRSM offers one step of refinement (device split2 residual,
f64 residual on the host, or none).  ``getrf_unroll`` is read when a kernel
is built and is not part of the registry key, in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import platform
from ..core.config import get_config
from ..core.descriptors import TORCH_DTYPES, PackedDescriptor, dtype_name
from ..core.registry import get_registry
from ..utils import trace
from . import packed_kernels
from .pack_util import LANES, pack_lanes
from .smm import _matmul, _to_numpy_f64, as_tensor, mmdispatch, split_f64


def pgemm_dispatch(m: int, n: int, k: int, dtype="float32", batch: int = 1,
                   **kw):
    """libxsmm_dispatch_pgemm analog — lane-packed batched GEMM."""
    return mmdispatch(m, n, k, in_dtype=dtype, batch=batch, beta=0.0, **kw)


def _lane_tile(nbytes_per_lane: int) -> int:
    """The JAX package's lane tile (xsmm_tpu/ops/packed.py:52-58), kept as
    the kernels' record (``.bt``); the CUDA kernels take any Bp and do not
    use it."""
    budget = 12 * 1024 * 1024
    bt = (budget // max(nbytes_per_lane, 1) // LANES) * LANES
    bt = int(max(LANES, min(bt, 1024)))
    return 1 << (bt.bit_length() - 1)


def _unroll_max() -> int:
    """Size up to which getrf/trsm take the unrolled kernels (11 and 13),
    read through the config at dispatch time."""
    return get_config().getrf_unroll


def _f32(x, device: torch.device, slot: str = "") -> torch.Tensor:
    """A float32 tensor on ``device``; numpy f64 data is rounded to f32 on
    the host, as the JAX package's ``np.asarray(a, np.float32)`` (for the
    card while it fills the pinned staging buffer, so only f32 crosses)."""
    return as_tensor(x, device, torch.float32, slot=slot)


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return _to_numpy_f64(x.detach().to(torch.float64))
    return np.asarray(x, np.float64)


def _f32_to_numpy_f64(t: torch.Tensor) -> np.ndarray:
    """An f32 result as numpy f64: on the CPU widened by numpy; from the
    card widened there (exact either way) and copied through a pinned
    block."""
    if t.device.type == "cuda":
        return _to_numpy_f64(t.to(torch.float64,
                                  memory_format=torch.contiguous_format))
    return t.contiguous().numpy().astype(np.float64)


def _check_shape(x: torch.Tensor, shape, what: str) -> None:
    if x.dim() != 3 or tuple(x.shape[1:]) != shape:
        raise ValueError(f"{what}: kernel built for [B, {shape[0]}, "
                         f"{shape[1]}], got {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# GETRF — unpivoted LU
# ---------------------------------------------------------------------------


class GetrfKernel:
    """Batched unpivoted LU: A[B,M,N] -> LU packed in one matrix.

    L (unit lower) and U share storage as in LAPACK getrf.  No pivoting —
    same restriction as the reference's packed getrf; inputs must be
    factorizable without row exchange (e.g. diagonally dominant).
    """

    def __init__(self, desc: PackedDescriptor):
        self.desc = desc
        m, n = desc.m, desc.n
        self.is_f64 = desc.dtype == "float64"
        self.bt = _lane_tile(2 * 2 * m * n * 4)
        self.name = trace.kernel_name("getrf", desc)
        self.kernel_name = ("getrf_unrolled" if min(m, n) <= _unroll_max()
                            else "getrf_loop")
        platform.device()  # raises without a card and without target="cpu"

    def packed(self, ap) -> torch.Tensor:
        """LU [M, N, Bp] of a packed A [M, N, Bp] (f32, on the device);
        numpy data such as the JAX package's pack is taken as well."""
        with trace.scope(self.name + "_packed", "frontend"):
            ap = _f32(ap, platform.device(), slot="ap").contiguous()
            return getattr(packed_kernels, self.kernel_name)(ap)

    def __call__(self, a):
        """[B, M, N] -> LU [B, M, N]: a tensor on the device, or numpy f64
        for an f64 descriptor (computed in f32)."""
        with trace.scope(self.name):
            a = _f32(a, platform.device(), slot="a")
            _check_shape(a, (self.desc.m, self.desc.n), "getrf")
            out = self.packed(pack_lanes(a)).permute(2, 0, 1)
            return _f32_to_numpy_f64(out) if self.is_f64 else out


# ---------------------------------------------------------------------------
# TRSM — triangular solve (a left solve, lower or upper)
# ---------------------------------------------------------------------------


class TrsmKernel:
    """Batched triangular solve: op(A) X = alpha B (side=L) or
    X op(A) = alpha B (side=R); A [B,M,M] triangular, B [B,M,N] (L) /
    [B,N,M] (R) ... shapes follow BLAS with m,n of the B matrix."""

    def __init__(self, desc: PackedDescriptor):
        self.desc = desc
        self.is_f64 = desc.dtype == "float64"
        self.side, self.uplo = desc.side.upper(), desc.uplo.upper()
        self.trans = desc.transa.upper() == "T"
        self.unit = desc.diag.upper() == "U"
        m, n = desc.m, desc.n          # B is m x n
        sm = m if self.side == "L" else n
        sn = n if self.side == "L" else m
        self.am = sm
        self.name = trace.kernel_name("trsm", desc)
        self.bt = _lane_tile(2 * (sm * sm + 2 * sm * sn) * 4)
        self.kernel_name = ("trsm_unrolled" if sm <= _unroll_max()
                            else "trsm_loop")
        platform.device()

    def _solve(self, a: torch.Tensor, b: torch.Tensor,
               alpha: float = 1.0) -> torch.Tensor:
        """The f32 solve on [B, ...] tensors on the device."""
        _check_shape(a, (self.am, self.am), "trsm A")
        _check_shape(b, (self.desc.m, self.desc.n), "trsm B")
        if alpha != 1.0:
            b = b * alpha
        # Reduce to a LEFT solve  M_eff @ Y = B_eff:
        #   side=L: M_eff = op(A),    B_eff = B
        #   side=R: X op(A) = B  <=>  op(A)^T X^T = B^T
        #           M_eff = op(A)^T,  B_eff = B^T
        # The array needs a transpose (and the stored triangle flips)
        # exactly when one of {side=R, trans} holds but not both.
        eff_uplo = self.uplo
        if self.side == "R":
            b = b.transpose(-1, -2)
        if (self.side == "R") != self.trans:
            a = a.transpose(-1, -2)
            eff_uplo = "U" if eff_uplo == "L" else "L"
        kern = getattr(packed_kernels, self.kernel_name)
        x = kern(pack_lanes(a), pack_lanes(b), self.unit,
                 upper=eff_uplo == "U").permute(2, 0, 1)
        if self.side == "R":
            x = x.transpose(-1, -2)
        return x

    def packed(self, ap, bp) -> torch.Tensor:
        """X [M, N, Bp] of A X = B on packed operands A [M, M, Bp], B [M, N,
        Bp] (f32, on the device; numpy taken as well): kernel 13 or 14
        alone, for a left, untransposed descriptor.  Lower: tril(A) X = B
        (the data-parallel wrapper's form, ``parallel/dist_spmm.dp_packed``);
        upper: triu(A) X = B by the kernel's upper variant, which reads A
        in place, so ``ap`` may be getrf's packed LU as it stands."""
        if self.side != "L" or self.trans:
            raise ValueError("packed() solves the left untransposed lower or "
                             f"upper system; this descriptor is side="
                             f"{self.side} uplo={self.uplo} trans="
                             f"{self.trans}")
        with trace.scope(self.name + "_packed", "frontend"):
            dev = platform.device()
            ap = _f32(ap, dev, slot="ap").contiguous()
            bp = _f32(bp, dev, slot="bp").contiguous()
            return getattr(packed_kernels, self.kernel_name)(
                ap, bp, self.unit, upper=self.uplo == "U")

    def _op_a(self, a, tril, triu):
        """op(A) with only its referenced triangle kept (array functions
        of numpy or torch); the caller sets a unit diagonal."""
        opa = a.swapaxes(-1, -2) if self.trans else a
        # the referenced triangle flips under the transpose
        res_uplo = (("U" if self.uplo == "L" else "L") if self.trans
                    else self.uplo)
        return (tril if res_uplo == "L" else triu)(opa)

    def __call__(self, a, b, alpha: float = 1.0, refine=None):
        """Solve; for f64 descriptors one refinement step is applied.

        refine: None/True = device split2 residual (~4e-8 rel); "host" =
        f64 residual on the host (~1e-9 rel, two more host round trips);
        False = plain f32 solve (~1e-6 rel).
        """
        with trace.scope(self.name):
            return self._call(a, b, alpha, refine)

    def _call(self, a, b, alpha, refine):
        dev = platform.device()
        if self.is_f64 and refine == "host":
            a64 = _host_f64(a)
            b64 = _host_f64(b) * alpha
            a32 = _f32(a64, dev, slot="a")
            x0 = _f32_to_numpy_f64(self._solve(a32, _f32(b64, dev, slot="b")))
            opa = self._op_a(a64, np.tril, np.triu)
            if self.unit:
                idx = np.arange(opa.shape[-1])
                opa[..., idx, idx] = 1.0
            r = b64 - opa @ x0 if self.side == "L" else b64 - x0 @ opa
            dx = _f32_to_numpy_f64(self._solve(a32, _f32(r, dev, slot="r")))
            return x0 + dx
        if self.is_f64 and (refine or refine is None):
            ah, al = split_f64(a, dev, slot="a")
            bh, bl = split_f64(as_tensor(b, dev, torch.float64, slot="b")
                               * alpha, dev)
            x0 = self._solve(ah, bh)
            opa_h = self._op_a(ah, torch.tril, torch.triu)
            opa_l = self._op_a(al, torch.tril, torch.triu)
            if self.unit:
                eye = torch.eye(self.am, dtype=torch.float32, device=dev)
                opa_h = opa_h * (1 - eye) + eye
                opa_l = opa_l * (1 - eye)
            if self.side == "L":
                ax_h, ax_l = _matmul(opa_h, x0), _matmul(opa_l, x0)
            else:
                ax_h, ax_l = _matmul(x0, opa_h), _matmul(x0, opa_l)
            # r = (bh + bl) - (ax_h + ax_l), accumulated hi-first
            r = ((bh - ax_h) + bl) - ax_l
            dx = self._solve(ah, r)
            return _to_numpy_f64(x0.to(torch.float64) + dx.to(torch.float64))
        out = self._solve(_f32(a, dev, slot="a"), _f32(b, dev, slot="b"),
                          alpha)
        return _f32_to_numpy_f64(out) if self.is_f64 else out


# ---------------------------------------------------------------------------
# TRMM — triangular matmul = masked batched SMM
# ---------------------------------------------------------------------------


class TrmmKernel:
    """B := alpha * op(A) @ B (side=L) or alpha * B @ op(A) (side=R).

    The batched SMM with the triangle masked (and alpha folded into A) at
    pack time, as the reference's packed TRMM generator emits a dense
    kernel over the masked triangle (generator_packed_trmm_avx_avx512.c).
    side=R maps onto the same m x n x k batched GEMM with (B, A) swapped; f64
    follows the configured split strategy via the underlying dispatch.
    """

    def __init__(self, desc: PackedDescriptor):
        self.desc = desc
        self.is_f64 = desc.dtype == "float64"
        m, n = desc.m, desc.n
        # side L: [m,m] @ [m,n] -> (m, n, k=m); side R: [m,n] @ [n,n]
        k = m if desc.side.upper() == "L" else n
        self._smm = mmdispatch(m, n, k, in_dtype=desc.dtype,
                               batch=desc.batch, beta=0.0)

    def _mask(self, a: torch.Tensor, alpha: float) -> torch.Tensor:
        """Pack-time triangle mask + unit diagonal + op(A) + alpha fold."""
        d = self.desc
        a = (torch.tril if d.uplo.upper() == "L" else torch.triu)(a)
        if d.diag.upper() == "U":
            e = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
            a = a * (1 - e) + e
        if d.transa.upper() == "T":
            a = a.swapaxes(-1, -2)
        return a * alpha

    def __call__(self, a, b, alpha: float = 1.0):
        d = self.desc
        # mask and scale on the device in the descriptor's dtype (f64 too);
        # for f64 the dispatched kernel then runs its configured split schedule
        a = self._mask(as_tensor(a, platform.device(), TORCH_DTYPES[d.dtype]),
                       alpha)
        if d.side.upper() == "L":
            return self._smm(a, b)
        return self._smm(b, a)


# ---------------------------------------------------------------------------
# Dispatch frontends
# ---------------------------------------------------------------------------


def getrf_dispatch(m: int, n: int, dtype="float32",
                   batch: int = 1) -> GetrfKernel:
    """libxsmm_dispatch_getrf analog."""
    desc = PackedDescriptor(op="getrf", m=m, n=n, dtype=dtype_name(dtype),
                            batch=batch)
    return get_registry().dispatch(desc, lambda: GetrfKernel(desc),
                                   name=f"getrf_{m}x{n}")


def trsm_dispatch(m: int, n: int, dtype="float32", side="L", uplo="L",
                  transa="N", diag="N", batch: int = 1) -> TrsmKernel:
    """libxsmm_dispatch_trsm analog; (m, n) are the B-matrix dims."""
    desc = PackedDescriptor(op="trsm", m=m, n=n, dtype=dtype_name(dtype),
                            side=side, uplo=uplo, transa=transa, diag=diag,
                            batch=batch)
    return get_registry().dispatch(desc, lambda: TrsmKernel(desc),
                                   name=f"trsm_{side}{uplo}{transa}{diag}_{m}x{n}")


def trmm_dispatch(m: int, n: int, dtype="float32", side="L", uplo="L",
                  transa="N", diag="N", batch: int = 1) -> TrmmKernel:
    """libxsmm_dispatch_trmm analog."""
    desc = PackedDescriptor(op="trmm", m=m, n=n, dtype=dtype_name(dtype),
                            side=side, uplo=uplo, transa=transa, diag=diag,
                            batch=batch)
    return get_registry().dispatch(desc, lambda: TrmmKernel(desc),
                                   name=f"trmm_{side}{uplo}{transa}{diag}_{m}x{n}")
