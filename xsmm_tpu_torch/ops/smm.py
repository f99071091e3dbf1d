"""Small-matrix-multiply (SMM) dispatch and kernels on the card.

The port of ``xsmm_tpu/ops/smm.py``: shape-specialized GEMM behind
``libxsmm_?mmdispatch`` (src/libxsmm_main.c:2139-2316) with the reference's
restrictions, alpha = 1 and beta in {0, 1} (README.md:11).

* **Batched SMM** (``BatchedSMM``) runs one problem per batch index on the
  lane-packed layout A ``[M,K,B]``, B ``[K,N,B]``, C ``[M,N,B]``, through
  the three hand-written CUDA kernels of ``ops/smm_packed.py``; an f32 call
  on batch-first tensors runs its natural kernel on them unpacked.
* **Large, single and integer GEMMs** (``XlaGemm``) and **batch-reduce GEMM**
  (``BatchReduceGemm``, one flattened ``[M, I*K] @ [I*K, N]`` product) are
  plain products that the JAX package leaves to XLA; here they are
  ``torch.matmul``.  f32 products run in full f32: ``_matmul`` runs every
  f32 call with ``torch.backends.cuda.matmul.allow_tf32 = False`` and the
  f32 matmul precision "highest", and puts the caller's settings back after
  it (the reference forces ``Precision.HIGHEST`` on one call).  Integer
  products run in f64 and are cast back, exact while |a|*|b|*K < 2**53
  (int16 is).
* **FP64** follows ``XSMM_F64``: ``split2_fast`` (default), ``split2`` and
  ``float32`` carry f64 as f32 hi/lo pairs exactly as the reference does,
  split on the device; ``native`` is a real f64 ``torch.matmul`` (the JAX
  package needs x64 for it and raises without; this package does not).

Entry points take numpy arrays or tensors and run on ``platform.device()``:
the card, or the CPU with ``target="cpu"``.  f64 calls return numpy f64
arrays, as the reference does; the others return tensors on that device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core import platform
from ..core.config import config_generation, get_config
from ..core.descriptors import (ITEMSIZE, TORCH_DTYPES, GemmDescriptor,
                                dtype_name, gemm_flags, is_integer)
from ..core.registry import Stats, get_registry
from ..utils import scratch, trace
from . import smm_packed
from .pack_util import LANES

# ---------------------------------------------------------------------------
# Tensors in and out
# ---------------------------------------------------------------------------


def as_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None,
              slot: str = "") -> torch.Tensor:
    """A tensor on ``device`` from a tensor or an array-like.  numpy bf16
    arrays (ml_dtypes) cross through a uint16 view, so ml_dtypes is never
    imported here.

    On the CPU target a numpy array becomes a tensor on its own memory
    (zero-copy).  For the card, a numpy array is read in full before this
    returns and staged through the pinned pool
    (``utils/scratch.host_to_device``; ``slot`` names the operand within a
    call, so two same-shape operands do not share a buffer)."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            arr = np.ascontiguousarray(arr).view(np.uint16)
            x = torch.from_numpy(arr.copy()).view(torch.bfloat16)
        else:
            if not arr.flags.writeable or not arr.flags.c_contiguous:
                arr = np.array(arr, copy=True, order="C")
            if device.type == "cuda":
                return scratch.host_to_device(arr, device, dtype, slot)
            x = torch.from_numpy(arr)
    if dtype is None:
        return x.to(device=device)
    return x.to(device=device, dtype=dtype)


def packed_from_numpy(arr, device=None) -> torch.Tensor:
    """The port's packed tensor holding the same values as a numpy array,
    e.g. the JAX package's ``np.asarray(kern.pack_a(a))`` (bf16 included)."""
    return as_tensor(arr, platform.device() if device is None else device)


# ---------------------------------------------------------------------------
# FP64 <-> two-float split helpers
# ---------------------------------------------------------------------------


def split_f64(x, device=None,
              slot: str = "x") -> Tuple[torch.Tensor, torch.Tensor]:
    """Split float64 data into (hi, lo) float32 tensors on the device:
    hi = f32(x), lo = f32(x - hi) (the residual is exact in f64).  numpy
    data goes to the card as f64 through the pinned pool under ``slot``
    and is split there."""
    x = as_tensor(x, platform.device() if device is None else device,
                  torch.float64, slot=f"split_{slot}")
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def join_f64(hi, lo=None) -> np.ndarray:
    """hi (+ lo) in f64, as a numpy array (a new one, never pool memory)."""
    out = torch.as_tensor(hi).to(torch.float64)
    if lo is not None:
        out = out + torch.as_tensor(lo).to(device=out.device,
                                           dtype=torch.float64)
    return _to_numpy_f64(out)


def _to_numpy_f64(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy: on the CPU its own memory; from the card in a
    pinned block leased from the pool (``scratch.device_to_host``),
    synchronized before it is returned."""
    if t.device.type == "cuda":
        return scratch.device_to_host(t)
    return t.contiguous().numpy()


# ---------------------------------------------------------------------------
# Routing rule (the reference's, kept so both packages route alike)
# ---------------------------------------------------------------------------


def _vmem_per_lane(desc: GemmDescriptor, strategy: Optional[str]) -> int:
    """The reference's per-problem TPU VMEM estimate (xsmm_tpu/ops/smm.py:
    142-164).  It is not a budget of this card; ``_build`` uses it only so
    that both packages send every descriptor to the same class."""
    m, n, k, beta = desc.m, desc.n, desc.k, desc.beta
    if strategy == "split2":
        na, nb, nc = 2, 2, 2 * (2 if beta else 1)
        scratch, itemsize = 0, 4
    elif strategy == "split2_fast":
        na, nb, nc = 1, 2, (2 if beta else 1)
        scratch, itemsize = m * n * 4, 4
    elif strategy == "float32":
        na, nb, nc = 1, 1, (2 if beta else 1)
        scratch, itemsize = 0, 4
    else:
        na, nb, nc = 1, 1, (2 if beta else 1)
        scratch, itemsize = 0, ITEMSIZE[desc.in_dtype]
    return (2 * (na * m * k + nb * k * n + nc * m * n) * itemsize
            + scratch)


def _fits_vmem(desc: GemmDescriptor, strategy: Optional[str]) -> bool:
    """The reference's routing test (xsmm_tpu/ops/smm.py:188-190)."""
    return _vmem_per_lane(desc, strategy) * LANES <= 14 * 1024 * 1024


# ---------------------------------------------------------------------------
# Batched SMM on the packed kernels
# ---------------------------------------------------------------------------

_PACKED_TYPES = ("float32", "bfloat16", "float16")


class _Kernel:
    """What every dispatched kernel holds: its descriptor and, for f64, the
    strategy it was built under.  The device is the configured one at each
    call, so a kernel built for the CPU cannot run there once the target is
    the card; building or calling raises without a card."""

    def __init__(self, desc: GemmDescriptor):
        self.desc = desc
        self.is_f64 = desc.in_dtype == "float64"
        self.strategy = get_config().f64_strategy if self.is_f64 else None
        # the profiler's name of this kernel's calls (utils/trace)
        self.name = trace.kernel_name("smm", desc)
        platform.device()

    @property
    def device(self) -> torch.device:
        return platform.device()


class BatchedSMM(_Kernel):
    """Batched small-GEMM kernel, one problem per batch index.

    Packed layout (batch innermost; A m-leading, B k-leading, as the
    reference):
      A packed: [M, K, Bp]   (pack_a: transpose of [B,M,K])
      B packed: [K, N, Bp]
      C packed: [M, N, Bp]
    The kernels take any Bp, so packing does not pad.

    Call forms:
      * ``kernel(a, b[, c])`` with [B,M,K]/[B,K,N]/[B,M,N] operands: f32 in
        and out on contiguous operands runs the natural kernel on them as
        they are and returns a contiguous [B,M,N] (``_natural``); every
        other call packs, computes and returns the unpacked view;
      * ``kernel.packed(ap, bp[, cp])`` on packed operands: by strategy
        (ah, bh, bl[, ch]) for split2_fast, (ah, al, bh, bl[, ch, cl]) for
        split2 (returns (ch, cl)), (a, b[, c]) otherwise.
    """

    def __init__(self, desc: GemmDescriptor):
        # "native" never reaches here: _build routes it to XlaGemm
        super().__init__(desc)
        if not self.is_f64 and (desc.in_dtype not in _PACKED_TYPES
                                or desc.out_dtype not in _PACKED_TYPES):
            raise ValueError(f"batched SMM takes {_PACKED_TYPES} in and out, "
                             f"got {desc.in_dtype} -> {desc.out_dtype}")
        f32 = torch.float32
        self.in_dt = f32 if self.is_f64 else TORCH_DTYPES[desc.in_dtype]
        self.out_dt = f32 if self.is_f64 else TORCH_DTYPES[desc.out_dtype]

    # -- layout helpers ------------------------------------------------------
    def pack_a(self, a) -> torch.Tensor:
        """[B,M,K] (or [B,K,M] if trans_a) -> [M,K,B]."""
        perm = (2, 1, 0) if self.desc.trans_a else (1, 2, 0)
        return as_tensor(a, self.device).permute(perm).contiguous()

    def pack_b(self, b) -> torch.Tensor:
        """[B,K,N] (or [B,N,K] if trans_b) -> [K,N,B]."""
        perm = (2, 1, 0) if self.desc.trans_b else (1, 2, 0)
        return as_tensor(b, self.device).permute(perm).contiguous()

    def pack_c(self, c) -> torch.Tensor:
        """[B,M,N] -> [M,N,B]."""
        return as_tensor(c, self.device).permute(1, 2, 0).contiguous()

    def unpack_c(self, cp: torch.Tensor, batch: int) -> torch.Tensor:
        """[M,N,Bp] -> [B,M,N]."""
        return cp.permute(2, 0, 1)[:batch]

    # -- packed path --------------------------------------------------------
    def packed(self, *ops):
        """Execute on packed operands; see the class docstring."""
        n_in = {"split2": 4, "split2_fast": 3}.get(self.strategy, 2)
        n_c = (2 if self.strategy == "split2" else 1) if self.desc.beta else 0
        if len(ops) != n_in + n_c:
            raise ValueError(f"packed() takes {n_in + n_c} operands for "
                             f"strategy {self.strategy} beta={self.desc.beta}"
                             f", got {len(ops)}")
        with trace.scope(self.name + "_packed", "frontend"):
            ops = [as_tensor(o, self.device,
                             self.in_dt if i < n_in else self.out_dt,
                             slot=f"packed{i}")
                   for i, o in enumerate(ops)]
            if self.strategy == "split2":
                return smm_packed.packed_split2(*ops)
            if self.strategy == "split2_fast":
                return smm_packed.packed_split2_fast(*ops)
            return smm_packed.packed_f32(*ops, out_dtype=self.out_dt)

    # -- convenience full path ----------------------------------------------
    def _natural(self, a: torch.Tensor, b: torch.Tensor,
                 c: Optional[torch.Tensor]) -> bool:
        """Whether the call takes the natural kernel
        (``smm_packed.natural_f32``): f32 in and out, contiguous 3-D
        operands, and a ring of groups small enough that an SM holds
        ``NATURAL_ROUTE_BLOCKS`` of its blocks.  Every other call packs."""
        ops = (a, b) if c is None else (a, b, c)
        if not (self.desc.in_dtype == self.desc.out_dtype == "float32"
                and all(t.dim() == 3 and t.is_contiguous() for t in ops)):
            return False
        m, k = a.shape[1:][::-1] if self.desc.trans_a else a.shape[1:]
        n = b.shape[1] if self.desc.trans_b else b.shape[2]
        return (smm_packed.natural_blocks(m, n, k)
                >= smm_packed.NATURAL_ROUTE_BLOCKS)

    def _full(self, a, b, c=None):
        dev = self.device
        a = as_tensor(a, dev, self.in_dt, slot="a")
        b = as_tensor(b, dev, self.in_dt, slot="b")
        if self.desc.beta:
            if c is None:
                raise ValueError("beta=1 kernel requires c operand")
            c = as_tensor(c, dev, self.out_dt, slot="c")
        else:
            c = None
        if self._natural(a, b, c):
            return smm_packed.natural_f32(a, b, c, trans_a=self.desc.trans_a,
                                          trans_b=self.desc.trans_b)
        ops = [self.pack_a(a), self.pack_b(b)]
        if c is not None:
            ops.append(self.pack_c(c))
        return self.unpack_c(self.packed(*ops), ops[0].shape[-1])

    def __call__(self, a, b, c=None):
        """a: [B,M,K] (or [B,K,M] if trans_a), b: [B,K,N]; returns [B,M,N].

        For float64 descriptors the operands are split into f32 hi/lo pairs
        on the device and the result is a float64 numpy array (hi + lo
        joined in f64).
        """
        with trace.scope(self.name, "frontend"):
            if not self.is_f64:
                return self._full(a, b, c)
            return self._call_f64(a, b, c)

    def _call_f64(self, a, b, c):
        if self.desc.beta and c is None:
            raise ValueError("beta=1 kernel requires c operand")
        dev, f32 = self.device, torch.float32
        # split only the halves the schedule reads; an operand read as hi
        # alone crosses from numpy as f32 (rounded by the host, the same
        # bits as on the card), one that is split crosses as f64
        if self.strategy == "split2":
            ah, al = split_f64(a, dev, slot="a")
            bh, bl = split_f64(b, dev, slot="b")
            ops = [self.pack_a(ah), self.pack_a(al),
                   self.pack_b(bh), self.pack_b(bl)]
        elif self.strategy == "split2_fast":
            ah = as_tensor(a, dev, f32, slot="a")
            bh, bl = split_f64(b, dev, slot="b")
            ops = [self.pack_a(ah), self.pack_b(bh), self.pack_b(bl)]
        else:  # float32: hi-only compute
            ah = as_tensor(a, dev, f32, slot="a")
            ops = [self.pack_a(ah), self.pack_b(as_tensor(b, dev, f32,
                                                          slot="b"))]
        cl = None
        if self.desc.beta:
            ch, cl = split_f64(c, dev, slot="c")
            if self.strategy == "split2":
                ops += [self.pack_c(ch), self.pack_c(cl)]
                cl = None  # consumed in-kernel by the dual-output path
            else:
                ops.append(self.pack_c(ch))
        out = self.packed(*ops)
        batch = ah.shape[0]
        if isinstance(out, tuple):
            res = (self.unpack_c(out[0], batch).to(torch.float64)
                   + self.unpack_c(out[1], batch).to(torch.float64))
        else:
            res = self.unpack_c(out, batch).to(torch.float64)
        if cl is not None:
            # re-add C's low half in f64: without it, accumulate-into-C
            # chains truncate the accumulator to f32 every call
            res = res + cl.to(torch.float64)
        return _to_numpy_f64(res)


# ---------------------------------------------------------------------------
# Plain product paths: single GEMM, large GEMM, batch-reduce
# ---------------------------------------------------------------------------


# The originals, taken when this module is imported: inside an
# ``mmbatch_begin`` scope ``torch.matmul``/``torch.einsum`` are the recording
# wrappers, and the package's own products must neither be recorded nor be
# rerouted back into dispatch (ops/mmbatch.py).
_torch_matmul = torch.matmul
_torch_einsum = torch.einsum


@contextlib.contextmanager
def _full_f32(dtype: torch.dtype):
    """Around one f32 product: TF32 (and the CPU's reduced-precision
    matmul) off, as the JAX package's ``precision=HIGHEST`` for one call,
    then the caller's settings back, in the API the caller set them with:
    ``allow_tf32`` and the f32 matmul precision, or, where those cannot be
    read because the caller used the per-backend ``fp32_precision``, that."""
    if dtype != torch.float32:
        yield
        return
    try:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        prec = torch.get_float32_matmul_precision()
    except RuntimeError:  # set through the per-backend API
        backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
        saved = [b.fp32_precision for b in backends]
        for b in backends:
            b.fp32_precision = "ieee"
        try:
            yield
        finally:
            for b, v in zip(backends, saved):
                b.fp32_precision = v
        return
    if not tf32 and prec == "highest":
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


@contextlib.contextmanager
def _full_f32_conv(dtype: torch.dtype):
    """``_full_f32`` for one f32 convolution: cuDNN's TF32 (its default for
    convs) off, as the JAX package's ``precision=HIGHEST``, then the
    caller's setting back: ``torch.backends.cudnn.allow_tf32``, or, where
    it cannot be read because the caller used the per-backend
    ``fp32_precision``, that of cuDNN's and oneDNN's convs."""
    if dtype != torch.float32:
        yield
        return
    try:
        tf32 = torch.backends.cudnn.allow_tf32
    except RuntimeError:  # set through the per-backend API
        backends = (torch.backends.cudnn.conv, torch.backends.mkldnn.conv)
        saved = [b.fp32_precision for b in backends]
        for b in backends:
            b.fp32_precision = "ieee"
        try:
            yield
        finally:
            for b, v in zip(backends, saved):
                b.fp32_precision = v
        return
    if not tf32:
        yield
        return
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul with f32 in full f32."""
    with _full_f32(a.dtype):
        return _torch_matmul(a, b)


def _einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum of two operands with f32 in full f32."""
    with _full_f32(a.dtype):
        return _torch_einsum(spec, a, b)


def _acc_dtype(in_dtype: str) -> torch.dtype:
    """Integer products run in f64 (PyTorch's CUDA matmul has no integer
    kernels) and are cast back; float products accumulate in f32."""
    return torch.float64 if is_integer(in_dtype) else torch.float32


def _swap(x: torch.Tensor, trans: bool) -> torch.Tensor:
    return x.transpose(-1, -2) if trans else x


class XlaGemm(_Kernel):
    """Single / large / integer GEMM through ``torch.matmul`` — the
    BLAS-fallback analog; the class keeps the reference's name.

    f64 follows the configured strategy: split2 = 3 f32 products,
    split2_fast drops Al*Bh, float32 = hi only, native = one f64 product.
    """

    def _mm(self, a, b):
        return _matmul(_swap(a, self.desc.trans_a), _swap(b, self.desc.trans_b))

    def __call__(self, a, b, c=None):
        dev = self.device
        if not self.is_f64:
            acc = _acc_dtype(self.desc.in_dtype)
            out = self._mm(as_tensor(a, dev, acc, slot="a"),
                           as_tensor(b, dev, acc, slot="b"))
            if c is not None:
                out = out + as_tensor(c, dev, acc, slot="c")
            return out.to(TORCH_DTYPES[self.desc.out_dtype])
        f64 = torch.float64
        a64 = as_tensor(a, dev, f64, slot="a")
        b64 = as_tensor(b, dev, f64, slot="b")
        if self.strategy == "native":
            out = self._mm(a64, b64)
            if c is not None:
                out = out + as_tensor(c, dev, f64, slot="c")
            return _to_numpy_f64(out)
        ah, bh = a64.to(torch.float32), b64.to(torch.float32)
        ch = cl = None
        if c is not None:
            ch, cl = split_f64(c, dev, slot="c")
        lo = None
        if self.strategy == "split2":
            al = (a64 - ah.to(f64)).to(torch.float32)
            bl = (b64 - bh.to(f64)).to(torch.float32)
            hi = self._mm(ah, bh)
            lo = self._mm(ah, bl) + self._mm(al, bh)
        elif self.strategy == "float32":
            hi = self._mm(ah, bh)
        else:  # split2_fast (default)
            bl = (b64 - bh.to(f64)).to(torch.float32)
            hi = self._mm(ah, bh)
            lo = self._mm(ah, bl)
        if ch is not None:
            hi = hi + ch
        out = hi.to(f64)
        if lo is not None:
            out = out + lo.to(f64)
        if cl is not None:
            out = out + cl.to(f64)
        return _to_numpy_f64(out)


class BatchReduceGemm(_Kernel):
    """C (+)= sum_i A_i @ B_i as ONE flattened product.

    Reference ABI: kernel(a_ptr_array, b_ptr_array, c, count)
    (libxsmm_typedefs.h:538-541).  Here: stacked A [I,M,K], B [I,K,N]; the
    contraction over (i, k) is one [M, I*K] @ [I*K, N] product.
    """

    def _fn(self, a, b, c=None):
        a = _swap(a, self.desc.trans_a)
        b = _swap(b, self.desc.trans_b)
        i, m, k = a.shape
        n = b.shape[-1]
        acc = _acc_dtype(self.desc.in_dtype)
        a2 = a.permute(1, 0, 2).reshape(m, i * k).to(acc)
        out = _matmul(a2, b.reshape(i * k, n).to(acc))
        if c is not None:
            out = out + c.to(acc)
        return out.to(torch.float32 if self.is_f64
                      else TORCH_DTYPES[self.desc.out_dtype])

    def __call__(self, a, b, c=None):
        dev = self.device
        if not self.is_f64:
            c = None if c is None else as_tensor(c, dev, slot="c")
            return self._fn(as_tensor(a, dev, slot="a"),
                            as_tensor(b, dev, slot="b"), c)
        f64 = torch.float64
        a64 = as_tensor(a, dev, f64, slot="a")
        b64 = as_tensor(b, dev, f64, slot="b")
        ah, bh = a64.to(torch.float32), b64.to(torch.float32)
        out = self._fn(ah, bh).to(f64)
        if self.strategy in ("split2", "split2_fast"):
            bl = (b64 - bh.to(f64)).to(torch.float32)
            out = out + self._fn(ah, bl).to(f64)
        if self.strategy == "split2":
            al = (a64 - ah.to(f64)).to(torch.float32)
            out = out + self._fn(al, bh).to(f64)
        if c is not None:
            out = out + as_tensor(c, dev, f64, slot="c")
        return _to_numpy_f64(out)


# ---------------------------------------------------------------------------
# Dispatch frontend (libxsmm_?mmdispatch analogs, libxsmm_main.c:2139-2316)
# ---------------------------------------------------------------------------


_F64_VARIANTS = {"split2": 0, "split2_fast": 1, "float32": 2, "native": 3}


def _build(desc: GemmDescriptor):
    if desc.batch_reduce:
        return BatchReduceGemm(desc)
    small = (desc.m * desc.n * desc.k) <= get_config().gemm_threshold
    strategy = (get_config().f64_strategy if desc.in_dtype == "float64"
                else None)
    if (desc.batch > 1 and small and _fits_vmem(desc, strategy)
            and strategy != "native"   # native f64 = XlaGemm's f64 matmul
            and not is_integer(desc.in_dtype)
            and get_config().smm_backend != "xla"):
        return BatchedSMM(desc)
    return XlaGemm(desc)


def mmdispatch(m: int, n: int, k: int, *, in_dtype="float32", out_dtype=None,
               lda: int = 0, ldb: int = 0, ldc: int = 0,
               alpha: float = 1.0, beta: float = 1.0,
               transa: str = "N", transb: str = "N",
               batch: int = 1, batch_reduce: bool = False,
               prefetch: int = 0) -> Callable:
    """Generic dispatch: returns a built kernel for the descriptor.

    Analog of libxsmm_xmmdispatch (libxsmm_main.c:2139).  The kernel is built
    at most once per process and cached in the registry; the hot path is a
    raw-args memo probe (the TLS-cache analog, libxsmm_main.c:1704-1732).
    """
    with trace.span("dispatch"):
        return _mmdispatch(m, n, k, in_dtype, out_dtype, lda, ldb, ldc,
                           alpha, beta, transa, transb, batch, batch_reduce,
                           prefetch)


def _mmdispatch(m, n, k, in_dtype, out_dtype, lda, ldb, ldc, alpha, beta,
                transa, transb, batch, batch_reduce, prefetch):
    reg = get_registry()
    gen = config_generation()
    if getattr(reg, "front_memo_gen", gen) != gen:
        # config changed: stale-generation entries would otherwise pin
        # dead kernels forever (memo keys embed the generation)
        reg.front_memo.clear()
    reg.front_memo_gen = gen
    memo_key = (m, n, k, in_dtype, out_dtype, lda, ldb, ldc, alpha, beta,
                transa, transb, batch, batch_reduce, prefetch, gen)
    hit = reg.front_memo.get(memo_key)
    if hit is not None:
        kernel, row, bucket, entry = hit
        reg.stats.ntry += 1
        reg.stats.ncache_hit += 1
        row[bucket] += 1
        entry.hits += 1
        return kernel
    if alpha != 1.0:
        raise ValueError("JIT GEMM requires alpha=1 (reference README.md:11)")
    out_dtype = out_dtype or in_dtype
    variant = 0
    if dtype_name(in_dtype) == "float64":
        strategy = get_config().f64_strategy
        if strategy not in _F64_VARIANTS:
            # a typo'd strategy must not silently build (and registry-key)
            # a different schedule than the user asked for
            raise ValueError(
                f"unknown f64 strategy {strategy!r}; expected one of "
                f"{sorted(_F64_VARIANTS)}")
        variant = _F64_VARIANTS[strategy]
    desc = GemmDescriptor(
        m=m, n=n, k=k, in_dtype=dtype_name(in_dtype),
        out_dtype=dtype_name(out_dtype),
        flags=gemm_flags(transa, transb, beta, batch_reduce),
        batch=batch, prefetch=prefetch, lda=lda, ldb=ldb, ldc=ldc,
        variant=variant)
    name = f"xsmm_{in_dtype}_{m}x{n}x{k}_b{batch}{'_br' if batch_reduce else ''}"
    kernel = reg.dispatch(desc, lambda: _build(desc), name=name)
    entry = reg._table.get(desc.pack())
    if len(reg._table) < reg.capacity and entry is not None:
        # at capacity the registry deliberately degrades to uncached
        # kernels (libxsmm_main.c:1880-1890); the memo must not undo that
        # bound.  The entry rides in the memo so per-kernel hit counts stay
        # live on the memo fast path.
        row = reg.stats.by_bucket.setdefault(
            desc.in_dtype, {b: 0 for b in Stats.BUCKETS})
        reg.front_memo[memo_key] = (kernel, row, Stats.bucket(m, n, k),
                                    entry)
    return kernel


def _typed(in_dtype, out_dtype, batch_reduce=False):
    """Typed dispatcher with an inline memo probe (one call frame on a
    hit)."""
    from ..core import config as _cfg

    def dispatch(m, n, k, *, lda=0, ldb=0, ldc=0, alpha=1.0, beta=1.0,
                 transa="N", transb="N", batch=1, prefetch=0,
                 _in=in_dtype, _out=out_dtype, _br=batch_reduce):
        with trace.span("dispatch"):
            reg = get_registry()
            gen = _cfg._GENERATION
            if getattr(reg, "front_memo_gen", -1) == gen:
                hit = reg.front_memo.get(
                    (m, n, k, _in, _out, lda, ldb, ldc, alpha, beta,
                     transa, transb, batch, _br, prefetch, gen))
                if hit is not None:
                    kernel, row, bucket, entry = hit
                    st = reg.stats
                    st.ntry += 1
                    st.ncache_hit += 1
                    row[bucket] += 1
                    entry.hits += 1
                    return kernel
            return _mmdispatch(m, n, k, _in, _out, lda, ldb, ldc, alpha,
                               beta, transa, transb, batch, _br, prefetch)
    return dispatch


# Typed dispatchers (libxsmm_main.c:2166-2260): f64 through the two-float
# split (module docstring); int16 products are exact.
dmmdispatch = _typed("float64", "float64")
smmdispatch = _typed("float32", "float32")
bmmdispatch = _typed("bfloat16", "bfloat16")
bsmmdispatch = _typed("bfloat16", "float32")
wimmdispatch = _typed("int16", "int32")
wsmmdispatch = _typed("int16", "float32")


def _typed_reducebatch(in_dtype, out_dtype):
    return _typed(in_dtype, out_dtype, batch_reduce=True)


# Batch-reduce dispatchers (libxsmm_main.c:2262-2316)
dmmdispatch_reducebatch = _typed_reducebatch("float64", "float64")
smmdispatch_reducebatch = _typed_reducebatch("float32", "float32")
bsmmdispatch_reducebatch = _typed_reducebatch("bfloat16", "float32")
bmmdispatch_reducebatch = _typed_reducebatch("bfloat16", "bfloat16")
