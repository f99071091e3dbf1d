"""Tiled large-GEMM frontend — the libxsmm_gemm_handle analog.

The port of ``xsmm_tpu/ops/tiled_gemm.py``.  Reference:
libxsmm_gemm_handle_init (src/libxsmm_gemm.c:790) plans tile sizes
km/kn/kk from arch tables (:317-427); env knobs LIBXSMM_TGEMM_M/N/K
override the plan.

``_plan_tiles`` is the JAX package's, unchanged, so ``h.bm/h.bn/h.bk`` and
the ``XSMM_TGEMM_M/N/K`` overrides give the same plan in both packages; the
plan is part of the handle and sets the K panel of the plain version.  The
CUDA kernel (``ops/tiled_gemm_kernels.py``) uses its own 128 x 128 block
tile and masks ragged M, N and K in place, so nothing is padded.

Semantics kept from the JAX package: the inputs are cast to ``in_dtype``,
the sum is f32, the result is cast to ``out_dtype`` (default ``in_dtype``),
and ``c0`` is added after that cast, in ``out_dtype``.  The kernel takes
f32, bf16 and f16 in and out; other dtypes raise ``ValueError``.
"""

from __future__ import annotations

import torch

from ..core import platform
from ..core.config import get_config
from ..core.descriptors import (ITEMSIZE, TORCH_DTYPES, GemmDescriptor,
                                dtype_name, gemm_flags)
from ..core.registry import get_registry
from . import tiled_gemm_kernels
from .pack_util import round_up
from .smm import as_tensor

_TYPES = ("float32", "bfloat16", "float16")


def _plan_tiles(m: int, n: int, k: int, itemsize: int):
    """Tile-size planning (the internal_gemm_vwidth/mlimit table analog),
    as in the JAX package (xsmm_tpu/ops/tiled_gemm.py:38-80): 1024 x 1024 C
    tiles with K panels of 512, the tile per dimension that pads least, and
    a halving loop under the TPU's 24 MB block budget."""
    cfg = get_config()

    def pick(dim: int, cap: int) -> int:
        """Largest tile <= cap that minimizes padding waste."""
        if dim <= 128:
            return 128
        best, best_waste = 128, None
        for cand in (1024, 768, 512, 384, 256, 128):
            if cand > cap:
                continue
            waste = round_up(dim, cand) - dim
            if best_waste is None or waste < best_waste or (
                    waste == best_waste and cand > best):
                best, best_waste = cand, waste
        return best

    bm = cfg.tgemm_m or pick(m, 1024)
    bn = cfg.tgemm_n or pick(n, 1024)
    bk = cfg.tgemm_k or pick(k, 512)
    # shrink until blocks fit the budget (double-buffered in/out + the f32
    # accumulator)
    budget = 24 * 1024 * 1024
    while (2 * (bm * bk + bk * bn + bm * bn) * itemsize
           + 4 * bm * bn) > budget:
        big = max(bm, bn, bk)
        if bm == big and bm > 128:
            bm //= 2
        elif bn == big and bn > 128:
            bn //= 2
        elif bk > 128:
            bk //= 2
        else:
            break
    return bm, bn, bk


class TiledGemm:
    """Planned large matmul: C = A @ B (+ C0) through the tiled-GEMM
    kernel.

    ``in_dtype``/``out_dtype`` are ``torch.dtype``s; ``precision`` is kept
    for parity with the JAX package ("highest" for f32, else "default"):
    f32 always runs in full f32 here, bf16/f16 on the tensor cores with an
    f32 sum.
    """

    def __init__(self, m: int, n: int, k: int, in_dtype="float32",
                 out_dtype=None, precision=None):
        names = (dtype_name(in_dtype), dtype_name(out_dtype or in_dtype))
        if names[0] not in _TYPES or names[1] not in _TYPES:
            raise ValueError(f"tiled GEMM takes {_TYPES} in and out, got "
                             f"{names[0]} -> {names[1]}")
        self.m, self.n, self.k = m, n, k
        self.in_dtype, self.out_dtype = (TORCH_DTYPES[x] for x in names)
        self.precision = precision if precision is not None else (
            "highest" if names[0] == "float32" else "default")
        self.bm, self.bn, self.bk = _plan_tiles(m, n, k, ITEMSIZE[names[0]])

    def __call__(self, a, b, c0=None):
        dev = platform.device()
        a = as_tensor(a, dev, self.in_dtype)
        b = as_tensor(b, dev, self.in_dtype)
        if (tuple(a.shape), tuple(b.shape)) != ((self.m, self.k),
                                                (self.k, self.n)):
            raise ValueError(f"handle is {self.m}x{self.n}x{self.k}, got "
                             f"A{tuple(a.shape)} B{tuple(b.shape)}")
        out = tiled_gemm_kernels.gemm(a.contiguous(), b.contiguous(),
                                      out_dtype=self.out_dtype, bk=self.bk)
        if c0 is not None:
            out = out + as_tensor(c0, dev, self.out_dtype)
        return out


def gemm_handle(m: int, n: int, k: int, in_dtype="float32", out_dtype=None,
                beta: float = 0.0) -> TiledGemm:
    """Create/cache a tiled-GEMM plan (libxsmm_gemm_handle_init analog)."""
    desc = GemmDescriptor(m=m, n=n, k=k, in_dtype=dtype_name(in_dtype),
                          out_dtype=dtype_name(out_dtype or in_dtype),
                          flags=gemm_flags(beta=beta), batch=0)  # batch=0 tags tiled
    return get_registry().dispatch(
        desc, lambda: TiledGemm(m, n, k, in_dtype, out_dtype),
        name=f"tgemm_{m}x{n}x{k}")


def xgemm(a, b, c0=None):
    """Big-GEMM convenience (libxsmm_?gemm large path / _omp analog): A's
    dtype is the handle's in and out dtype."""
    if len(a.shape) != 2 or len(b.shape) != 2:
        raise ValueError(f"xgemm takes 2-D A and B, got A{tuple(a.shape)} "
                         f"B{tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {k} vs {k2}")
    h = gemm_handle(m, n, k, in_dtype=a.dtype,
                    beta=0.0 if c0 is None else 1.0)
    return h(a, b, c0)
