"""Matrix copy and transpose (the xcopy domain).

The port of ``xsmm_tpu/ops/xcopy.py``.  Reference: src/libxsmm_xcopy.c —
tiled libxsmm_matcopy (:106), out-of-place libxsmm_otrans (:244), in-place
itrans (:381), with JIT'd mcopy/trans kernels above a size threshold.

The routes are the JAX package's, so the same calls reach a kernel in both
packages:

* ``MatcopyKernel`` runs the copy kernel (``ops/xcopy_kernels.py``) exactly
  where the JAX package takes its Pallas copy (``_kernel_route``: the
  [rows, n] view has rows % 8 == 0, n % 128 == 0, rows >= 512 and a row
  block that divides rows under its 4 MB block cap); other shapes take
  ``clone``, the analog of the XLA copy.  The zero-source mode is
  ``torch.zeros`` on the device, as the JAX package's is ``jnp.zeros``.
* ``TransKernel`` runs the transpose kernel for 2-D arrays with
  m >= 512 and n >= 512; everything else (batched or small) takes
  ``transpose(-1, -2).contiguous()``, the analog of XLA's transpose.

Every result is a new contiguous tensor on ``platform.device()``, never a
view; ``itrans`` is functional, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ..core import platform
from ..core.descriptors import (ITEMSIZE, TORCH_DTYPES, MatcopyDescriptor,
                                TransDescriptor, dtype_name)
from ..core.registry import get_registry
from . import xcopy_kernels
from .smm import as_tensor

_TILE = 512  # rows per grid step of the JAX package's streaming copy


def _kernel_route(rows: int, n: int, itemsize: int) -> bool:
    """Whether the JAX package's MatcopyKernel takes its Pallas copy for a
    [rows, n] view of ``itemsize``-byte elements (xsmm_tpu/ops/xcopy.py:
    72-86)."""
    if rows % 8 or n % 128 or rows < _TILE:
        return False
    # the JAX package caps its row block at ~4 MB; rows too wide to tile
    # under the cap take the XLA copy
    max_rows = (4 * 1024 * 1024) // max(1, n * itemsize)
    max_rows = max_rows // 8 * 8
    if max_rows < 8:
        return False
    bt = min(_TILE, rows, max_rows)
    while rows % bt:
        bt //= 2
    return bt >= 8


def _check_shape(x: torch.Tensor, m: int, n: int) -> None:
    if x.dim() < 2 or tuple(x.shape[-2:]) != (m, n):
        raise ValueError(f"kernel built for [..., {m}, {n}], got "
                         f"{tuple(x.shape)}")


class MatcopyKernel:
    """Batched matrix copy (or zero-fill) kernel.

    Call: kernel(x) -> copy of x; kernel() -> zeros (zero_source mode).
    Shapes: [..., M, N] with any leading batch dims.
    """

    def __init__(self, desc: MatcopyDescriptor):
        self.desc = desc

    def __call__(self, x=None):
        d = self.desc
        dev = platform.device()
        if d.zero_source:
            shape = ((d.batch,) if d.batch > 1 else ()) + (d.m, d.n)
            return torch.zeros(shape, dtype=TORCH_DTYPES[d.dtype], device=dev)
        x = as_tensor(x, dev)
        _check_shape(x, d.m, d.n)
        rows = d.m * math.prod(x.shape[:-2])
        if _kernel_route(rows, d.n, ITEMSIZE[d.dtype]):
            return xcopy_kernels.copy(x.contiguous())
        return x.clone(memory_format=torch.contiguous_format)


class TransKernel:
    """Out-of-place transpose: [..., M, N] -> [..., N, M].

    2-D arrays with both dims >= 512 run through the transpose kernel;
    everything else takes PyTorch's transpose and copy.
    """

    TM = 512
    TN = 512

    def __init__(self, desc: TransDescriptor):
        self.desc = desc
        self.use_kernel = desc.m >= self.TM and desc.n >= self.TN

    def __call__(self, x):
        dev = platform.device()
        x = as_tensor(x, dev)
        _check_shape(x, self.desc.m, self.desc.n)
        if x.dim() != 2 or not self.use_kernel:
            return x.transpose(-1, -2).contiguous()
        return xcopy_kernels.trans(x.contiguous())


# ---------------------------------------------------------------------------
# Dispatch frontends (libxsmm_dispatch_mcopy / _trans analogs,
# libxsmm_main.c:2318-2422)
# ---------------------------------------------------------------------------


def matcopy_dispatch(m: int, n: int, dtype="float32", zero_source=False,
                     batch: int = 1) -> MatcopyKernel:
    desc = MatcopyDescriptor(m=m, n=n, dtype=dtype_name(dtype),
                             zero_source=zero_source, batch=batch)
    return get_registry().dispatch(
        desc, lambda: MatcopyKernel(desc), name=f"mcopy_{m}x{n}")


def trans_dispatch(m: int, n: int, dtype="float32",
                   batch: int = 1) -> TransKernel:
    desc = TransDescriptor(m=m, n=n, dtype=dtype_name(dtype), batch=batch)
    return get_registry().dispatch(
        desc, lambda: TransKernel(desc), name=f"trans_{m}x{n}")


def matcopy(x, zero: bool = False):
    """One-shot convenience (libxsmm_matcopy analog, libxsmm_xcopy.c:106)."""
    m, n = x.shape[-2], x.shape[-1]
    k = matcopy_dispatch(m, n, dtype=x.dtype, zero_source=zero,
                         batch=math.prod(x.shape[:-2]))
    return k() if zero else k(x)


def otrans(x):
    """Out-of-place transpose (libxsmm_otrans analog, libxsmm_xcopy.c:244)."""
    m, n = x.shape[-2], x.shape[-1]
    return trans_dispatch(m, n, dtype=x.dtype,
                          batch=math.prod(x.shape[:-2]))(x)


def itrans(x):
    """In-place transpose analog (libxsmm_xcopy.c:381): functional, a new
    tensor, as in the JAX package."""
    return otrans(x)
