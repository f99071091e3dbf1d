"""Batched GEMM frontends and the call-recording interceptor.

The port of ``xsmm_tpu/ops/mmbatch.py``.  Reference: libxsmm_mmbatch /
libxsmm_gemm_batch (src/libxsmm_gemm.c:1809, 1878) execute arrays of
same-shape GEMMs through one dispatched kernel; the BLAS interception
wrapper (__wrap_dgemm, libxsmm_ext_gemm.c:314) reroutes existing BLAS calls,
and libxsmm_mmbatch_begin/end records calls into a batch buffer for replay
(template/libxsmm.h:251-257).

``gemm_batch`` stacks the operand list and goes through ``mmdispatch``, so
small shapes reach the batched kernels on the card.  The interception
analog patches ``torch.matmul`` and ``torch.einsum`` (not the ``@``
operator, as the JAX package patches ``jnp.matmul`` and not ``@``) inside a
context manager, under the JAX package's rules.  The package's own products
use the originals taken at import (``ops/smm.py``), so only the caller's
calls are recorded and a rerouted call cannot re-enter the wrapper.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import List

import numpy as np
import torch

from ..core import platform
from ..core.config import get_config
from ..core.descriptors import dtype_name
from .smm import as_tensor, mmdispatch


def mmbatch(kernel, a_array, b_array, c_array=None):
    """Execute one dispatched kernel over stacked operands
    (libxsmm_mmbatch analog: same descriptor, many operand triplets)."""
    if c_array is not None:
        return kernel(a_array, b_array, c_array)
    return kernel(a_array, b_array)


def _stack(xs, dev: torch.device) -> torch.Tensor:
    if isinstance(xs, (list, tuple)):
        return torch.stack([as_tensor(x, dev) for x in xs])
    return as_tensor(xs, dev)


def gemm_batch(a_list, b_list, c_list=None, *, beta: float = 0.0):
    """libxsmm_gemm_batch analog: list/stack of same-shape GEMMs."""
    dev = platform.device()
    a, b = _stack(a_list, dev), _stack(b_list, dev)
    nb, m, k = a.shape
    n = b.shape[-1]
    kern = mmdispatch(m, n, k, in_dtype=dtype_name(a.dtype), batch=nb,
                      beta=beta)
    if beta:
        return kern(a, b, _stack(c_list, dev))
    return kern(a, b)


# ---------------------------------------------------------------------------
# Interception (the __wrap_dgemm / mmbatch_begin-end analog)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecordedCall:
    m: int
    n: int
    k: int
    batch: int
    dtype: str


_intercept_lock = threading.Lock()  # one interception scope per process
_intercept_local = threading.local()  # re-entry detection (same thread)


def _record_matmul_shapes(calls, ash, bsh, dtype):
    """Record an (m, n, k, batch) call if the shapes are matmul-like."""
    if len(ash) >= 2 and len(bsh) >= 2:
        m, k = ash[-2], ash[-1]
        n = bsh[-1]
        batch = math.prod(ash[:-2])
        calls.append(RecordedCall(m, n, k, batch, dtype))
        return m, n, k, batch
    return None


def _einsum_is_matmul(spec: str) -> bool:
    """'<batch>ij,<batch>jk[-><batch>ik]': the same batch prefix on both
    operands, one contracted index, and an explicit output (if any) that is
    the plain matmul output — transposed ('->ki') or batch-reduced outputs
    are not plain matmuls and would be recorded with wrong m/n/batch."""
    spec = spec.replace(" ", "")
    explicit = spec.split("->")[0]
    parts = explicit.split(",")
    if len(parts) != 2 or len(parts[0]) < 2 or len(parts[1]) < 2:
        return False
    lhs, rhs = parts
    if "->" in spec and spec.split("->")[1] != lhs[:-2] + lhs[-2] + rhs[-1]:
        return False
    return lhs[:-2] == rhs[:-2] and lhs[-1] == rhs[-2] and "." not in spec


@contextlib.contextmanager
def mmbatch_begin(record_only: bool = True):
    """Intercept torch.matmul / torch.einsum calls within the context.

    Yields the list of RecordedCall entries (filled as calls happen).
    ``record_only=False`` additionally reroutes 3-D batched small matmuls
    (m*n*k <= ``gemm_threshold``, one dtype, no keyword arguments) through
    the dispatch cache (the wrap behaviour), and returns the result as a
    tensor on the first operand's device; 2-D and large calls, einsum, and
    anything the shape probe cannot classify pass through to the original
    op.  einsum calls are recorded when the spec is a recognizable
    (batched) matmul contraction ('ij,jk', 'bij,bjk', ...); other specs
    pass through unrecorded.

    Scope rules: the patch is process-global, so interception scopes are
    serialized by a lock — one active scope at a time; a nested scope on
    the same thread raises ``RuntimeError``.  Shape-probe failures on
    exotic inputs raise; reroute errors propagate from the dispatched
    kernel itself.
    """
    calls: List[RecordedCall] = []
    threshold = get_config().gemm_threshold

    # a nested scope on the same thread would deadlock on the
    # non-reentrant lock below — fail loudly instead
    if getattr(_intercept_local, "active", False):
        raise RuntimeError(
            "mmbatch_begin scopes cannot nest (one interception scope "
            "at a time; the reference serializes the wrap batch array "
            "the same way, libxsmm_ext_gemm.c internal_mmbatch_flush)")
    with _intercept_lock:
        # flag set only once the lock is HELD: an exception while waiting
        # on the lock must not poison this thread's re-entry detection
        _intercept_local.active = True
        orig_matmul = torch.matmul
        orig_einsum = torch.einsum

        def wrapped_matmul(a, b, **kw):
            ash, bsh = tuple(np.shape(a)), tuple(np.shape(b))
            rec = _record_matmul_shapes(
                calls, ash, bsh, dtype_name(torch.result_type(a, b)))
            if (rec is not None and not record_only and len(ash) == 3
                    and len(bsh) == 3 and ash[0] == bsh[0] and not kw
                    and a.dtype == b.dtype):
                m, n, k, batch = rec
                if m * n * k <= threshold:
                    kern = mmdispatch(m, n, k, in_dtype=dtype_name(a.dtype),
                                      batch=batch, beta=0.0)
                    # f64 kernels return numpy; the caller asked torch
                    return as_tensor(kern(a, b), a.device)
            return orig_matmul(a, b, **kw)

        def wrapped_einsum(*args, **kw):
            if (len(args) == 3 and isinstance(args[0], str)
                    and _einsum_is_matmul(args[0])):
                _record_matmul_shapes(
                    calls, tuple(np.shape(args[1])), tuple(np.shape(args[2])),
                    dtype_name(torch.result_type(args[1], args[2])))
            return orig_einsum(*args, **kw)

        torch.matmul = wrapped_matmul
        torch.einsum = wrapped_einsum
        try:
            yield calls
        finally:
            torch.matmul = orig_matmul
            torch.einsum = orig_einsum
            _intercept_local.active = False


def mmbatch_end():  # parity shim: the context manager form is canonical
    raise RuntimeError("use `with mmbatch_begin() as calls:`")
