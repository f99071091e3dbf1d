"""Fixed-sparsity sparse-A x dense-B handle (fsspmdm).

The port of ``xsmm_tpu/ops/fsspmdm.py``.  Reference: src/libxsmm_fsspmdm.c —
create extracts CSR from dense A, tries the register-sparse JIT
(libxsmm_create_dcsr_reg, :119-125), falls back to a dense JIT kernel with N
chunked by 16 (:132-140); execute loops N chunks (:260-292).

Here the same create-time strategy choice through ``create_csr_soa``
(``ops/spgemm.py``).  The sparse kernel tiles N itself, so there is no
chunk loop; ``n_chunksize`` is kept for API parity and reports the JAX
package's lane tile (the same formula), else the full N.
"""

from __future__ import annotations

import numpy as np

from ..utils.mtx import Csr
from .spgemm import create_csr_soa


class Fsspmdm:
    """Handle: C[M,N] = A[M,K] @ B[K,N] with A fixed at creation."""

    def __init__(self, a_dense, n: int, dtype="float64",
                 strategy: str = "auto", tol: float = 0.0):
        a_dense = np.asarray(a_dense)
        self.m, self.k = a_dense.shape
        self.n = n
        csr = Csr.from_dense(a_dense, tol)
        self.nnz = csr.nnz
        self.kernel = create_csr_soa(csr, n, dtype=dtype, strategy=strategy)
        self.strategy = self.kernel.strategy
        # parity attribute (reference N_chunksize=16): the lane tile when
        # the kernel has one, else the full N
        self.n_chunksize = getattr(self.kernel, "bn", None) or n

    def execute(self, b):
        """libxsmm_dfsspmdm_execute analog."""
        return self.kernel(b)

    __call__ = execute


def dfsspmdm_create(m: int, n: int, k: int, a_dense,
                    strategy: str = "auto") -> Fsspmdm:
    """libxsmm_dfsspmdm_create analog (f64 values, two-float split)."""
    a_dense = np.asarray(a_dense, np.float64)
    if a_dense.shape != (m, k):
        raise ValueError(f"A shape {a_dense.shape} != ({m},{k})")
    return Fsspmdm(a_dense, n, dtype="float64", strategy=strategy)


def sfsspmdm_create(m: int, n: int, k: int, a_dense,
                    strategy: str = "auto") -> Fsspmdm:
    """libxsmm_sfsspmdm_create analog (f32)."""
    a_dense = np.asarray(a_dense, np.float32)
    if a_dense.shape != (m, k):
        raise ValueError(f"A shape {a_dense.shape} != ({m},{k})")
    return Fsspmdm(a_dense, n, dtype="float32", strategy=strategy)
