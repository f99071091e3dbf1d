"""Kernel descriptors — packed hashable keys for every kernel kind.

Reference: src/libxsmm_main.h:157-255 (POD descriptor structs used as
registry keys).  The port of ``xsmm_tpu/core/descriptors.py``: the same
frozen dataclasses and a ``pack()`` that returns the same bytes, so both
packages key a kernel alike.  Flags mirror include/libxsmm_typedefs.h:180-213;
the prefetch enum (libxsmm_typedefs.h:236-261) is kept for API parity and is
a no-op on the card.

Dtype names come from this module's own table (``dtype_name``), which maps
strings, numpy dtypes (including ml_dtypes' ``bfloat16``) and
``torch.dtype``s to the names the JAX package gets from ``jnp.dtype``.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np
import torch


class GemmFlags(enum.IntFlag):
    """Reference: include/libxsmm_typedefs.h:180-213."""

    NONE = 0
    TRANS_A = 1
    TRANS_B = 2
    ALPHA_0 = 4      # unsupported, kept for parity
    BETA_0 = 16
    ALIGN_A = 64     # no-op (alignment is the allocator's job)
    ALIGN_C = 128    # no-op
    BATCH_REDUCE = 256
    ALIGN_C_NTS_HINT = 640


class Prefetch(enum.IntEnum):
    """Reference: libxsmm_typedefs.h:236-261. No-op; kept for parity."""

    NONE = 0
    SIGONLY = 1
    BL2_VIA_C = 2
    AL2 = 4
    AL2_AHEAD = 8
    AL2BL2_VIA_C = 6
    AL2BL2_VIA_C_AHEAD = 10
    AL1 = 16
    BL1 = 32
    CL1 = 64
    AL1_BL1 = 48
    BL1_CL1 = 96
    AL1_CL1 = 80
    AL1_BL1_CL1 = 112
    AUTO = 128


_DTYPE_CODES = {
    "float64": 0,
    "float32": 1,
    "bfloat16": 2,
    "float16": 3,
    "int32": 4,
    "int16": 5,
    "int8": 6,
    "uint8": 7,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

# name -> torch.dtype for every name a descriptor can carry
TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
}

# itemsize of every name in _DTYPE_CODES (numpy has no bfloat16 without
# ml_dtypes, so the sizes are listed here)
ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
            "int32": 4, "int16": 2, "int8": 1, "uint8": 1}


def dtype_name(dtype) -> str:
    """The name ``jnp.dtype(dtype).name`` gives, for a string, a numpy
    dtype or scalar type, or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype == "bfloat16":
        # numpy knows the string only once ml_dtypes is imported
        return "bfloat16"
    return np.dtype(dtype).name


def dtype_code(dtype) -> int:
    name = dtype_name(dtype)
    try:
        return _DTYPE_CODES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype: {name}") from None


def code_dtype(code: int) -> torch.dtype:
    return TORCH_DTYPES[_CODE_DTYPES[code]]


def is_integer(dtype) -> bool:
    return dtype_name(dtype) in ("int32", "int16", "int8", "uint8")


@dataclasses.dataclass(frozen=True)
class GemmDescriptor:
    """C[m,n] = beta*C + alpha * op(A)[m,k] @ op(B)[k,n], batched.

    Reference: libxsmm_gemm_descriptor (src/libxsmm_main.h:157-169).
    alpha must be 1, beta in {0,1} (README.md:11).  ``batch`` > 1 selects
    the batched-SMM kernel form; ``batch_reduce`` selects C += sum_i A_i B_i
    (LIBXSMM_GEMM_FLAG_BATCH_REDUCE, typedefs.h:205).  Leading dimensions
    are accepted for API parity; operands are dense row-major tensors.
    """

    m: int
    n: int
    k: int
    in_dtype: str = "float32"
    out_dtype: str = "float32"
    flags: int = int(GemmFlags.NONE)
    batch: int = 1
    prefetch: int = int(Prefetch.NONE)
    lda: int = 0
    ldb: int = 0
    ldc: int = 0
    # Compute-variant code (f64 strategy: 0=split2, 1=split2_fast,
    # 2=float32, 3=native), part of the key so kernels built under
    # different strategies never alias in the registry.
    variant: int = 0

    def __post_init__(self):
        object.__setattr__(self, "in_dtype", dtype_name(self.in_dtype))
        object.__setattr__(self, "out_dtype", dtype_name(self.out_dtype))

    @property
    def beta(self) -> int:
        return 0 if self.flags & GemmFlags.BETA_0 else 1

    @property
    def trans_a(self) -> bool:
        return bool(self.flags & GemmFlags.TRANS_A)

    @property
    def trans_b(self) -> bool:
        return bool(self.flags & GemmFlags.TRANS_B)

    @property
    def batch_reduce(self) -> bool:
        return bool(self.flags & GemmFlags.BATCH_REDUCE)

    def pack(self) -> bytes:
        """Packed key, 35 bytes, full-width fields (no two distinct
        descriptors alias)."""
        return struct.pack(
            "<BIIIHBBIIIIBB",
            1,  # kind tag: gemm
            self.m, self.n, self.k,
            self.flags,
            dtype_code(self.in_dtype), dtype_code(self.out_dtype),
            self.batch, self.lda, self.ldb, self.ldc,
            self.prefetch & 0xFF, self.variant & 0xFF,
        )


@dataclasses.dataclass(frozen=True)
class MatcopyDescriptor:
    """Reference: libxsmm_mcopy_descriptor (src/libxsmm_main.h:171-183)."""

    m: int
    n: int
    dtype: str = "float32"
    zero_source: bool = False  # emit zeros instead of copying (flags bit)
    batch: int = 1

    def __post_init__(self):
        object.__setattr__(self, "dtype", dtype_name(self.dtype))

    def pack(self) -> bytes:
        return struct.pack(
            "<BIIBBI", 2, self.m, self.n, dtype_code(self.dtype),
            int(self.zero_source), self.batch)


@dataclasses.dataclass(frozen=True)
class TransDescriptor:
    """Out-of-place transpose (src/libxsmm_main.h:185-191)."""

    m: int
    n: int
    dtype: str = "float32"
    batch: int = 1

    def __post_init__(self):
        object.__setattr__(self, "dtype", dtype_name(self.dtype))

    def pack(self) -> bytes:
        return struct.pack(
            "<BIIBI", 3, self.m, self.n, dtype_code(self.dtype), self.batch)


@dataclasses.dataclass(frozen=True)
class PackedDescriptor:
    """Packed (batched, batch-innermost) LAPACK-ish kernels.

    Reference: pgemm/getrf/trmm/trsm descriptors (src/libxsmm_main.h:193-227).
    ``op`` in {"pgemm", "getrf", "trmm", "trsm"}; side/uplo/trans/diag follow
    BLAS chars for trmm/trsm.
    """

    op: str
    m: int
    n: int
    k: int = 0
    dtype: str = "float32"
    side: str = "L"
    uplo: str = "L"
    transa: str = "N"
    diag: str = "N"
    batch: int = 1

    def __post_init__(self):
        object.__setattr__(self, "dtype", dtype_name(self.dtype))

    _OPS = {"pgemm": 0, "getrf": 1, "trmm": 2, "trsm": 3}

    def pack(self) -> bytes:
        return struct.pack(
            "<BBIIIB4sI", 4, self._OPS[self.op], self.m, self.n, self.k,
            dtype_code(self.dtype),
            (self.side + self.uplo + self.transa + self.diag).encode(),
            self.batch)


@dataclasses.dataclass(frozen=True)
class SparseDescriptor:
    """Sparse kernels keyed by (shape, dtype, structure digest).

    Reference: CSR/CSC SOA wrappers (src/libxsmm_main.h:228-255).  The
    nonzero structure takes part in the key through an 8-byte digest.
    """

    kind: str          # "csr_asparse" | "csc_bsparse" | "csr_areg" | ...
    m: int
    n: int
    k: int
    dtype: str
    structure_digest: bytes  # 8-byte digest of (row_ptr, col_idx[, values])
    flags: int = 0

    def __post_init__(self):
        object.__setattr__(self, "dtype", dtype_name(self.dtype))

    _KINDS = {"csr_asparse": 0, "csc_bsparse": 1, "csr_areg": 2,
              "csr_bsparse": 3, "spmdm": 4}

    def pack(self) -> bytes:
        return struct.pack(
            "<BBIIIBH8s", 5, self._KINDS[self.kind], self.m, self.n, self.k,
            dtype_code(self.dtype), self.flags, self.structure_digest[:8])


def gemm_flags(transa: str = "N", transb: str = "N", beta: float = 1.0,
               batch_reduce: bool = False) -> int:
    """Analog of LIBXSMM_GEMM_FLAGS('N','T') (libxsmm_typedefs.h)."""
    f = GemmFlags.NONE
    if transa.upper() == "T":
        f |= GemmFlags.TRANS_A
    if transb.upper() == "T":
        f |= GemmFlags.TRANS_B
    if beta == 0:
        f |= GemmFlags.BETA_0
    elif beta != 1:
        raise ValueError("JIT GEMM requires beta in {0,1} (reference README.md:11)")
    if batch_reduce:
        f |= GemmFlags.BATCH_REDUCE
    return int(f)
