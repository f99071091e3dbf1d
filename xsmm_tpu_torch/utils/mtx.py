"""MatrixMarket (.mtx) I/O and minimal CSR/CSC containers.

Reference: the generator CLI and sparse samples read .mtx operator matrices
(generator_spgemm_csr_reader.c / csc_reader.c; samples/pyfr/mats/*.mtx).

The port's own copy of ``xsmm_tpu/utils/mtx.py`` (numpy only).  The
containers hold the same five numpy fields, so ``structure_digest`` gives
the same 8 bytes as the JAX package's and ``from_fields`` takes an operator
built by either package.  ``read_mtx`` parses coordinate files with the
native C++ reader (``native/mtx.cpp``, through ``core/native_bridge``)
unless ``XSMM_NATIVE=0``; the Python parser takes array files and
``XSMM_NATIVE=0``.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass
class Csr:
    """Compressed sparse row matrix (values f64; indices int32)."""

    m: int
    k: int
    row_ptr: np.ndarray   # [m+1] int32
    col_idx: np.ndarray   # [nnz] int32
    values: np.ndarray    # [nnz]

    @property
    def nnz(self) -> int:
        return int(self.col_idx.size)

    def toarray(self) -> np.ndarray:
        a = np.zeros((self.m, self.k), dtype=self.values.dtype)
        for i in range(self.m):
            s, e = self.row_ptr[i], self.row_ptr[i + 1]
            a[i, self.col_idx[s:e]] = self.values[s:e]
        return a

    def structure_digest(self) -> bytes:
        """8-byte digest of (shape, row_ptr, col_idx, values) — the registry
        key component of a sparse kernel (the values are part of the
        kernel, like the reference's reg-sparse codegen, so they key too)."""
        h = hashlib.blake2b(digest_size=8)
        h.update(np.int64([self.m, self.k, self.nnz]).tobytes())
        h.update(self.row_ptr.tobytes())
        h.update(self.col_idx.tobytes())
        h.update(np.ascontiguousarray(self.values).tobytes())
        return h.digest()

    @staticmethod
    def from_dense(a: np.ndarray, tol: float = 0.0) -> "Csr":
        a = np.asarray(a)
        m, k = a.shape
        mask = np.abs(a) > tol
        row_ptr = np.zeros(m + 1, np.int32)
        cols, vals = [], []
        for i in range(m):
            idx = np.nonzero(mask[i])[0]
            cols.append(idx.astype(np.int32))
            vals.append(a[i, idx])
            row_ptr[i + 1] = row_ptr[i] + idx.size
        return Csr(m, k, row_ptr,
                   np.concatenate(cols) if cols else np.zeros(0, np.int32),
                   np.concatenate(vals) if vals else np.zeros(0, a.dtype))

    @staticmethod
    def from_fields(other) -> "Csr":
        """A copy of any CSR object with fields (m, k, row_ptr, col_idx,
        values), e.g. the JAX package's ``Csr``."""
        return Csr(int(other.m), int(other.k), np.array(other.row_ptr),
                   np.array(other.col_idx), np.array(other.values))


@dataclasses.dataclass
class Csc:
    """Compressed sparse column matrix."""

    m: int
    k: int
    col_ptr: np.ndarray
    row_idx: np.ndarray
    values: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.row_idx.size)

    def toarray(self) -> np.ndarray:
        a = np.zeros((self.m, self.k), dtype=self.values.dtype)
        for j in range(self.k):
            s, e = self.col_ptr[j], self.col_ptr[j + 1]
            a[self.row_idx[s:e], j] = self.values[s:e]
        return a

    @staticmethod
    def from_dense(a: np.ndarray, tol: float = 0.0) -> "Csc":
        t = Csr.from_dense(np.asarray(a).T, tol)
        return Csc(t.k, t.m, t.row_ptr, t.col_idx, t.values)

    @staticmethod
    def from_fields(other) -> "Csc":
        """A copy of any CSC object with fields (m, k, col_ptr, row_idx,
        values), e.g. the JAX package's ``Csc``."""
        return Csc(int(other.m), int(other.k), np.array(other.col_ptr),
                   np.array(other.row_idx), np.array(other.values))


def read_mtx(path: str) -> np.ndarray:
    """Read a MatrixMarket file to a dense numpy array.

    Supports coordinate and array formats, real/integer/pattern fields,
    general/symmetric.  Coordinate files go through the native reader
    (xsmm_tpu/utils/mtx.py:101-106); a failed native build raises.
    """
    from ..core import native_bridge

    a = native_bridge.read_mtx_native(path)
    if a is not None:
        return a
    return _read_mtx_py(path)


def _read_mtx_py(path: str) -> np.ndarray:
    """The Python parser."""
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.split()
        fmt = parts[2]          # coordinate | array
        symmetry = parts[4] if len(parts) > 4 else "general"
        if symmetry not in ("general", "symmetric"):
            # skew-symmetric / hermitian would be silently mis-read as
            # general (mirror entries dropped); fail loudly instead
            raise ValueError(
                f"{path}: unsupported MatrixMarket symmetry '{symmetry}'")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        if fmt == "coordinate":
            m, n, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            a = np.zeros((m, n))
            for _ in range(nnz):
                row = f.readline().split()
                i, j = int(row[0]) - 1, int(row[1]) - 1
                v = float(row[2]) if len(row) > 2 else 1.0
                a[i, j] = v
                if symmetry == "symmetric" and i != j:
                    a[j, i] = v
        else:
            m, n = int(dims[0]), int(dims[1])
            vals = []
            for line in f:
                line = line.strip()
                if line and not line.startswith("%"):
                    vals.append(float(line))
            a = np.asarray(vals).reshape((n, m)).T  # column-major per spec
        return a


def write_mtx(path: str, a: np.ndarray) -> None:
    """Write a dense array as a coordinate-format MatrixMarket file."""
    a = np.asarray(a)
    rows, cols = np.nonzero(a)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {rows.size}\n")
        for i, j in zip(rows, cols):
            f.write(f"{i + 1} {j + 1} {a[i, j]:.17g}\n")
