"""ctypes bridge to the native C++ runtime (``native/*.cpp``).

The port of ``xsmm_tpu/core/native_bridge.py``.  The native library gives
the CRC32C open-addressing registry (the internal_find_code table analog,
``native/registry.cpp``), the fast .mtx parser (``native/mtx.cpp``), the
single-pass ELL pack (``native/spmdm.cpp``) and the worker-pool dataset
loader (``native/dataloader.cpp``, used by ``utils/dataset.DataLoader``).  The port builds them itself
at first use with ``g++`` and the flags of ``native/Makefile`` into
``xsmm_tpu_torch/build/native/``, under a name that carries a hash of the
sources and flags (as ``ops/cuda_build.py`` keys its builds); it writes
nothing into ``native/``.

No quiet fallback: with ``XSMM_NATIVE=1`` (the default) a failed build or
load raises ``RuntimeError`` with the compiler's output; ``XSMM_NATIVE=0``
selects the Python paths (the registry's dict, the Python .mtx parser and
ELL pack).  ``crc32`` always returns CRC32C, from a table-driven Python
CRC32C where the library is off (the JAX fallback returns zlib's CRC32: a
stated difference).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .config import get_config

_REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO / "native"
SOURCES = ("registry.cpp", "mtx.cpp", "dataloader.cpp", "spmdm.cpp")
# native/Makefile's CXXFLAGS and link line
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LDFLAGS = ("-lpthread",)
BUILD_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """Where the library is built: ``native/`` under the CUDA builds'
    directory (``ops/cuda_build.BUILD_DIR``, which ``enable_compile_cache``
    moves), keyed by the compiler, the flags and the sources."""
    from ..ops import cuda_build

    h = hashlib.sha256(" ".join((_cxx(), *CXXFLAGS, *LDFLAGS)).encode())
    for src in SOURCES:
        h.update((NATIVE_DIR / src).read_bytes())
    return (Path(cuda_build.BUILD_DIR) / "native"
            / f"libxsmm_tpu_native_{h.hexdigest()[:16]}.so")


def build() -> Path:
    """Build the library if it is not built yet; returns its path.  Raises
    ``RuntimeError`` with the compiler's output on failure."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXXFLAGS, "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in SOURCES), *LDFLAGS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"xsmm_tpu_torch: native build failed: "
                           f"{' '.join(cmd)}\n{e}") from e
    if res.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"xsmm_tpu_torch: native build failed (exit "
                           f"{res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)   # atomic: concurrent builds agree
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.xsmm_reg_create.restype = p
    lib.xsmm_reg_create.argtypes = [ctypes.c_uint32]
    lib.xsmm_reg_destroy.restype = None
    lib.xsmm_reg_destroy.argtypes = [p]
    lib.xsmm_reg_find.restype = i32
    lib.xsmm_reg_find.argtypes = [p, ctypes.c_char_p, i32]
    lib.xsmm_reg_insert.restype = i32
    lib.xsmm_reg_insert.argtypes = [p, ctypes.c_char_p, i32, i32]
    lib.xsmm_reg_size.restype = i64
    lib.xsmm_reg_size.argtypes = [p]
    lib.xsmm_reg_clear.restype = None
    lib.xsmm_reg_clear.argtypes = [p]
    lib.xsmm_crc32.restype = ctypes.c_uint32
    lib.xsmm_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                               ctypes.c_uint32]
    lib.xsmm_mtx_parse.restype = p
    lib.xsmm_mtx_parse.argtypes = [ctypes.c_char_p]
    for fn in ("xsmm_mtx_rows", "xsmm_mtx_cols", "xsmm_mtx_nnz"):
        getattr(lib, fn).restype = i64
        getattr(lib, fn).argtypes = [p]
    lib.xsmm_mtx_symmetric.restype = ctypes.c_int
    lib.xsmm_mtx_symmetric.argtypes = [p]
    lib.xsmm_mtx_copy.restype = None
    lib.xsmm_mtx_copy.argtypes = [p, p, p, p]
    lib.xsmm_mtx_free.restype = None
    lib.xsmm_mtx_free.argtypes = [p]
    lib.xsmm_ell_rowmax.restype = i64
    lib.xsmm_ell_rowmax.argtypes = [p, i64, i64, ctypes.c_float]
    lib.xsmm_ell_pack.restype = i64
    lib.xsmm_ell_pack.argtypes = [p, i64, i64, ctypes.c_float, i64, p, p]
    lib.xsmm_dl_open.restype = p
    lib.xsmm_dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_uint64]
    for fn in ("xsmm_dl_count", "xsmm_dl_batches_per_epoch"):
        getattr(lib, fn).restype = i64
        getattr(lib, fn).argtypes = [p]
    for fn in ("xsmm_dl_height", "xsmm_dl_width", "xsmm_dl_channels",
               "xsmm_dl_nclasses"):
        getattr(lib, fn).restype = i32
        getattr(lib, fn).argtypes = [p]
    lib.xsmm_dl_next.restype = i64
    lib.xsmm_dl_next.argtypes = [p, p, p]
    lib.xsmm_dl_close.restype = None
    lib.xsmm_dl_close.argtypes = [p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None under ``XSMM_NATIVE=0``.
    Raises ``RuntimeError`` when the build or the load fails."""
    global _lib
    if not get_config().use_native:
        return None
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"xsmm_tpu_torch: cannot load the native "
                                   f"library {path}: {e}") from e
            _lib = _bind(lib)
    return _lib


def ell_pack_native(a: np.ndarray, tol: float, round_to: int = 8,
                    r: Optional[int] = None):
    """Single-pass C++ ELL pack: (vals, cols, nnz, r), or None under
    ``XSMM_NATIVE=0``.

    a must be float32 row-major [m, k]; r is the max row population rounded
    up to ``round_to`` -- pass a precomputed r (MUST be >= the true rowmax
    for the same tol, or rows are truncated) to skip the rowmax pass.
    """
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.float32)
    m, k = a.shape
    if r is not None and r < 1:
        raise ValueError(f"ell_pack_native: r must be >= 1, got {r}")
    if r is None:
        rmax = lib.xsmm_ell_rowmax(a.ctypes.data_as(ctypes.c_void_p),
                                   m, k, tol)
        r = max(1, -(-max(int(rmax), 1) // round_to) * round_to)
    vals = np.empty((m, r), np.float32)
    cols = np.empty((m, r), np.int32)
    nnz = lib.xsmm_ell_pack(a.ctypes.data_as(ctypes.c_void_p), m, k, tol, r,
                            vals.ctypes.data_as(ctypes.c_void_p),
                            cols.ctypes.data_as(ctypes.c_void_p))
    return vals, cols, int(nnz), r


class NativeRegistry:
    """The interface core/registry.py expects from the native index."""

    def __init__(self, capacity: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("the native library is off (XSMM_NATIVE=0)")
        self._lib = lib
        self._h = lib.xsmm_reg_create(capacity)
        if not self._h:
            raise MemoryError("xsmm_reg_create failed")

    def find(self, key: bytes) -> int:
        return self._lib.xsmm_reg_find(self._h, key, len(key))

    def insert(self, key: bytes, value: int) -> int:
        slot = self._lib.xsmm_reg_insert(self._h, key, len(key), value)
        if slot == -2:
            raise RuntimeError("native registry full")
        return slot

    def clear(self):
        self._lib.xsmm_reg_clear(self._h)

    def __len__(self):
        return int(self._lib.xsmm_reg_size(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._h = None
            self._lib.xsmm_reg_destroy(h)


def load(capacity: int = 131072) -> NativeRegistry:
    """Entry point used by core.registry."""
    return NativeRegistry(capacity)


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c_py(data: bytes, seed: int = 0) -> int:
    """Table-driven CRC32C (Castagnoli), the same function as
    ``native/registry.cpp``'s ``crc32c``."""
    c = ~seed & 0xFFFFFFFF
    t = _CRC32C_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return ~c & 0xFFFFFFFF


def crc32(data: bytes, seed: int = 0) -> int:
    """CRC32C of ``data``: the library's, or the Python table's under
    ``XSMM_NATIVE=0``."""
    lib = get_lib()
    if lib is None:
        return crc32c_py(data, seed)
    return lib.xsmm_crc32(data, len(data), seed)


def read_mtx_native(path: str):
    """Parse a coordinate .mtx natively -> dense numpy array; None under
    ``XSMM_NATIVE=0`` or where the parser refuses the file (e.g. an array
    format), as in the JAX bridge."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.xsmm_mtx_parse(os.fsencode(path))
    if not h:
        return None
    try:
        m = lib.xsmm_mtx_rows(h)
        n = lib.xsmm_mtx_cols(h)
        nnz = lib.xsmm_mtx_nnz(h)
        ri = np.empty(nnz, np.int32)
        ci = np.empty(nnz, np.int32)
        v = np.empty(nnz, np.float64)
        lib.xsmm_mtx_copy(h, ri.ctypes.data_as(ctypes.c_void_p),
                          ci.ctypes.data_as(ctypes.c_void_p),
                          v.ctypes.data_as(ctypes.c_void_p))
        sym = bool(lib.xsmm_mtx_symmetric(h))
    finally:
        lib.xsmm_mtx_free(h)
    a = np.zeros((m, n))
    a[ri, ci] = v
    if sym:
        off = ri != ci
        a[ci[off], ri[off]] = v[off]
    return a
