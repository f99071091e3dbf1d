"""Build the package's CUDA sources and load them with ctypes.

Each library in ``SOURCES`` is compiled by ``nvcc`` for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into ``xsmm_tpu_torch/build/`` (or the directory that
``xsmm_tpu_torch.enable_compile_cache`` names).  The file name
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  ``build_all()`` starts one ``nvcc`` for
every library at once and waits for all of them.

Each wrapper module binds its library's entry points with ``bind`` (the
argument types of each ``extern "C"`` prototype, every one returning int;
tests/test_torch_core.py holds the tables against the sources) and launches
them with ``launch``.

Nothing here runs at import time.  A missing ``nvcc`` or a failed build
raises ``RuntimeError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence

from ..utils import trace

_PKG = Path(__file__).resolve().parent
DEFAULT_BUILD_DIR = _PKG.parent / "build"
# where the libraries are built; ``enable_compile_cache`` may move it
BUILD_DIR = DEFAULT_BUILD_DIR

# library name -> CUDA sources, relative to this directory
SOURCES: Dict[str, tuple] = {
    "smm_packed": ("csrc/smm_packed.cu",),
    "spgemm": ("csrc/spgemm.cu",),
    "xcopy": ("csrc/xcopy.cu",),
    "tiled_gemm": ("csrc/tiled_gemm.cu",),
    "packed": ("csrc/packed.cu",),
    "rnn_seq": ("csrc/rnn_seq.cu",),
    "pooling": ("csrc/pooling.cu",),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_TIMEOUT_S = 600

# compiler output of each library built by this process (ptxas prints each
# kernel's registers, shared memory and spills)
build_logs: Dict[str, str] = {}

# libraries compiled and loaded by this process (utils/trace.build_counts)
builds: Dict[str, int] = {"compiled": 0, "loaded": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# the argument types of the entry points (bind): a pointer (a tensor's
# address, a stream, or None), an int, a long long
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("xsmm_tpu_torch: nvcc not found (looked in $CUDA_HOME, "
                       "PATH and /usr/local/cuda/bin); the CUDA kernels "
                       "cannot be built")


def library_path(name: str) -> Path:
    """Where library ``name`` is built, keyed on its sources, the shared
    headers of ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES[name], *sorted(
            str(p.relative_to(_PKG)) for p in (_PKG / "csrc").glob("*.cuh"))):
        h.update((_PKG / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every library in ``names`` (default: all) that is not built
    yet, one nvcc each, all started together.  Returns name -> path."""
    names = list(SOURCES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(_PKG / s) for s in SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, cmd)
    failed = []
    for n, (proc, tmp, cmd) in procs.items():
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\n(killed after {BUILD_TIMEOUT_S} s)"
        build_logs[n] = out
        if proc.returncode != 0 or not tmp.exists():
            failed.append(f"{' '.join(cmd)}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])  # atomic: concurrent builders agree
            builds["compiled"] += 1
    if failed:
        raise RuntimeError("xsmm_tpu_torch: CUDA build failed:\n"
                           + "\n".join(failed))
    return paths


def launch(fn, device, *args, refused: Optional[str] = None) -> None:
    """Call C entry point ``fn(*args, device index, stream)`` on the current
    stream of ``device`` (a ``torch.device``); raise if it returns non-zero
    (-1: a dtype code it does not take; -2, raised as ``ValueError``: sizes
    that need more shared memory than a block has, or more blocks than the
    card holds at once for a cooperative kernel, refused before any launch
    -- or what ``refused`` says, where the entry point refuses for another
    reason; else the ``cudaError`` of the launch)."""
    import torch

    with trace.span("launch"):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, device.index if device.index is not None
                else torch.cuda.current_device(), stream)
    if rc == -2:
        raise ValueError(f"{fn.__name__}: " + (refused or (
            "these sizes need more shared memory than a block has (or, for "
            "a cooperative kernel, more blocks than the card holds at "
            "once); nothing was launched")))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed (code "
                           f"{rc}: -1 = dtype not taken, else cudaError)")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name``; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _LIBS[name] = lib
            builds["loaded"] += 1
        return lib


def bind(name: str, entries: Dict[str, Sequence]) -> Callable[[], ctypes.CDLL]:
    """A function that returns library ``name`` (``load``) with each entry
    point of ``entries`` (entry point -> its ctypes argument types) typed,
    returning ``c_int``.  A library is typed once; one put in its place in
    ``_LIBS`` (a profiler's variant build) is typed at its first use.  The
    table is kept as the function's ``entries``."""
    typed = None

    def lib() -> ctypes.CDLL:
        nonlocal typed
        cdll = _LIBS.get(name)
        if cdll is None:
            cdll = load(name)
        if cdll is not typed:
            for entry, argtypes in entries.items():
                fn = getattr(cdll, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            typed = cdll
        return cdll

    lib.entries = entries
    return lib


def ptr(t) -> Optional[int]:
    """The address of tensor ``t`` for an entry point, or None (a null
    pointer) for None."""
    return None if t is None else t.data_ptr()
