"""Offline kernel generator CLI — the libxsmm_gemm_generator analog.

Reference: src/libxsmm_generator_gemm_driver.c — a standalone binary that
emits dense/sparse kernels for *static* builds, with three code types
(generator_gemm.c:294-386): binary JIT, assembly text, C inline-asm.  The
port of ``xsmm_tpu/tools/generator.py``:

* ``compiled`` dispatches the descriptor (recorded as static in the
  registry's STA count) and, when the target is the card, builds the CUDA
  source that holds its kernel into the build directory
  (``xsmm_tpu_torch.enable_compile_cache``), so later processes load it;
* ``ptx`` and ``sass`` write the kernel source's PTX (``nvcc -ptx``) and its
  machine code (``cuobjdump -sass`` of the built library): the two text
  forms, as StableHLO and HLO are in the JAX package.  Without ``nvcc`` or
  ``cuobjdump`` they raise, naming the tool.

A descriptor that no kernel of this package computes (a large GEMM on
``torch.matmul``, the dense sparse strategy) has no text form and raises in
the text modes.

Usage:
  python -m xsmm_tpu_torch.tools.generator gemm M N K [--dtype float32]
      [--batch B] [--batch-reduce] [--code-type compiled|ptx|sass]
      [--out FILE]
  python -m xsmm_tpu_torch.tools.generator spgemm MTX_FILE N
      [--dtype float64] [--code-type ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Optional

CODE_TYPES = ("compiled", "ptx", "sass")


def _library_of(kernel) -> Optional[str]:
    """The CUDA library (``ops/cuda_build.SOURCES``) holding the kernel a
    dispatched object launches, or None for the torch-op routes."""
    from ..ops.smm import BatchedSMM
    from ..ops.spgemm import CsrSpgemm

    if isinstance(kernel, BatchedSMM):
        return "smm_packed"
    if isinstance(kernel, CsrSpgemm) and kernel.strategy == "unroll":
        return "spgemm"
    return None


def _cuobjdump() -> str:
    from ..ops import cuda_build

    tool = shutil.which("cuobjdump")
    if tool:
        return tool
    try:
        cand = os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                            "cuobjdump")
    except RuntimeError:
        cand = ""
    if cand and os.path.isfile(cand):
        return cand
    raise RuntimeError("xsmm_tpu_torch: cuobjdump not found (looked in PATH "
                       "and beside nvcc); --code-type sass needs it")


def _text(lib: Optional[str], what: str, code_type: str) -> str:
    from ..ops import cuda_build

    if lib is None:
        raise ValueError(f"{what}: no kernel of this package computes it "
                         f"(a torch-op route), so it has no {code_type} text")
    if code_type == "sass":
        _cuobjdump()    # named before anything is built
    if code_type == "ptx":
        nvcc = cuda_build.find_nvcc()
        srcs = [str(cuda_build._PKG / s) for s in cuda_build.SOURCES[lib]]
        flags = [f for f in cuda_build.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                              "-v")]
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, f"{lib}.ptx")
            res = subprocess.run([nvcc, *flags, "-ptx", "-o", out, *srcs],
                                 capture_output=True, text=True,
                                 timeout=cuda_build.BUILD_TIMEOUT_S)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc -ptx failed:\n{res.stderr}")
            with open(out) as f:
                return f.read()
    tool = _cuobjdump()
    so = cuda_build.build_all([lib])[lib]
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass failed:\n{res.stderr}")
    return res.stdout


def _compiled(lib: Optional[str], what: str) -> str:
    from ..core import platform
    from ..ops import cuda_build

    if lib is None:
        where = "torch-op route, nothing to build"
    elif platform.backend() == "cuda":
        where = f"built {cuda_build.build_all([lib])[lib]}"
    else:
        where = "CPU target: the plain versions, nothing built"
    return f"compiled {what} ({where})\n"


def _check(code_type: str) -> None:
    if code_type not in CODE_TYPES:
        raise ValueError(f"unknown code type {code_type!r}; one of "
                         f"{list(CODE_TYPES)}")


def generate_gemm(m: int, n: int, k: int, dtype: str = "float32",
                  batch: int = 1, batch_reduce: bool = False,
                  code_type: str = "compiled") -> str:
    """Dispatch one GEMM descriptor as static; returns a status line, or
    the PTX / SASS text of its kernel."""
    from .. import enable_compile_cache, mmdispatch
    from ..core.registry import get_registry

    _check(code_type)
    if os.environ.get("XSMM_CACHE_DIR"):
        enable_compile_cache()
    kern = mmdispatch(m, n, k, in_dtype=dtype, batch=batch,
                      batch_reduce=batch_reduce, beta=0.0)
    get_registry().stats.nsta += 1
    what = (f"gemm_{dtype}_{m}x{n}x{k}_b{batch}"
            f"{'_br' if batch_reduce else ''}")
    lib = _library_of(kern)
    if code_type == "compiled":
        return _compiled(lib, what)
    return _text(lib, what, code_type)


def generate_spgemm(mtx_path: str, n: int, dtype: str = "float64",
                    code_type: str = "compiled") -> str:
    """Create one sparse-A kernel from a MatrixMarket file; returns a status
    line, or the PTX / SASS text of its kernel."""
    import numpy as np

    from .. import create_csr_soa, enable_compile_cache, read_mtx
    from ..core.registry import get_registry

    _check(code_type)
    if os.environ.get("XSMM_CACHE_DIR"):
        enable_compile_cache()
    a = read_mtx(mtx_path)
    kern = create_csr_soa(a, n, dtype=dtype)
    get_registry().stats.nsta += 1
    what = (f"spgemm[{mtx_path}] {a.shape[0]}x{n}x{a.shape[1]} "
            f"nnz={int(np.count_nonzero(a))} strategy={kern.strategy}")
    lib = _library_of(kern)
    if code_type == "compiled":
        return _compiled(lib, what)
    return _text(lib, what, code_type)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="xsmm_tpu_torch.tools.generator",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gemm")
    g.add_argument("m", type=int)
    g.add_argument("n", type=int)
    g.add_argument("k", type=int)
    g.add_argument("--dtype", default="float32")
    g.add_argument("--batch", type=int, default=1)
    g.add_argument("--batch-reduce", action="store_true")
    g.add_argument("--code-type", default="compiled", choices=CODE_TYPES)
    g.add_argument("--out", default="")

    s = sub.add_parser("spgemm")
    s.add_argument("mtx")
    s.add_argument("n", type=int)
    s.add_argument("--dtype", default="float64")
    s.add_argument("--code-type", default="compiled", choices=CODE_TYPES)
    s.add_argument("--out", default="")

    args = p.parse_args(argv)
    if args.cmd == "gemm":
        text = generate_gemm(args.m, args.n, args.k, args.dtype, args.batch,
                             args.batch_reduce, args.code_type)
    else:
        text = generate_spgemm(args.mtx, args.n, args.dtype, args.code_type)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {len(text)} bytes to {args.out}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
