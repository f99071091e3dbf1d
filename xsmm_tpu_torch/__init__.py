"""xsmm_tpu_torch — the xsmm_tpu kernel framework in PyTorch and CUDA.

The port of the JAX package ``xsmm_tpu`` to an NVIDIA H100: the same
descriptor-keyed registry and typed dispatch, with every kernel on the
ported path written by hand in CUDA C++ for sm_90a (``ops/csrc/``), built at
first use and bound through ctypes.  Module names follow the JAX package.

Entry points run on the card; ``XSMM_TARGET=cpu`` (or
``set_config(target="cpu")``) runs them on the CPU through each kernel's
plain PyTorch version.  Without a card and without that setting, building
or calling a kernel raises.  Nothing here imports JAX or ``xsmm_tpu``.
"""

import os

from .core.config import Config, get_config, set_config, set_verbosity
from .core.descriptors import (
    GemmDescriptor, GemmFlags, MatcopyDescriptor, PackedDescriptor, Prefetch,
    SparseDescriptor, TransDescriptor, gemm_flags,
)
from .core.registry import finalize, get_registry
from .core import platform
from .ops.smm import (
    BatchedSMM, BatchReduceGemm, XlaGemm,
    bmmdispatch, bmmdispatch_reducebatch, bsmmdispatch,
    bsmmdispatch_reducebatch, dmmdispatch, dmmdispatch_reducebatch,
    join_f64, mmdispatch, packed_from_numpy, smmdispatch,
    smmdispatch_reducebatch, split_f64, wimmdispatch, wsmmdispatch,
)
from .ops.xcopy import itrans, matcopy, matcopy_dispatch, otrans, trans_dispatch
from .ops.tiled_gemm import TiledGemm, gemm_handle, xgemm
from .ops.spgemm import (CsrSpgemm, create_csc_soa, create_csr_soa,
                         create_dcsr_reg)
from .ops.fsspmdm import Fsspmdm, dfsspmdm_create, sfsspmdm_create
from .ops.spmdm import SpmdmHandle, spmdm_init
from .ops.blocked_gemm import BlockedGemmHandle, blocked_gemm_handle
from .ops.mmbatch import gemm_batch, mmbatch, mmbatch_begin
from .ops.packed import (GetrfKernel, TrmmKernel, TrsmKernel, getrf_dispatch,
                         pgemm_dispatch, trmm_dispatch, trsm_dispatch)
from .utils.matdiff import MatdiffInfo, check, matdiff
from .utils.mtx import Csc, Csr, read_mtx, write_mtx
from .utils.dataset import DataLoader, write_dataset
from .utils import mathx, mhd, rng, scratch, timer, trace

__version__ = "0.1.0"


def enable_compile_cache(path: str = "") -> str:
    """Point the kernel builds at ``path`` (else ``XSMM_CACHE_DIR``, else
    the default ``xsmm_tpu_torch/build/``), so later processes load the
    built libraries instead of compiling again.

    The analog of the JAX package's persistent compilation cache
    (xsmm_tpu/__init__.py:50-67): the CUDA libraries (``ops/cuda_build``) and
    the native runtime (``core/native_bridge``) are built there, each under
    a name keyed by its sources and flags.  Returns the directory."""
    from pathlib import Path

    from .ops import cuda_build

    path = path or os.environ.get("XSMM_CACHE_DIR", "")
    cuda_build.BUILD_DIR = (Path(path).expanduser().resolve() if path
                            else cuda_build.DEFAULT_BUILD_DIR)
    return str(cuda_build.BUILD_DIR)


def init():
    """Analog of libxsmm_init (libxsmm_main.c:708): eager bring-up.

    Reads the config, creates the registry (building the native index
    unless ``XSMM_NATIVE=0``), points the builds at ``XSMM_CACHE_DIR`` where
    it is set, builds the CUDA sources when the target is the card, and dispatches
    every shape of ``XSMM_AOT_SHAPES`` ("MxNxK[:dtype][:batch],..."),
    counting each in the registry's STA statistic -- the analog of the
    reference's build-time MNK= specialization (Makefile:674-700).
    """
    cfg = get_config()
    reg = get_registry()
    if os.environ.get("XSMM_CACHE_DIR"):
        enable_compile_cache()
    if platform.backend() == "cuda":
        platform.device()   # raises without a card
        from .ops import cuda_build
        cuda_build.build_all()
    if cfg.aot_shapes:
        for spec in cfg.aot_shapes.split(","):
            spec = spec.strip()
            if not spec:
                continue
            parts = spec.split(":")
            m, n, k = (int(x) for x in parts[0].lower().split("x"))
            dtype = parts[1] if len(parts) > 1 else "float32"
            batch = int(parts[2]) if len(parts) > 2 else 1
            mmdispatch(m, n, k, in_dtype=dtype, batch=batch, beta=0.0)
            reg.stats.nsta += 1
    return reg


def get_registry_info():
    """Analog of libxsmm_get_registry_info (libxsmm_main.c:2092)."""
    return get_registry().info()


def get_kernel_info(descriptor):
    """Analog of libxsmm_get_mmkernel_info (libxsmm_main.c:1969): the
    per-kernel record (name, shape, dtype, working-set estimate, hit count)
    for a registered descriptor, or None."""
    return get_registry().kernel_info(descriptor)


def registry_kernels():
    """Every registered kernel, hottest first (libxsmm_main.c:2092)."""
    return get_registry().kernels()
