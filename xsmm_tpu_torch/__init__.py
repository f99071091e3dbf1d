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
from .utils import timer

__version__ = "0.1.0"


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
