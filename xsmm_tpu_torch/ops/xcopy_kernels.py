"""The copy and transpose kernels: wrappers, plain versions, counts.

Each wrapper checks device and contiguity, then:

* on CUDA tensors it allocates the output with ``torch.empty``, launches
  its kernel (``ops/csrc/xcopy.cu``) on the current stream, raises if the
  launch returned a CUDA error, and adds one to ``launches[name]``;
* on CPU tensors it runs its plain PyTorch version (``*_plain``).

Any other device raises.  There is no fallback from a CUDA tensor.  Both
kernels move bits, so every dtype goes through them and the result equals
the plain version's exactly.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cuda_build

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {"xcopy_copy": 0, "xcopy_trans": 0}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("xcopy")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xsmm_copy.argtypes = [p, p, ll, i, p]
        lib.xsmm_trans.argtypes = [p, p, ll, ll, i, i, p]
        for fn in (lib.xsmm_copy, lib.xsmm_trans):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"xcopy kernels run on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("the operand must be contiguous")


# ---------------------------------------------------------------------------
# Kernel 9: _copy_kernel (xsmm_tpu/ops/xcopy.py:35)
# ---------------------------------------------------------------------------


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def copy(x: torch.Tensor) -> torch.Tensor:
    """A new contiguous tensor equal to ``x`` (any shape and dtype; the
    data may start at any byte)."""
    _check(x)
    if x.device.type == "cpu":
        return copy_plain(x)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    nbytes = x.numel() * x.element_size()
    if nbytes:
        cuda_build.launch(_lib().xsmm_copy, x.device, x.data_ptr(),
                          out.data_ptr(), nbytes)
        launches["xcopy_copy"] += 1
    return out


# ---------------------------------------------------------------------------
# Kernel 10: _trans_kernel (xsmm_tpu/ops/xcopy.py:105)
# ---------------------------------------------------------------------------


def trans_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2).contiguous()


def trans(x: torch.Tensor) -> torch.Tensor:
    """out[N, M] = x[M, N]^T as a new contiguous tensor; elements of 1, 2,
    4 or 8 bytes."""
    _check(x)
    if x.dim() != 2:
        raise ValueError(f"trans takes a 2-D tensor, got {tuple(x.shape)}")
    if x.element_size() not in (1, 2, 4, 8):
        raise ValueError(f"trans takes 1, 2, 4 or 8-byte elements, got "
                         f"{x.dtype}")
    if x.device.type == "cpu":
        return trans_plain(x)
    m, n = x.shape
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if out.numel():
        cuda_build.launch(_lib().xsmm_trans, x.device, x.data_ptr(),
                          out.data_ptr(), m, n, x.element_size())
        launches["xcopy_trans"] += 1
    return out
