"""The tiled-GEMM kernel: wrapper, plain version, count.

C[M, N] = A[M, K] @ B[K, N] on row-major contiguous operands: A and B in
f32, bf16 or f16 (one dtype), C in f32, bf16 or f16, an f32 sum in every
case.

The wrapper checks device, dtype, shape and contiguity, then:

* on CUDA tensors it allocates C with ``torch.empty`` (and, where the
  kernel splits K, its f32 workspace), launches the kernel of its route
  (``ops/csrc/tiled_gemm.cu``; with split-K, the kernel and the sum of its
  partials) on the current stream, raises if the launch returned a CUDA
  error, and adds one to ``launches["tiled_gemm"]`` and to
  ``route_launches`` of the route;
* on CPU tensors it runs the plain PyTorch version ``gemm_plain``: the
  Pallas kernel's own order, an f32 accumulator that gathers one
  ``A_panel @ B_panel`` product per K panel of ``bk``, cast at the end.

Any other device raises.  There is no fallback from a CUDA tensor.  The
kernel sums in its own order (FFMA for f32, tensor-core tiles for
bf16/f16), so kernel and plain version agree to f32 rounding, not bit for
bit.

Routes (``pick_route``): f32 operands take the SIMT kernel ("simt"); 16-bit
operands take the TMA + wgmma kernel ("tma") where TMA can address them
(base addresses on 16 bytes, rows of A and B a multiple of 16 bytes, K >
0), else the cp.async + mma.sync kernel ("mma").  A caller may name the
route; the kernel refuses "tma" for operands that fail the rule, which
raises ``ValueError`` with nothing launched.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import cuda_build
from .cuda_build import I, P
from .smm import _matmul

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {"tiled_gemm": 0}

# route name -> its code in ops/csrc/tiled_gemm.cu
ROUTES = {"simt": 0, "mma": 1, "tma": 2}
# route -> launches since the last reset_launches() (each also counts in
# launches["tiled_gemm"])
route_launches: Dict[str, int] = dict.fromkeys(ROUTES, 0)

TMA_REFUSED = ("the TMA route needs base addresses on 16 bytes and rows of "
               "A and B that are multiples of 16 bytes (K > 0); nothing was "
               "launched")

# dtype codes of core/descriptors.py
_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}


def reset_launches() -> None:
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


_lib = cuda_build.bind("tiled_gemm", {
    "xsmm_tiled_gemm": [P, P, P, P, I, I, I, I, I, I, I, I, P],
    "xsmm_tiled_gemm_splits": [I, I, I, I, I],
})


def _check(a, b, out_dtype: torch.dtype) -> None:
    for name, t in (("A", a), ("B", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"tiled GEMM runs on cuda or cpu, not {a.device}")
    if b.device != a.device:
        raise ValueError(f"B is on {b.device}, A is on {a.device}")
    if a.dtype not in _CODES or b.dtype != a.dtype or out_dtype not in _CODES:
        raise ValueError(f"tiled GEMM takes {list(_CODES)} in (A and B alike) "
                         f"and out, got {a.dtype}, {b.dtype} -> {out_dtype}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims disagree: A{tuple(a.shape)} "
                         f"B{tuple(b.shape)}")


# ---------------------------------------------------------------------------
# Kernel 4: _matmul_kernel (xsmm_tpu/ops/tiled_gemm.py:83)
# ---------------------------------------------------------------------------


def gemm_plain(a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype,
               bk: int) -> torch.Tensor:
    """acc = 0 in f32; acc += A[:, p] @ B[p, :] in f32 for each K panel p of
    ``bk``; the result cast to ``out_dtype``."""
    af, bf = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], bk):
        acc += _matmul(af[:, k0:k0 + bk], bf[k0:k0 + bk])
    return acc.to(out_dtype)


def pick_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route a CUDA call of ``gemm(a, b)`` takes: "simt" for f32;
    "tma" for 16-bit operands that TMA can address (A and B start on 16
    bytes, their rows K and N elements long are multiples of 16 bytes, K >
    0); else "mma"."""
    if a.dtype == torch.float32:
        return "simt"
    k, n = a.shape[1], b.shape[1]
    if (k == 0 or (a.data_ptr() | b.data_ptr()) % 16
            or k * a.element_size() % 16 or n * b.element_size() % 16):
        return "mma"
    return "tma"


def _launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, rt: str,
            device: torch.device) -> None:
    """C = A @ B on ``device`` through route ``rt``; raises ValueError where
    the kernel refuses the route."""
    m, k = a.shape
    n = b.shape[1]
    lib = _lib()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    code = ROUTES[rt]
    # split-K where the tiles of C would leave SMs idle: the kernel writes
    # f32 partials here and sums them into C
    splits = lib.xsmm_tiled_gemm_splits(m, n, k, code, index)
    work = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    cuda_build.launch(lib.xsmm_tiled_gemm, device, a.data_ptr(),
                      b.data_ptr(), c.data_ptr(),
                      None if work is None else work.data_ptr(), m, n, k,
                      splits, _CODES[a.dtype], _CODES[c.dtype], code,
                      refused=TMA_REFUSED)
    launches["tiled_gemm"] += 1
    route_launches[rt] += 1


def gemm(a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype,
         bk: int = 512, route: Optional[str] = None) -> torch.Tensor:
    """C = A @ B in ``out_dtype``; ``bk`` is the K panel of the plain
    version (the handle's tile plan), which the kernel does not need.
    ``route`` forces a route on the card (default: ``pick_route(a, b)``);
    the CPU ignores it."""
    _check(a, b, out_dtype)
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r}: expected one of {list(ROUTES)}")
    if a.device.type == "cpu":
        return gemm_plain(a, b, out_dtype=out_dtype, bk=bk)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                    device=a.device)
    if c.numel():
        _launch(a, b, c, route or pick_route(a, b), a.device)
    return c
