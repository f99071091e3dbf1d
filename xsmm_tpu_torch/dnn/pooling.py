"""Pooling layer (max / avg), forward and backward: the port of
``xsmm_tpu/dnn/pooling.py``, with its max-pool window backward kernel.

Reference: src/libxsmm_dnn_pooling*.c — max pooling tracks an argmax mask
in the forward pass for the backward scatter; avg pooling scatters
uniformly.

NHWC activations, as in the JAX package.  The forward is
``F.max_pool2d``/``F.avg_pool2d`` on the NHWC tensor seen as a
channels-last NCHW one (the analog of ``lax.reduce_window``), in f32, cast
to the descriptor's dtype after.  Padding is explicit (``F.pad``, since the
pool's own ``padding=`` refuses pad > r/2 and the JAX layer does not): max
pads with -inf, the ``reduce_window`` init value; avg pads with zeros and
divides by r*s, so the padding counts (``pooling.py:103-110``).

The backward, ``backward(dy, x)``, takes one of two routes, fixed when the
layer is made and named by ``bwd_kind``:

* ``"vjp"`` (the default): autograd through the same forward, the
  counterpart of the JAX VJP.  Max routes dy to the first maximal element
  of a window in row-major order, as JAX's select-and-scatter does.
* ``"pallas_window"``: ``XSMM_POOL_WINDOW_KERNEL=1``, MAX, 2x2/s2, no
  padding, H and W even, C % 128 == 0 (``pooling.py:115-121``).  The name
  is the reference's; here it means the CUDA kernel
  ``ops/csrc/pooling.cu`` behind ``maxpool2x2_bwd``, which computes the
  Pallas kernel's function in f32.  A CUDA tensor launches it or raises; a
  CPU tensor takes its plain version, ``maxpool2x2_bwd_plain``.

NaN inputs: the window kernel and its plain version give a window that
holds a NaN 0 everywhere (its max is NaN and no element is >= NaN), as the
Pallas kernel does; the ``vjp`` route routes dy to the NaN, as torch's
max-pool backward does.  The two routes agree on finite inputs only.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.descriptors import TORCH_DTYPES
from ..ops import cuda_build
from .operands import device_of, on
from .types import Kind, PoolingDesc, PoolType

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {"maxpool2x2_bwd": 0}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("pooling")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xsmm_maxpool2x2_bwd.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.xsmm_maxpool2x2_bwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Kernel 21: _maxpool2x2_bwd_pallas (xsmm_tpu/dnn/pooling.py:33)
# ---------------------------------------------------------------------------


def _window_shapes(dy: torch.Tensor, x: torch.Tensor):
    for name, t in (("dy", dy), ("x", x)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the window kernel takes f32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dy.device != x.device or x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dy and x must lie on one cuda or cpu device, got "
                         f"{dy.device} and {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if h % 2 or w % 2 or c % 4:
        raise ValueError(f"the window kernel takes even H and W and C % 4 "
                         f"== 0, got NHWC {tuple(x.shape)}")
    if tuple(dy.shape) != (n, h // 2, w // 2, c):
        raise ValueError(f"dy must be {(n, h // 2, w // 2, c)}, got "
                         f"{tuple(dy.shape)}")
    return n, h, w, c


def maxpool2x2_bwd_plain(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops (``pooling.py:48-67``)."""
    n, h, w, c = x.shape
    x6 = x.view(n, h // 2, 2, w // 2, 2, c)
    ea, eb = x6[:, :, 0, :, 0], x6[:, :, 0, :, 1]
    oa, ob = x6[:, :, 1, :, 0], x6[:, :, 1, :, 1]
    m = torch.maximum(torch.maximum(ea, eb), torch.maximum(oa, ob))
    m1 = ea >= m
    m2 = (eb >= m) & ~m1
    m12 = m1 | m2
    m3 = (oa >= m) & ~m12
    m4 = (ob >= m) & ~(m12 | m3)
    z = torch.zeros_like(dy)
    top = torch.stack([torch.where(m1, dy, z), torch.where(m2, dy, z)], 3)
    bot = torch.stack([torch.where(m3, dy, z), torch.where(m4, dy, z)], 3)
    return torch.stack([top, bot], 2).reshape(n, h, w, c)


def maxpool2x2_bwd(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dx [N, H, W, C] f32 of 2x2/stride-2 unpadded max pooling, from dy
    [N, H/2, W/2, C] and the forward input x, both f32, contiguous, on one
    device; H and W even, C % 4 == 0."""
    n, h, w, c = _window_shapes(dy, x)
    if x.device.type == "cpu":
        return maxpool2x2_bwd_plain(dy, x)
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("the window kernel needs 16-byte aligned x and dy")
    dx = torch.empty_like(x)
    if x.numel():
        cuda_build.launch(_lib().xsmm_maxpool2x2_bwd, x.device, x.data_ptr(),
                          dy.data_ptr(), dx.data_ptr(), n, h, w, c)
        launches["maxpool2x2_bwd"] += 1
    return dx


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


class PoolingLayer:
    def __init__(self, desc: PoolingDesc):
        self.desc = desc
        d = desc
        self._dt = TORCH_DTYPES[d.dtype]
        use_window_kernel = (
            os.environ.get("XSMM_POOL_WINDOW_KERNEL", "0") == "1"
            and d.pool_type == PoolType.MAX
            and (d.r, d.s, d.u, d.v) == (2, 2, 2, 2)
            and d.pad_h == 0 and d.pad_w == 0
            and d.h % 2 == 0 and d.w % 2 == 0 and d.c % 128 == 0)
        if use_window_kernel:
            self._bwd = maxpool2x2_bwd
            self.bwd_kind = "pallas_window"
        else:
            self._bwd = self._bwd_vjp
            self.bwd_kind = "vjp"

    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        """f32 NHWC in, f32 NHWC out."""
        d = self.desc
        win, stride = (d.r, d.s), (d.u, d.v)
        pads = (0, 0, d.pad_w, d.pad_w, d.pad_h, d.pad_h)
        if d.pool_type == PoolType.MAX:
            if d.pad_h or d.pad_w:
                x = F.pad(x, pads, value=-math.inf)
            y = F.max_pool2d(x.permute(0, 3, 1, 2), win, stride)
        else:
            if d.pad_h or d.pad_w:
                x = F.pad(x, pads)
            y = F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride)
        return y.permute(0, 2, 3, 1)

    def _bwd_vjp(self, dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            (dx,) = torch.autograd.grad(self._fwd(xr), xr, dy)
        return dx

    def forward(self, x):
        x = on(x, device_of(x), torch.float32).contiguous()
        return self._fwd(x).to(self._dt).contiguous()

    def backward(self, dy, x):
        """dx; x is the fwd input (replaces the reference's stored mask)."""
        dev = device_of(dy, x)
        dy = on(dy, dev, torch.float32).contiguous()
        x = on(x, dev, torch.float32).contiguous()
        return self._bwd(dy, x).to(self._dt).contiguous()

    def execute(self, kind: Kind, **t):
        if kind == Kind.FWD:
            return self.forward(t["input"])
        if kind == Kind.BWD:
            return self.backward(t["grad_output"], t["input"])
        raise ValueError(kind)


def create_pooling_layer(desc: PoolingDesc) -> PoolingLayer:
    return PoolingLayer(desc)
