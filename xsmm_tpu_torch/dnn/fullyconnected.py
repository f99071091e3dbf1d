"""Fully-connected layer handle (fwd / bwd / upd): the port of
``xsmm_tpu/dnn/fullyconnected.py``.

Reference: src/libxsmm_dnn_fullyconnected*.c — dense layer over blocked
formats driven by batch-reduce GEMM kernels.  As in the JAX package, which
leaves them to XLA outside any Pallas kernel, the three kinds are three
matrix products (here ``torch.mm``):

  FWD: y[N,K] = x[N,C] @ w[C,K] (+ bias, ReLU fusions)
  BWD: dx = dy @ w^T
  UPD: dw = x^T @ dy

Numerics, the JAX package's: f32 inputs multiply in full f32 (no TF32);
bf16 and f16 inputs give an f32 product (``preferred_element_type=f32``)
before the bias: ``torch.mm(..., out_dtype=torch.float32)`` on the card,
an f32 upcast on the CPU (exact products, f32 sums).  BWD and UPD take f32
operands and run in full f32, where the JAX package runs them at default
precision (full f32 on its CPU).  The forward returns ``(y, relu_mask)``
with the RELU fusion, else y.
"""

from __future__ import annotations

import torch

from ..core.descriptors import TORCH_DTYPES
from ..ops.smm import _matmul
from .operands import device_of, on
from .types import FCDesc, FuseOp, Kind

_LOW = (torch.bfloat16, torch.float16)


class _MmF32(torch.autograd.Function):
    """a @ b with an f32 result: full f32 for f32 operands; bf16/f16
    operands multiplied exactly and summed in f32 (``torch.mm(...,
    out_dtype=torch.float32)`` on the card, an f32 upcast on the CPU).
    Both gradients are full-f32 products cast to the operand's dtype,
    whatever the caller's TF32 setting, as the upcast product's are."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dtype in _LOW and a.device.type == "cuda":
            return torch.mm(a, b, out_dtype=torch.float32)
        return _matmul(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _matmul(g, b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _matmul(a.float().t(), g).to(b.dtype)
        return da, db


_mm_f32 = _MmF32.apply


class FullyConnectedLayer:
    def __init__(self, desc: FCDesc):
        self.desc = desc
        self._in_dt = TORCH_DTYPES[desc.in_dtype]
        self._out_dt = TORCH_DTYPES[desc.out_dtype]

    def _mask(self, dy, relu_mask):
        if relu_mask is None:
            return dy
        return torch.where(on(relu_mask, dy.device, torch.bool), dy, 0.0)

    def forward(self, x, w, bias=None):
        d = self.desc
        if d.fuse_ops & FuseOp.BIAS and bias is None:
            raise ValueError("BIAS fusion requires bias operand")
        dev = device_of(x, w, bias)
        y = _mm_f32(on(x, dev, self._in_dt), on(w, dev, self._in_dt))
        if d.fuse_ops & FuseOp.BIAS:
            y = y + on(bias, dev, torch.float32)
        relu_mask = None
        if d.fuse_ops & FuseOp.RELU:
            relu_mask = y > 0
            y = torch.relu(y)
        y = y.to(self._out_dt)
        return (y, relu_mask) if relu_mask is not None else y

    def backward(self, dy, w, relu_mask=None):
        dev = device_of(dy, w)
        dy = self._mask(on(dy, dev, torch.float32), relu_mask)
        dx = _matmul(dy, on(w, dev, torch.float32).t())
        return dx.to(self._in_dt)

    def weight_update(self, x, dy, relu_mask=None):
        dev = device_of(x, dy)
        dy = self._mask(on(dy, dev, torch.float32), relu_mask)
        dw = _matmul(on(x, dev, torch.float32).t(), dy)
        return dw.to(self._in_dt), dy.sum(0)

    def execute(self, kind: Kind, **t):
        if kind == Kind.FWD:
            return self.forward(t["input"], t["filter"], t.get("bias"))
        if kind == Kind.BWD:
            return self.backward(t["grad_output"], t["filter"],
                                 t.get("relu_mask"))
        if kind == Kind.UPD:
            return self.weight_update(t["input"], t["grad_output"],
                                      t.get("relu_mask"))
        raise ValueError(kind)


def create_fullyconnected_layer(desc: FCDesc) -> FullyConnectedLayer:
    return FullyConnectedLayer(desc)
