"""Convolution layer handle: forward / backward-data / weight-update.  The
port of ``xsmm_tpu/dnn/conv.py``.

Reference: libxsmm_dnn_create_conv_layer + libxsmm_dnn_execute_st with kinds
FWD/BWD/UPD (libxsmm_dnn.c:2217, templates in src/template/
libxsmm_dnn_convolve_st_*.tpl.c).

As the JAX package leaves its convolutions to XLA, the port leaves them to
cuDNN (oneDNN on the CPU): ``F.conv2d`` for FWD, ``torch.nn.grad``'s
``conv2d_input`` (BWD; given the input size, which settles the
(H + 2p - R) % u != 0 ambiguity of strided shapes) and ``conv2d_weight``
(UPD).  Layouts at the public methods are the JAX package's: NHWC
activations and HWIO filters, NCHW/KCRS converted at the boundary; inside,
an NHWC tensor is handed to torch as a channels-last NCHW view.

Numerics, the JAX package's:

* f32 convs run in full f32: cuDNN's TF32, its default for convs, is off
  for the call and the caller's setting restored after it
  (``ops/smm._full_f32_conv``), as the reference forces HIGHEST
  (``conv.py:38-44``);
* bf16 convs round their output to bf16 before the f32 epilogue, as JAX's
  ``_core_conv`` does (``conv.py:155-199``);
* BWD and UPD take f32 operands in full f32 (JAX: default precision, full
  f32 on its CPU, one bf16 pass on the TPU).

Fusions (``conv.py:201-228``, ``:287-322``): BIAS and RELU epilogues;
BATCH_STATS_FWD (sum, sumsq), BATCHNORM_STATS (mean, population var) and
MAX_STATS (max|y|) returned as ``BatchStats``; RELU_BWD masks dy by y > 0;
ELTWISE_BWD returns the masked dy; BATCH_STATS_BWD returns ``BwdStats``
(sum dy, sum dy*y, and max|dx| with MAX_STATS).

The output space-to-depth fold (``_fold``, ``_use_s2d``; the backward's
own fold in ``_bwd_direct``) keeps the JAX package's routing and results:
fh*fw adjacent output pixels computed as channel blocks of one strided conv
with a widened filter.  It exists to fill the TPU's 128-lane MXU at narrow
K.  It runs on the CPU, and on the card only where ``S2D_ON_CARD`` says
it measured faster than the direct cuDNN conv (``PERF.md``).

Stride-1 convs (``_custom_core``) differentiate through ``_ConvCore``, the
counterpart of the JAX ``custom_vjp``: autograd through ``forward`` takes
the direct backward (``_bwd_direct``) for dx and the conv's weight
gradient for dw.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from ..core.descriptors import TORCH_DTYPES
from ..ops.smm import _full_f32_conv
from .operands import device_of, on
from .types import ConvDesc, Format, FuseOp, Kind

# Whether the card runs the space-to-depth fold where ``_use_s2d`` routes
# to it.  At the N32 C64 H56 W56 K64 3x3 s1 shape of
# samples/cnnlayer_driver.py on an H100 the fold took 1.18x (f32) and 2.1x
# (bf16) the direct cuDNN conv's time, forward and backward (chip_smoke.py,
# PERF.md).
S2D_ON_CARD = False


class BwdStats(NamedTuple):
    """Fused conv-backward reductions (BATCH_STATS_BWD / MAX_STATS)."""

    dbeta: torch.Tensor                      # per-channel sum(dy)
    dgamma_y: torch.Tensor                   # per-channel sum(dy * y)
    dx_absmax: Optional[torch.Tensor] = None  # per-channel max|dx|


class BatchStats(NamedTuple):
    """Per-channel forward statistics (BATCH_STATS_FWD / BATCHNORM_STATS /
    MAX_STATS fusions); fields absent from the requested fuse set are None."""

    sum: Optional[torch.Tensor] = None      # [K]  (BATCH_STATS_FWD)
    sumsq: Optional[torch.Tensor] = None    # [K]  (BATCH_STATS_FWD)
    mean: Optional[torch.Tensor] = None     # [K]  (BATCHNORM_STATS)
    var: Optional[torch.Tensor] = None      # [K]  (BATCHNORM_STATS)
    absmax: Optional[torch.Tensor] = None   # [K]  (MAX_STATS)


def _to_nhwc(x, fmt: Format):
    return x.permute(0, 2, 3, 1) if fmt & Format.NCHW else x


def _from_nhwc(x, fmt: Format):
    return (x.permute(0, 3, 1, 2) if fmt & Format.NCHW else x).contiguous()


def _to_hwio(w, fmt: Format):
    return w.permute(2, 3, 1, 0) if fmt & Format.KCRS else w  # OIHW -> HWIO


def _from_hwio(w, fmt: Format):
    return (w.permute(3, 2, 0, 1) if fmt & Format.KCRS else w).contiguous()


def _nchw(x):
    """An NHWC tensor as the channels-last NCHW view torch's convs take."""
    return x.permute(0, 3, 1, 2)


def _oihw(w):
    """An HWIO filter as an OIHW one, channels-last in memory."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _bwd_operands(*ts):
    """The operands of a conv's backward: as they are, but 16-bit ones on
    the CPU in f32 (the result is cast back), where oneDNN's 16-bit
    backward gives wrong weight gradients for some shapes (bf16, 1x1 input,
    3x3/s2 p1: 2.9 off in 11.7) and XLA's CPU computes it from f32."""
    if ts[0].device.type == "cpu" and ts[0].dtype in (torch.bfloat16,
                                                       torch.float16):
        return [t.float() for t in ts]
    return list(ts)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` whose backward, like its forward, runs f32 without TF32
    (a differentiated JAX conv at HIGHEST is HIGHEST both ways)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, padding)
        with _full_f32_conv(x.dtype):
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.geometry
        gb, xb, wb = _bwd_operands(g.to(x.dtype), x, w)
        with _full_f32_conv(xb.dtype):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                gb, xb, wb, None, stride, padding, (1, 1), False, (0, 0), 1,
                [*ctx.needs_input_grad[:2], False])
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype), None, None)


def _conv(x, w, stride, pads):
    """NHWC x (*) HWIO w in their dtype, padding ((top, bottom), (left,
    right)) -> NHWC y in that dtype; f32 without TF32, both ways."""
    (pt, pb), (pl, pr) = pads
    if pt != pb or pl != pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pt = pl = 0
    y = _Conv2d.apply(_nchw(x), _oihw(w), tuple(stride), (pt, pl))
    return y.permute(0, 2, 3, 1)


def _folded(x, w, fold, pads, oh, ow):
    """The output space-to-depth fold of a stride-1 conv: fh*fw adjacent
    output pixels as channel blocks of one (fh, fw)-strided conv with the
    filter widened to (R+fh-1, S+fw-1), sliced to the oh x ow output."""
    fh, fw = fold
    r, s, c, k = w.shape
    w2 = w.new_zeros((r + fh - 1, s + fw - 1, c, fh * fw * k))
    for a in range(fh):
        for b in range(fw):
            blk = (a * fw + b) * k
            w2[a:a + r, b:b + s, :, blk:blk + k] = w
    (pt, pb), (pl, pr) = pads
    y2 = _conv(x, w2, (fh, fw), ((pt, pb + fh - 1), (pl, pr + fw - 1)))
    n_, h_, w_, _ = y2.shape
    y = (y2.reshape(n_, h_, w_, fh, fw, k).permute(0, 1, 3, 2, 4, 5)
         .reshape(n_, h_ * fh, w_ * fw, k))
    return y[:, :oh, :ow]


class _ConvCore(torch.autograd.Function):
    """The JAX ``core`` custom_vjp (``conv.py:112-150``): (x, w) -> f32 y;
    dx from the direct transposed-filter conv, dw from the conv's weight
    gradient in the input dtype."""

    @staticmethod
    def forward(ctx, layer, x, w):
        ctx.layer = layer
        ctx.save_for_backward(x, w)
        return layer._core_conv(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        layer = ctx.layer
        dx = layer._bwd_direct(g, w.float())
        xb, gb = _bwd_operands(x, g.to(x.dtype))
        with _full_f32_conv(xb.dtype):
            dw = conv2d_weight(_nchw(xb), (w.shape[3], w.shape[2], w.shape[0],
                                           w.shape[1]),
                               _nchw(gb), stride=layer._strides,
                               padding=(layer.desc.pad_h, layer.desc.pad_w))
        return None, dx.to(x.dtype), dw.permute(2, 3, 1, 0).to(w.dtype)


class ConvLayer:
    """Stateless conv layer handle."""

    def __init__(self, desc: ConvDesc):
        self.desc = desc
        d = desc
        self._in_dt = TORCH_DTYPES[d.in_dtype]
        self._out_dt = TORCH_DTYPES[d.out_dtype]
        self._pad = ((d.pad_h, d.pad_h), (d.pad_w, d.pad_w))
        self._strides = (d.u, d.v)
        # the JAX package's routing of the output space-to-depth fold
        self._fold = (2 if (d.k <= 32 and d.u == 1 and d.h >= 2 * d.r)
                      else 1,
                      2 if (d.k <= 64 and d.v == 1 and d.w >= 2 * d.s)
                      else 1)
        if d.u != 1 or d.v != 1:
            self._fold = (1, 1)
        self._use_s2d = self._fold != (1, 1)
        self._custom_core = (d.u == 1 and d.v == 1
                             and d.r - 1 - d.pad_h >= 0
                             and d.s - 1 - d.pad_w >= 0)

    @staticmethod
    def _fold_runs(x) -> bool:
        return x.device.type == "cpu" or S2D_ON_CARD

    # -- FWD -----------------------------------------------------------------
    def _core_conv(self, x, w):
        """NHWC x, HWIO w (already in in_dtype) -> f32 NHWC y; a bf16 conv
        rounds its output to bf16 before the upcast."""
        if self._use_s2d and self._fold_runs(x):
            r, s = w.shape[:2]
            (pt, pb), (pl, pr) = self._pad
            y = _folded(x, w, self._fold, self._pad,
                        x.shape[1] + pt + pb - r + 1,
                        x.shape[2] + pl + pr - s + 1)
        else:
            y = _conv(x, w, self._strides, self._pad)
        return y.float()

    def _core(self, x, w):
        if self._custom_core:
            return _ConvCore.apply(self, x, w)
        return self._core_conv(x, w)

    def forward(self, x, w, bias=None):
        """y, or (y, BatchStats) with a forward-stats fusion."""
        d = self.desc
        dev = device_of(x, w, bias)
        x = _to_nhwc(on(x, dev, self._in_dt), d.buffer_format)
        w = _to_hwio(on(w, dev, self._in_dt), d.filter_format)
        y = self._core(x, w)
        if d.fuse_ops & FuseOp.BIAS:
            if bias is None:
                raise ValueError("BIAS fusion requires bias operand")
            y = y + on(bias, dev, torch.float32)
        if d.fuse_ops & FuseOp.RELU:
            y = torch.relu(y)
        stats = None
        fwd_stats = (FuseOp.BATCH_STATS_FWD | FuseOp.BATCHNORM_STATS
                     | FuseOp.MAX_STATS)
        if d.fuse_ops & fwd_stats:
            red = (0, 1, 2)
            fields = {}
            if d.fuse_ops & FuseOp.BATCH_STATS_FWD:
                fields["sum"] = y.sum(red)
                fields["sumsq"] = (y * y).sum(red)
            if d.fuse_ops & FuseOp.BATCHNORM_STATS:
                fields["mean"] = y.mean(red)
                fields["var"] = y.var(red, correction=0)
            if d.fuse_ops & FuseOp.MAX_STATS:
                fields["absmax"] = y.abs().amax(red)
            stats = BatchStats(**fields)
        y = _from_nhwc(y.to(self._out_dt), d.buffer_format)
        return (y, stats) if stats is not None else y

    # -- BWD / UPD -------------------------------------------------------------
    def _bwd_direct(self, dy, w):
        """dx for stride-1 convs as a plain conv of dy with the flipped,
        C/K-swapped filter, with the JAX package's fold where C is narrow.
        NHWC dy, HWIO w; f32 out."""
        d = self.desc
        wr = torch.flip(w, (0, 1)).transpose(2, 3).to(self._in_dt)  # [r,s,k,c]
        dy = dy.to(self._in_dt)
        r, s, _, c_ = wr.shape
        p2h, p2w = d.r - 1 - d.pad_h, d.s - 1 - d.pad_w
        pads = ((p2h, p2h), (p2w, p2w))
        fh = 2 if (c_ <= 32 and dy.shape[1] >= 2 * r) else 1
        fw = 2 if (c_ <= 64 and dy.shape[2] >= 2 * s) else 1
        if (fh, fw) == (1, 1) or not self._fold_runs(dy):
            return _conv(dy, wr, (1, 1), pads).float()
        return _folded(dy, wr, (fh, fw), pads, dy.shape[1] + 2 * p2h - r + 1,
                       dy.shape[2] + 2 * p2w - s + 1).float()

    def backward(self, dy, w, y=None):
        """dx; with fusions the return is (dx[, d_eltwise][, BwdStats]).

        Pass y with RELU_BWD (activation mask) or BATCH_STATS_BWD (the
        fused BN-backward reductions need the forward output)."""
        d = self.desc
        if d.fuse_ops & (FuseOp.RELU_BWD | FuseOp.BATCH_STATS_BWD) \
                and y is None:
            raise ValueError("RELU_BWD / BATCH_STATS_BWD fusions require the "
                             "forward activation y")
        dev = device_of(dy, w, y)
        dy = _to_nhwc(on(dy, dev, torch.float32), d.buffer_format)
        if y is not None:
            y = _to_nhwc(on(y, dev, torch.float32), d.buffer_format)
        if y is not None and d.fuse_ops & FuseOp.RELU_BWD:
            dy = torch.where(y > 0, dy, 0.0)
        extras = []
        if d.fuse_ops & FuseOp.ELTWISE_BWD:
            extras.append(_from_nhwc(dy.to(self._in_dt), d.buffer_format))
        w = _to_hwio(on(w, dev, torch.float32), d.filter_format)
        if self._custom_core:
            dx = self._bwd_direct(dy, w)
        else:
            with _full_f32_conv(torch.float32):
                dx = conv2d_input((dy.shape[0], d.c, d.h, d.w), _oihw(w),
                                  _nchw(dy), stride=self._strides,
                                  padding=(d.pad_h, d.pad_w))
            dx = dx.permute(0, 2, 3, 1)
        if d.fuse_ops & FuseOp.BATCH_STATS_BWD:
            red = (0, 1, 2)
            extras.append(BwdStats(
                dbeta=dy.sum(red), dgamma_y=(dy * y).sum(red),
                dx_absmax=(dx.abs().amax(red)
                           if d.fuse_ops & FuseOp.MAX_STATS else None)))
        dx = _from_nhwc(dx.to(self._in_dt), d.buffer_format)
        return (dx, *extras) if extras else dx

    def weight_update(self, x, dy):
        """dw in the filter format and in_dtype."""
        d = self.desc
        dev = device_of(x, dy)
        x = _to_nhwc(on(x, dev, torch.float32), d.buffer_format)
        dy = _to_nhwc(on(dy, dev, torch.float32), d.buffer_format)
        with _full_f32_conv(torch.float32):
            dw = conv2d_weight(_nchw(x), (d.k, d.c, d.r, d.s), _nchw(dy),
                               stride=self._strides,
                               padding=(d.pad_h, d.pad_w))
        return _from_hwio(dw.permute(2, 3, 1, 0).to(self._in_dt),
                          d.filter_format)

    # -- reference-style execute ------------------------------------------------
    def execute(self, kind: Kind, **tensors):
        """libxsmm_dnn_execute_st analog (functional: returns results)."""
        if kind == Kind.FWD:
            return self.forward(tensors["input"], tensors["filter"],
                                tensors.get("bias"))
        if kind == Kind.BWD:
            return self.backward(tensors["grad_output"], tensors["filter"],
                                 tensors.get("output"))
        if kind == Kind.UPD:
            return self.weight_update(tensors["input"],
                                      tensors["grad_output"])
        raise ValueError(kind)


def create_conv_layer(desc: ConvDesc) -> ConvLayer:
    """libxsmm_dnn_create_conv_layer analog."""
    return ConvLayer(desc)
