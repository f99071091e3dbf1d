"""Fused batch normalization (fwd + bwd) with eltwise-add / ReLU fusions:
the port of ``xsmm_tpu/dnn/batchnorm.py``.

Reference: src/libxsmm_dnn_fusedbatchnorm*.c with fuse flags BN / ELTWISE /
RELU combos (libxsmm_typedefs.h:378-391).  Running (global) statistics for
inference follow the GxM engine exactly (Caffe-style moving sums,
gxm/src/FusedBNormXSMM.cpp:427-467 and FusedBNorm.hpp:112-136):

  train:  gmean = gmean*mmf + batch_mean
          gvar  = gvar*mmf  + nhw/(nhw-1) * batch_var      (unbiased)
          scf   = scf*mmf + 1
  eval:   mean = gmean/scf;  var = gvar/scf   (use_global_stats path,
          FusedBNormXSMM.cpp:462-467)

The formulas are the JAX package's, in f32 torch ops on NHWC tensors:
var = E[x^2] - mean^2 (one pass over x for both moments, not
``torch.var``), ``torch.rsqrt``, the backward's sums over N, H, W with the
descriptor's nhw, and a fresh running state (scf = 0) evaluating with the
identity statistics.  Cross-replica statistics (``axis_name``) need the
port of ``parallel/`` (ROADMAP Queue 1 item 7) and raise
``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import platform
from ..core.descriptors import TORCH_DTYPES
from .operands import device_of, on
from .types import BnDesc, BnFuse, Kind

_RED = (0, 1, 2)  # N, H, W of NHWC


class BnState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    inv_std: torch.Tensor
    x_hat: torch.Tensor
    relu_mask: Optional[torch.Tensor]


class BnRunning(NamedTuple):
    """Global-statistics state (gmean/gvar moving sums + scaling factor).

    Mirrors GxM's (tenMeanData_, tenVarData_, scf_) triple: sums are scaled
    by 1/scf at use, so a fresh state (scf=0) has no history and the very
    first eval after one train step reproduces that step's batch stats.
    """

    gmean: torch.Tensor   # [C] moving sum of batch means
    gvar: torch.Tensor    # [C] moving sum of unbiased batch variances
    scf: torch.Tensor     # scalar normalizer: sum of mmf^i


class FusedBatchNorm:
    def __init__(self, desc: BnDesc, axis_name: Optional[str] = None):
        if axis_name:
            raise NotImplementedError(
                "cross-replica batchnorm (axis_name) needs the port of "
                "parallel/ (ROADMAP Queue 1 item 7)")
        self.desc = desc
        self._dt = TORCH_DTYPES[desc.dtype]

    def _epilogue(self, x_hat, gamma, beta, residual, dev):
        """y = x_hat*gamma + beta (+ residual) (ReLU) -> (y, relu mask)."""
        d = self.desc
        y = x_hat * gamma + beta
        if d.fuse & BnFuse.ELTWISE:
            if residual is None:
                raise ValueError("ELTWISE fusion requires residual")
            y = y + on(residual, dev, torch.float32)
        mask = None
        if d.fuse & BnFuse.RELU:
            mask = y > 0
            y = torch.relu(y)
        return y.to(self._dt), mask

    def _params(self, dev, *ps):
        return [on(p, dev, torch.float32) for p in ps]

    def forward(self, x, gamma, beta, residual=None):
        dev = device_of(x, gamma, beta)
        x, gamma, beta = self._params(dev, x, gamma, beta)
        mean = x.mean(_RED)
        ex2 = (x * x).mean(_RED)
        var = ex2 - mean * mean
        inv_std = torch.rsqrt(var + self.desc.eps)
        x_hat = (x - mean) * inv_std
        y, mask = self._epilogue(x_hat, gamma, beta, residual, dev)
        return y, BnState(mean, var, inv_std, x_hat, mask)

    def forward_eval(self, x, gamma, beta, running: BnRunning,
                     residual=None):
        """Inference forward using the global statistics: gmean/scf and
        gvar/scf, no batch reductions; scf == 0 (no training history)
        normalizes with the identity statistics (mean 0, var 1)."""
        dev = device_of(x, gamma, beta)
        x, gamma, beta, gmean, gvar, scf = self._params(
            dev, x, gamma, beta, *running)
        has = scf > 0
        scf = torch.where(has, scf, 1.0)
        mean = gmean / scf
        var = torch.where(has, gvar / scf, 1.0)
        inv_std = torch.rsqrt(var + self.desc.eps)
        return self._epilogue((x - mean) * inv_std, gamma, beta, residual,
                              dev)[0]

    def forward_from_moments(self, x, gamma, beta, mean, var,
                             residual=None):
        """Train forward with externally-computed batch moments (from a
        producing conv's BATCH_STATS_FWD fusion); skips the reduction
        passes.  Returns (y, BnState) like forward."""
        dev = device_of(x, gamma, beta)
        x, gamma, beta, mean, var = self._params(dev, x, gamma, beta, mean,
                                                 var)
        inv_std = torch.rsqrt(var + self.desc.eps)
        x_hat = (x - mean) * inv_std
        y, mask = self._epilogue(x_hat, gamma, beta, residual, dev)
        return y, BnState(mean, var, inv_std, x_hat, mask)

    def backward(self, dy, gamma, state: BnState):
        """(dx, dgamma, dbeta), and dresidual (the masked dy) with the
        ELTWISE fusion."""
        d = self.desc
        dev = state.x_hat.device
        dy, gamma = self._params(dev, dy, gamma)
        if state.relu_mask is not None:
            dy = torch.where(state.relu_mask, dy, 0.0)
        nhw = d.n * d.h * d.w
        dgamma = (dy * state.x_hat).sum(_RED)
        dbeta = dy.sum(_RED)
        dx_hat = dy * gamma
        s1 = dx_hat.sum(_RED)
        s2 = (dx_hat * state.x_hat).sum(_RED)
        dx = (state.inv_std / nhw) * (nhw * dx_hat - s1 - state.x_hat * s2)
        out = (dx.to(self._dt), dgamma, dbeta)
        return out + ((dy,) if d.fuse & BnFuse.ELTWISE else ())

    def init_running(self) -> BnRunning:
        """Fresh global-stats state (all-zero sums, scf=0) on the entry
        points' device."""
        dev, c = platform.device(), self.desc.c
        return BnRunning(torch.zeros((c,), device=dev),
                         torch.zeros((c,), device=dev),
                         torch.zeros((), device=dev))

    def update_running(self, running: BnRunning, state: BnState
                       ) -> BnRunning:
        """Fold one train step's batch stats into the moving sums
        (FusedBNormXSMM.cpp:427-457; the ratio is the unbiased-variance
        correction nhw/(nhw-1))."""
        d = self.desc
        nhw = d.n * d.h * d.w
        ratio = torch.tensor(nhw / max(nhw - 1, 1), dtype=torch.float32)
        gmean, gvar, scf = self._params(state.mean.device, *running)
        return BnRunning(gmean * d.mmf + state.mean,
                         gvar * d.mmf + ratio.item() * state.var,
                         scf * d.mmf + 1.0)

    def execute(self, kind: Kind, **t):
        if kind == Kind.FWD:
            if "running" in t:
                return self.forward_eval(t["input"], t["gamma"], t["beta"],
                                         t["running"], t.get("residual"))
            return self.forward(t["input"], t["gamma"], t["beta"],
                                t.get("residual"))
        if kind == Kind.BWD:
            return self.backward(t["grad_output"], t["gamma"], t["state"])
        raise ValueError(kind)


def create_fusedbatchnorm(desc: BnDesc, axis_name=None) -> FusedBatchNorm:
    return FusedBatchNorm(desc, axis_name)
