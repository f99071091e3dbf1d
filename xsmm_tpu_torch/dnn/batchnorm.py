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
identity statistics.

Cross-replica BN (``axis_name``), the JAX package's sync BN: one
controller drives the replicas of the axis in lock-step
(``parallel/mesh.py``), so its calls take a sequence of tensors, one a
replica (``forward(xs, gamma, beta)``; gamma and beta a tensor or one a
replica).  The forward averages the moments mean and E[x^2] across the
replicas, never the variances (a per-shard variance would drop the
between-shard variance); the backward sums dgamma, dbeta and the s1, s2
terms of dx, and counts nhw over every replica.  The average and the sum
are ``pmean``/``psum`` arguments (default: over the sequence, in order,
on each replica's device); the layer graph passes the mesh's, which reach
across processes.  Torch ops throughout, so autograd differentiates the
forward too.
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
        self.desc = desc
        self.axis_name = axis_name
        self._dt = TORCH_DTYPES[desc.dtype]

    def _replicas(self, xs, what: str) -> list:
        if (isinstance(xs, (torch.Tensor, BnState))
                or not isinstance(xs, (list, tuple))):
            raise ValueError(
                f"cross-replica batchnorm (axis_name={self.axis_name!r}) "
                f"takes {what} as a sequence, one tensor a replica")
        return list(xs)

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

    def forward(self, x, gamma, beta, residual=None, pmean=None):
        """(y, BnState); with ``axis_name``, x (and residual) a sequence of
        replicas: ([y], [BnState]) on the moments averaged by ``pmean``.
        One tensor is the replica version over one replica."""
        if self.axis_name:
            return self.forward_replicas(self._replicas(x, "x"), gamma, beta,
                                         residual, pmean)
        ys, states = self.forward_replicas([x], gamma, beta, residual)
        return ys[0], states[0]

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

    def forward_replicas(self, xs, gammas, betas, residuals=None,
                         pmean=None):
        """The cross-replica forward over ``xs`` (one tensor a replica):
        each replica's mean and E[x^2], averaged by ``pmean`` (a function
        of the list; default the mean over the list), then each replica
        normalized with the common moments.  Returns ([y], [BnState])."""
        n = len(xs)
        gammas, betas, residuals = (_each(v, n) for v in (gammas, betas,
                                                           residuals))
        pmean = pmean or _mean_over
        xs32, means, ex2s = [], [], []
        for x, g, b in zip(xs, gammas, betas):
            dev = device_of(x, g, b)
            x = on(x, dev, torch.float32)
            xs32.append(x)
            means.append(x.mean(_RED))
            ex2s.append((x * x).mean(_RED))
        ys, states = [], []
        for x, g, b, r, mean, ex2 in zip(xs32, gammas, betas, residuals,
                                         pmean(means), pmean(ex2s)):
            dev = x.device
            g, b = self._params(dev, g, b)
            var = ex2 - mean * mean
            inv_std = torch.rsqrt(var + self.desc.eps)
            x_hat = (x - mean) * inv_std
            y, mask = self._epilogue(x_hat, g, b, r, dev)
            ys.append(y)
            states.append(BnState(mean, var, inv_std, x_hat, mask))
        return ys, states

    def backward_replicas(self, dys, gammas, states, psum=None,
                          count: Optional[int] = None):
        """The cross-replica backward: dgamma, dbeta and the s1, s2 terms
        of dx summed by ``psum`` (default the sum over the list), nhw
        counted over ``count`` replicas (default len(dys)).  Returns
        ([dx], [dgamma], [dbeta]) and [dresidual] with ELTWISE."""
        d = self.desc
        n = len(dys)
        gammas = _each(gammas, n)
        psum = psum or _sum_over
        nhw = d.n * d.h * d.w * (count or n)
        parts = []
        for dy, g, st in zip(dys, gammas, states):
            dev = st.x_hat.device
            dy, g = self._params(dev, dy, g)
            if st.relu_mask is not None:
                dy = torch.where(st.relu_mask, dy, 0.0)
            dx_hat = dy * g
            parts.append((dy, dx_hat, (dy * st.x_hat).sum(_RED),
                          dy.sum(_RED), dx_hat.sum(_RED),
                          (dx_hat * st.x_hat).sum(_RED)))
        dgs, dbs, s1s, s2s = (psum([p[i] for p in parts])
                              for i in range(2, 6))
        dxs = [((st.inv_std / nhw) * (nhw * p[1] - s1 - st.x_hat * s2)
                ).to(self._dt)
               for p, st, s1, s2 in zip(parts, states, s1s, s2s)]
        out = (dxs, dgs, dbs)
        return out + (([p[0] for p in parts],)
                      if d.fuse & BnFuse.ELTWISE else ())

    def backward(self, dy, gamma, state: BnState, psum=None):
        """(dx, dgamma, dbeta), and dresidual (the masked dy) with the
        ELTWISE fusion; with ``axis_name``, dy and state sequences of
        replicas, and lists come back (``backward_replicas``).  One tensor
        is the replica version over one replica."""
        if self.axis_name:
            return self.backward_replicas(self._replicas(dy, "dy"), gamma,
                                          self._replicas(state, "state"),
                                          psum)
        return tuple(v[0] for v in self.backward_replicas([dy], gamma,
                                                          [state]))

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


def _each(v, n: int) -> list:
    """One value a replica: a sequence as it is, anything else repeated."""
    if isinstance(v, (list, tuple)) and not isinstance(v, BnRunning):
        if len(v) != n:
            raise ValueError(f"{len(v)} values for {n} replicas")
        return list(v)
    return [v] * n


def _sum_over(vs):
    """The sum of the list in order, on each member's device (a list of
    one as it is)."""
    acc = vs[0]
    for v in vs[1:]:
        acc = acc + v.to(acc.device)
    return [acc.to(v.device) for v in vs]


def _mean_over(vs):
    """The mean of the list in order, on each member's device (a list of
    one as it is)."""
    if len(vs) == 1:
        return list(vs)
    return [v / len(vs) for v in _sum_over(vs)]


def create_fusedbatchnorm(desc: BnDesc, axis_name=None) -> FusedBatchNorm:
    return FusedBatchNorm(desc, axis_name)
