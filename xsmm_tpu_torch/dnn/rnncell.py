"""RNN / LSTM / GRU cell handles: the port of ``xsmm_tpu/dnn/rnncell.py``.

Reference: src/libxsmm_dnn_rnncell*.c + templates (e.g.
libxsmm_dnn_rnncell_st_lstm_fwd_nc_kcck.tpl.c): per-timestep batch-reduce
GEMMs W.x_t and R.h_{t-1} feeding fused sigmoid/tanh gate code, a
sequential T loop; gate order i, c(=g), f, o.

As in the JAX package, every cell hoists the input projection x@W (+b) out
of the T loop as one flat ``[T*N, C] @ [C, G*K]`` product (``torch.matmul``
with TF32 off, as the JAX package leaves it to XLA), and the sequential
h@R part with the gate math runs as ONE kernel launch over all T steps
(``rnn_seq.py``).  Shapes outside the kernel's envelope (``seq_kernel_ok``
False) take the scan route: a loop of torch ops over T (LSTM: the fused
``[x_t, h] @ [W; R]`` per step), counted in ``scan_calls``.  The route is a
static decision on the shape, not a fallback on failure.

Backward, for every cell type, as the JAX package's ``custom_vjp``: a
``torch.autograd.Function`` per core (``_LstmCore``, ``_GruCore``,
``_RnnCore``), so ``forward`` is differentiable in every tensor input.  Its
reverse scan does only the gate-gradient math and dh_prev = dz @ R^T, as
ONE launch of the backward kernel (``rnn_seq.*_seq_bwd``), with dz emitted
in R's dtype and db summed in f32; dx, dw and dr are flat products over T*N
after it, against ``hs[:-1]`` with the t = 0 term apart.  Outside the
backward kernel's own envelope (``seq_bwd_kernel_ok`` False) the reverse
scan runs on torch ops in f32 (the plain version's loop with f32 R^T),
counted in ``bwd_scan_calls``; forward and backward may take different
routes, the residuals are the same on both.  ``forward_train`` /
``backward_from_saved`` keep the residuals between the two calls (the
reference handle's stored activations); ``backward_weight_update`` and
``execute(Kind.BWD | Kind.UPD)`` recompute them.

Weight layout, the JAX package's: w [C, G*K], r [K, G*K], b [G*K] with G
gates ordered (i, c, f, o) for the LSTM and (r, z, g) for the GRU.  Dtypes:
an f32 cell computes h@R in full f32; a bf16 cell stores R in bf16 and
rounds h to bf16 before the product, sums in f32, keeps the gate math in
f32 and casts hs to ``out_dtype`` at the end; x@W is full f32 in both.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import platform
from ..core.descriptors import ITEMSIZE, TORCH_DTYPES, dtype_name
from ..ops.smm import _matmul
from .rnn_seq import (ACTS, gru_seq, gru_seq_bwd, gru_seq_bwd_plain, lstm_seq,
                      lstm_seq_bwd, lstm_seq_bwd_plain, rnn_seq, rnn_seq_bwd,
                      rnn_seq_bwd_plain, seq_bwd_kernel_ok, seq_kernel_ok)
from .rnn_seq import keep as _keep
from .types import CellType, Kind, RnnDesc

# calls of the scan routes (shapes outside the kernels' envelopes), by cell:
# the forward's, and the backward's
scan_calls: Dict[str, int] = {"lstm": 0, "gru": 0, "rnn": 0}
bwd_scan_calls: Dict[str, int] = {"lstm": 0, "gru": 0, "rnn": 0}

_ACTS = {CellType.RNN_RELU: "relu", CellType.RNN_SIGMOID: "sigmoid",
         CellType.RNN_TANH: "tanh"}


def reset_scan_calls() -> None:
    for counts in (scan_calls, bwd_scan_calls):
        for name in counts:
            counts[name] = 0


def _f32(x, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous f32 tensor on ``dev``."""
    return torch.as_tensor(x).to(dev, torch.float32).contiguous()


def rnn_params_from_numpy(w, r, b, *, device=None):
    """The JAX package's cell parameters (numpy arrays: w [C, G*K],
    r [K, G*K], b [G*K]) as the port's f32 tensors on ``device`` (default:
    the entry points' device)."""
    dev = platform.device() if device is None else torch.device(device)
    return tuple(_f32(np.asarray(v), dev) for v in (w, r, b))


def _flat_grads(xt_f, w, h0, hs, dzx, dzr):
    """dx = dzx @ W^T, dw = x^T @ dzx and dr = h_prev^T @ dzr as flat
    products over T*N, h_prev being hs[:-1] with the t = 0 term (h0) apart,
    so that no shifted copy of hs is made."""
    t_, n_, c_in = xt_f.shape
    dzx = dzx.reshape(t_ * n_, -1).float()
    dzr = dzr.reshape(t_ * n_, -1).float()
    dx = _matmul(dzx, w.t()).reshape(t_, n_, c_in)
    dw = _matmul(xt_f.reshape(t_ * n_, c_in).t(), dzx)
    dr = (_matmul(h0.t(), dzr[:n_])
          + _matmul(hs[:-1].reshape((t_ - 1) * n_, hs.shape[2]).t(),
                    dzr[n_:]))
    return dx, dw, dr


class _LstmCore(torch.autograd.Function):
    """The JAX ``lstm_core``: (xt_f, w, r, b, h0, c0) -> (hs f32, h_T, c_T),
    the forward in its train form, keeping the residuals."""

    @staticmethod
    def forward(ctx, cell, xt_f, w, r, b, h0, c0):
        (hs, h_t, c_t), res = cell._lstm(xt_f, w, r, b, h0, c0, True)
        ctx.cell = cell
        ctx.save_for_backward(xt_f, w, r, h0, c0, hs, *res)
        ctx.set_materialize_grads(False)
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        xt_f, w, r, h0, c0, hs, *res = ctx.saved_tensors
        return (None, *ctx.cell._lstm_bwd(xt_f, w, r, h0, c0, hs, res, dhs,
                                          dh_t, dc_t))


class _GruCore(torch.autograd.Function):
    """The JAX ``gru_core``: (xt_f, w, r, b, h0) -> (hs f32, h_T)."""

    @staticmethod
    def forward(ctx, cell, xt_f, w, r, b, h0):
        (hs, h_t), res = cell._gru(xt_f, w, r, b, h0, True)
        ctx.cell = cell
        ctx.save_for_backward(xt_f, w, r, h0, hs, *res)
        ctx.set_materialize_grads(False)
        return hs, h_t

    @staticmethod
    def backward(ctx, dhs, dh_t):
        xt_f, w, r, h0, hs, *res = ctx.saved_tensors
        return (None, *ctx.cell._gru_bwd(xt_f, w, r, h0, hs, res, dhs, dh_t))


class _RnnCore(torch.autograd.Function):
    """The JAX ``rnn_core``: (xt_f, w, r, b, h0) -> (hs f32, h_T); hs is the
    residual."""

    @staticmethod
    def forward(ctx, cell, xt_f, w, r, b, h0):
        hs, h_t = cell._rnn(xt_f, w, r, b, h0)
        ctx.cell = cell
        ctx.save_for_backward(xt_f, w, r, h0, hs)
        ctx.set_materialize_grads(False)
        return hs, h_t

    @staticmethod
    def backward(ctx, dhs, dh_t):
        return (None, *ctx.cell._rnn_bwd(*ctx.saved_tensors, dhs, dh_t))


def _xw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input product x@W in full f32 (kept under
    ``rnn_seq.keep_products``)."""
    return _keep("x@W", x, w, _matmul(x, w))


class RnnState(NamedTuple):
    h: torch.Tensor
    c: Optional[torch.Tensor]


class RnnCell:
    def __init__(self, desc: RnnDesc):
        self.desc = desc
        self._act = _ACTS.get(desc.cell_type)
        bf16 = dtype_name(desc.in_dtype) == "bfloat16"
        # recurrent-weight dtype of the kernel route (the JAX r_dt)
        self._r_dt = torch.bfloat16 if bf16 else torch.float32
        self._r_size = ITEMSIZE["bfloat16" if bf16 else "float32"]
        self._out_dt = TORCH_DTYPES[dtype_name(desc.out_dtype)]

    # -- the cores: kernel route or scan route, decided on the shape ---------
    def _lstm(self, xt_f, w, r, b, h0, c0, train):
        t_, n_, c_in = xt_f.shape
        k = self.desc.k
        if seq_kernel_ok(n_, k, 4, self._r_size):
            zx = (_xw(xt_f.reshape(t_ * n_, c_in), w) + b
                  ).reshape(t_, n_, 4 * k)
            hs, h_t, c_t, *res = lstm_seq(zx, r.to(self._r_dt), h0, c0,
                                          train=train)
            return (hs, h_t, c_t), tuple(res) or None
        scan_calls["lstm"] += 1
        wr = torch.cat([w, r])
        h, c = h0, c0
        seqs = [[] for _ in range(6)]
        for x_t in xt_f:
            z = _matmul(torch.cat([x_t, h], dim=1), wr) + b
            i = torch.sigmoid(z[:, 0 * k:1 * k])
            g = torch.tanh(z[:, 1 * k:2 * k])
            f = torch.sigmoid(z[:, 2 * k:3 * k])
            o = torch.sigmoid(z[:, 3 * k:4 * k])
            c = f * c + i * g
            h = o * torch.tanh(c)
            for seq, v in zip(seqs, (h, c, i, g, f, o)):
                seq.append(v)
        hs, *res = (torch.stack(seq) for seq in seqs)
        return (hs, h, c), tuple(res)

    def _gru(self, xt_f, w, r, b, h0, train):
        t_, n_, c_in = xt_f.shape
        k = self.desc.k
        zx = (_xw(xt_f.reshape(t_ * n_, c_in), w) + b
              ).reshape(t_, n_, 3 * k)
        if seq_kernel_ok(n_, k, 3, self._r_size):
            hs, h_t, *res = gru_seq(zx, r.to(self._r_dt), h0, train=train)
            return (hs, h_t), tuple(res) or None
        scan_calls["gru"] += 1
        h = h0
        seqs = [[] for _ in range(5)]
        for zx_t in zx:
            zr = _matmul(h, r)
            ri = torch.sigmoid(zx_t[:, :k] + zr[:, :k])
            zi = torch.sigmoid(zx_t[:, k:2 * k] + zr[:, k:2 * k])
            zr_g = zr[:, 2 * k:]
            gi = torch.tanh(zx_t[:, 2 * k:] + ri * zr_g)
            h = (1.0 - zi) * gi + zi * h
            for seq, v in zip(seqs, (h, ri, zi, gi, zr_g)):
                seq.append(v)
        hs, *res = (torch.stack(seq) for seq in seqs)
        return (hs, h), tuple(res)

    def _rnn(self, xt_f, w, r, b, h0):
        t_, n_, c_in = xt_f.shape
        k = self.desc.k
        zx = (_xw(xt_f.reshape(t_ * n_, c_in), w) + b
              ).reshape(t_, n_, k)
        if seq_kernel_ok(n_, k, 1, self._r_size):
            return rnn_seq(zx, r.to(self._r_dt), h0, act=self._act)
        scan_calls["rnn"] += 1
        act = ACTS[self._act][1]
        h = h0
        hs = []
        for zx_t in zx:
            h = act(zx_t + _matmul(h, r))
            hs.append(h)
        return torch.stack(hs), h

    # -- the backward cores: kernel route or scan route, decided on the shape
    def _zeros(self, x, like):
        """``x`` as a contiguous tensor, or zeros like ``like`` for None (a
        gradient autograd did not materialize)."""
        return torch.zeros_like(like) if x is None else x.contiguous()

    def _lstm_bwd(self, xt_f, w, r, h0, c0, hs, res, dhs, dh_t, dc_t):
        """(dxt, dw, dr, db, dh0, dc0) from the forward's residuals."""
        cs, i, g, f, o = res
        n_, k = h0.shape
        dhs = self._zeros(dhs, hs)
        dh_t, dc_t = self._zeros(dh_t, h0), self._zeros(dc_t, h0)
        if seq_bwd_kernel_ok(n_, k, 4, self._r_size):
            rt = r.t().to(self._r_dt).contiguous()
            dz, dh0, dc0, db = lstm_seq_bwd(dhs, i, g, f, o, cs, c0, dh_t,
                                            dc_t, rt, dz_dt=self._r_dt)
        else:
            bwd_scan_calls["lstm"] += 1
            dz, dh0, dc0, db = lstm_seq_bwd_plain(dhs, i, g, f, o, cs, c0,
                                                  dh_t, dc_t, r.t())
        return (*_flat_grads(xt_f, w, h0, hs, dz, dz), db.reshape(-1), dh0,
                dc0)

    def _gru_bwd(self, xt_f, w, r, h0, hs, res, dhs, dh_t):
        """(dxt, dw, dr, db, dh0); dr is h_prev^T @ [dzx[:, :2K], dgiri]."""
        ris, zis, gis, zrgs = res
        n_, k = h0.shape
        dhs, dh_t = self._zeros(dhs, hs), self._zeros(dh_t, h0)
        if seq_bwd_kernel_ok(n_, k, 3, self._r_size):
            rt = r.t().to(self._r_dt).contiguous()
            dzx, dgiri, dh0, db = gru_seq_bwd(dhs, ris, zis, gis, zrgs, hs,
                                              h0, dh_t, rt, dz_dt=self._r_dt)
        else:
            bwd_scan_calls["gru"] += 1
            dzx, dgiri, dh0, db = gru_seq_bwd_plain(dhs, ris, zis, gis, zrgs,
                                                    hs, h0, dh_t, r.t())
        dzr = torch.cat([dzx[..., :2 * k], dgiri], dim=-1)
        return (*_flat_grads(xt_f, w, h0, hs, dzx, dzr), db.reshape(-1), dh0)

    def _rnn_bwd(self, xt_f, w, r, h0, hs, dhs, dh_t):
        """(dxt, dw, dr, db, dh0)."""
        n_, k = h0.shape
        dhs, dh_t = self._zeros(dhs, hs), self._zeros(dh_t, h0)
        if seq_bwd_kernel_ok(n_, k, 1, self._r_size):
            rt = r.t().to(self._r_dt).contiguous()
            dz, dh0, db = rnn_seq_bwd(dhs, hs, dh_t, rt, act=self._act,
                                      dz_dt=self._r_dt)
        else:
            bwd_scan_calls["rnn"] += 1
            dz, dh0, db = rnn_seq_bwd_plain(dhs, hs, dh_t, r.t(),
                                            act=self._act)
        return (*_flat_grads(xt_f, w, h0, hs, dz, dz), db.reshape(-1), dh0)

    def _inputs(self, xt, w, r, b, h0, c0):
        """The inputs as f32 tensors on the entry points' device (zeros for
        a missing h0 or c0); the casts are differentiable."""
        d = self.desc
        dev = platform.device()
        xt_f, w, r, b = (_f32(v, dev) for v in (xt, w, r, b))
        h0 = (_f32(h0, dev) if h0 is not None
              else torch.zeros((d.n, d.k), device=dev))
        c0 = (_f32(c0, dev) if c0 is not None else torch.zeros_like(h0))
        return xt_f, w, r, b, h0, c0

    # -- API (libxsmm_dnn_rnncell_execute_st analog) ---------------------------
    def forward(self, xt, w, r, b, h0=None, c0=None):
        """xt: [T,N,C]; returns (hs [T,N,K], h_T, c_T), tensors on the
        entry points' device.  Inputs may be numpy arrays or tensors; the
        outputs are differentiable in every tensor input (autograd runs the
        backward kernel); where no input wants a gradient, or grad mode is
        off, the sequence kernel runs in its inference form.

        hs is cast to desc.out_dtype; the carried states h_T/c_T stay f32
        (the cell's internal state precision), so stacked layers can chain
        them without reconversion loss.  GRU and RNN return c0 as c_T.
        """
        args = self._inputs(xt, w, r, b, h0, c0)
        grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
        ct = self.desc.cell_type
        c_t = args[5]
        if ct == CellType.LSTM:
            hs, h_t, c_t = (_LstmCore.apply(self, *args) if grad
                            else self._lstm(*args, False)[0])
        elif ct == CellType.GRU:
            hs, h_t = (_GruCore.apply(self, *args[:5]) if grad
                       else self._gru(*args[:5], False)[0])
        else:
            hs, h_t = (_RnnCore.apply(self, *args[:5]) if grad
                       else self._rnn(*args[:5]))
        return hs.to(self._out_dt), h_t, c_t

    def forward_train(self, xt, w, r, b, h0=None, c0=None):
        """FWD that also returns the backward residuals: ((hs, h_T, c_T),
        saved), with ``saved`` laid out as the JAX package's
        (LSTM: (xt, [w; r], h0, c0, hs f32, (cs, i, g, f, o)); GRU:
        (xt, w, r, h0, hs f32, (ri, zi, gi, zr_g)); RNN: (xt, w, r, h0,
        hs f32)).  Analog of the reference handle keeping the per-step
        activations between execute(FWD) and execute(BWD/UPD)."""
        with torch.no_grad():
            xt_f, w, r, b, h0, c0 = self._inputs(xt, w, r, b, h0, c0)
            ct = self.desc.cell_type
            c_t = c0
            if ct == CellType.LSTM:
                (hs, h_t, c_t), res = self._lstm(xt_f, w, r, b, h0, c0, True)
                saved = (xt_f, torch.cat([w, r]), h0, c0, hs, res)
            elif ct == CellType.GRU:
                (hs, h_t), res = self._gru(xt_f, w, r, b, h0, True)
                saved = (xt_f, w, r, h0, hs, res)
            else:
                hs, h_t = self._rnn(xt_f, w, r, b, h0)
                saved = (xt_f, w, r, h0, hs)
        return (hs.to(self._out_dt), h_t, c_t), saved

    def backward_from_saved(self, saved, dhs):
        """Combined BWD+UPD from forward_train's residuals (no forward
        recompute): returns (dxt, dw, dr, db, dh0, dc0), dc0 zero for the
        GRU and the RNN.  Gradients flow through hs only; dhs is rounded
        through out_dtype first, as the stateless path's cast of hs does."""
        dhs = _f32(dhs, platform.device()).to(self._out_dt).float()
        with torch.no_grad():
            if self.desc.cell_type == CellType.LSTM:
                xt_f, wr, h0, c0, hs, res = saved
                c_in = xt_f.shape[2]
                return self._lstm_bwd(xt_f, wr[:c_in], wr[c_in:], h0, c0, hs,
                                      res, dhs, None, None)
            if self.desc.cell_type == CellType.GRU:
                grads = self._gru_bwd(*saved, dhs, None)
            else:
                grads = self._rnn_bwd(*saved, dhs, None)
        return (*grads, torch.zeros_like(grads[-1]))

    def backward_weight_update(self, xt, w, r, b, dhs, h0=None, c0=None):
        """Combined BWD+UPD: returns (dxt, dw, dr, db, dh0, dc0).

        Stateless: re-runs the forward to rebuild the residuals.  A
        fwd-then-bwd training step should use forward_train() /
        backward_from_saved() instead, which keep the stored activations
        between the two calls (the reference handle's contract) and skip
        the recompute.
        """
        _, saved = self.forward_train(xt, w, r, b, h0, c0)
        return self.backward_from_saved(saved, dhs)

    def execute(self, kind: Kind, **t):
        if kind == Kind.FWD:
            return self.forward(t["input"], t["weight"], t["recur_weight"],
                                t["bias"], t.get("h0"), t.get("c0"))
        if kind in (Kind.BWD, Kind.UPD):
            return self.backward_weight_update(
                t["input"], t["weight"], t["recur_weight"], t["bias"],
                t["grad_hidden"], t.get("h0"), t.get("c0"))
        raise ValueError(kind)

    @property
    def num_gates(self) -> int:
        return {CellType.LSTM: 4, CellType.GRU: 3}.get(self.desc.cell_type, 1)


def create_rnncell(desc: RnnDesc) -> RnnCell:
    """libxsmm_dnn_create_rnncell analog."""
    return RnnCell(desc)
