"""RNN / LSTM / GRU cell handles: the forward side of
``xsmm_tpu/dnn/rnncell.py``.

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

Weight layout, the JAX package's: w [C, G*K], r [K, G*K], b [G*K] with G
gates ordered (i, c, f, o) for the LSTM and (r, z, g) for the GRU.  Dtypes:
an f32 cell computes h@R in full f32; a bf16 cell stores R in bf16 and
rounds h to bf16 before the product, sums in f32, keeps the gate math in
f32 and casts hs to ``out_dtype`` at the end; x@W is full f32 in both.

The backward (kernels 16, 18 and 20 of the JAX package) is not ported yet:
``backward_weight_update``, ``backward_from_saved`` and
``execute(Kind.BWD | Kind.UPD)`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import platform
from ..core.descriptors import ITEMSIZE, TORCH_DTYPES, dtype_name
from ..ops.smm import _matmul
from .rnn_seq import ACTS, gru_seq, lstm_seq, rnn_seq, seq_kernel_ok
from .types import CellType, Kind, RnnDesc

# calls of the scan route (shapes outside the kernels' envelope), by cell
scan_calls: Dict[str, int] = {"lstm": 0, "gru": 0, "rnn": 0}

_ACTS = {CellType.RNN_RELU: "relu", CellType.RNN_SIGMOID: "sigmoid",
         CellType.RNN_TANH: "tanh"}

_BACKWARD = ("the RNN backward (BWD/UPD) is not ported yet: it comes with "
             "the next slice, kernels 16, 18 and 20 of xsmm_tpu/dnn/rnn_seq.py")


def reset_scan_calls() -> None:
    for name in scan_calls:
        scan_calls[name] = 0


def _f32(x, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous f32 tensor on ``dev``."""
    return torch.as_tensor(x).to(dev, torch.float32).contiguous()


def rnn_params_from_numpy(w, r, b, *, device=None):
    """The JAX package's cell parameters (numpy arrays: w [C, G*K],
    r [K, G*K], b [G*K]) as the port's f32 tensors on ``device`` (default:
    the entry points' device)."""
    dev = platform.device() if device is None else torch.device(device)
    return tuple(_f32(np.asarray(v), dev) for v in (w, r, b))


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
            zx = (_matmul(xt_f.reshape(t_ * n_, c_in), w) + b
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
        zx = (_matmul(xt_f.reshape(t_ * n_, c_in), w) + b
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
        zx = (_matmul(xt_f.reshape(t_ * n_, c_in), w) + b
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

    def _run(self, xt, w, r, b, h0, c0, train):
        """((hs[out_dtype], h_T, c_T), saved), saved laid out as the JAX
        package's custom-vjp residuals (None unless ``train``)."""
        d = self.desc
        dev = platform.device()
        xt_f, w, r, b = (_f32(v, dev) for v in (xt, w, r, b))
        h0 = (_f32(h0, dev) if h0 is not None
              else torch.zeros((d.n, d.k), device=dev))
        c0 = (_f32(c0, dev) if c0 is not None else torch.zeros_like(h0))
        saved = None
        if d.cell_type == CellType.LSTM:
            (hs, h_t, c_t), res = self._lstm(xt_f, w, r, b, h0, c0, train)
            if train:
                saved = (xt_f, torch.cat([w, r]), h0, c0, hs, res)
        elif d.cell_type == CellType.GRU:
            (hs, h_t), res = self._gru(xt_f, w, r, b, h0, train)
            c_t = c0
            if train:
                saved = (xt_f, w, r, h0, hs, res)
        else:
            hs, h_t = self._rnn(xt_f, w, r, b, h0)
            c_t = c0
            if train:
                saved = (xt_f, w, r, h0, hs)
        return (hs.to(self._out_dt), h_t, c_t), saved

    # -- API (libxsmm_dnn_rnncell_execute_st analog) ---------------------------
    def forward(self, xt, w, r, b, h0=None, c0=None):
        """xt: [T,N,C]; returns (hs [T,N,K], h_T, c_T), tensors on the
        entry points' device.  Inputs may be numpy arrays or tensors.

        hs is cast to desc.out_dtype; the carried states h_T/c_T stay f32
        (the cell's internal state precision), so stacked layers can chain
        them without reconversion loss.  GRU and RNN return c0 as c_T.
        """
        return self._run(xt, w, r, b, h0, c0, train=False)[0]

    def forward_train(self, xt, w, r, b, h0=None, c0=None):
        """FWD that also returns the backward residuals: ((hs, h_T, c_T),
        saved), with ``saved`` laid out as the JAX package's
        (LSTM: (xt, [w; r], h0, c0, hs f32, (cs, i, g, f, o)); GRU:
        (xt, w, r, h0, hs f32, (ri, zi, gi, zr_g)); RNN: (xt, w, r, h0,
        hs f32)).  Analog of the reference handle keeping the per-step
        activations between execute(FWD) and execute(BWD/UPD)."""
        return self._run(xt, w, r, b, h0, c0, train=True)

    def backward_weight_update(self, xt, w, r, b, dhs, h0=None, c0=None):
        raise NotImplementedError(_BACKWARD)

    def backward_from_saved(self, saved, dhs):
        raise NotImplementedError(_BACKWARD)

    def execute(self, kind: Kind, **t):
        if kind == Kind.FWD:
            return self.forward(t["input"], t["weight"], t["recur_weight"],
                                t["bias"], t.get("h0"), t.get("c0"))
        if kind in (Kind.BWD, Kind.UPD):
            raise NotImplementedError(_BACKWARD)
        raise ValueError(kind)

    @property
    def num_gates(self) -> int:
        return {CellType.LSTM: 4, CellType.GRU: 3}.get(self.desc.cell_type, 1)


def create_rnncell(desc: RnnDesc) -> RnnCell:
    """libxsmm_dnn_create_rnncell analog."""
    return RnnCell(desc)
