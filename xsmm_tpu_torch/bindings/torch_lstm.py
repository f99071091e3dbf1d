"""A PyTorch LSTM layer over the port's fused LSTM cell.

The port of ``xsmm_tpu/bindings/torch_lstm.py`` (the tf_lstm_ops analog:
the reference ships a TensorFlow custom op that routes LSTM forward and
backward through libxsmm's rnncell handles and validates against the host
framework's own LSTM):

* ``XsmmLSTMFunction`` — a ``torch.autograd.Function`` whose forward runs
  the cell's ``forward_train`` (the LSTM sequence kernel in its train form)
  and keeps the residuals, and whose backward runs ``backward_from_saved``
  (the LSTM backward kernel and the flat dx/dw/dr products).
* ``XsmmLSTM`` — an ``nn.Module`` with parameters w [C, 4K], r [K, 4K],
  b [4K], gate order (i, c, f, o): the rnncell layout.
* ``from_torch_lstm`` — a single-layer ``torch.nn.LSTM``'s weights (w_ih
  [4K, C], gate order i, f, g, o, two bias vectors) in that layout, the
  weight shuffle the TF op does on its inputs.

Unlike the JAX binding, nothing crosses through numpy: the tensors stay on
the entry points' device (the card, or the CPU with ``target="cpu"``), and
a tensor on another device is refused.
"""

from __future__ import annotations

import functools
import math

import torch

from ..core import platform
from ..dnn.rnncell import create_rnncell
from ..dnn.types import CellType, RnnDesc


@functools.lru_cache(maxsize=64)
def _cell(t: int, n: int, c: int, k: int):
    # memoised, as the TF op caches its handle: one cell per shape, reused
    # across training steps
    return create_rnncell(RnnDesc(n=n, c=c, k=k, max_t=t,
                                  cell_type=CellType.LSTM))


class XsmmLSTMFunction(torch.autograd.Function):
    """LSTM forward and backward through the port's cell:
    (xt [T,N,C], w, r, b, h0 [N,K], c0 [N,K]) -> (hs, h_T, c_T)."""

    @staticmethod
    def forward(ctx, xt, w, r, b, h0, c0):
        dev = platform.device()
        for name, x in zip(("xt", "w", "r", "b", "h0", "c0"),
                           (xt, w, r, b, h0, c0)):
            if x.device != dev:
                raise ValueError(f"XsmmLSTM: {name} is on {x.device}; the "
                                 f"entry points run on {dev}")
        t, n, c = xt.shape
        cell = _cell(t, n, c, r.shape[0])
        # forward_train keeps the backward residuals (the reference handle's
        # stored activations), so backward() does not re-run the forward
        (hs, h_t, c_t), saved = cell.forward_train(xt, w, r, b, h0, c0)
        ctx.cell = cell
        ctx.xsmm_saved = saved
        # the inputs too, so that autograd's version check raises if one is
        # changed in place between forward and backward
        ctx.save_for_backward(xt, w, r, b)
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        ctx.saved_tensors  # the version check
        # the reference TF op differentiates through hs only: a nonzero
        # gradient of the final cell state raises rather than being dropped
        if dc_t is not None and bool((dc_t != 0).any()):
            raise NotImplementedError(
                "XsmmLSTM: gradients w.r.t. the final cell state c_T are not "
                "supported; build the loss from hs/h_T only (the reference "
                "TF op differentiates through hs)")
        # h_T is hs[-1]: its gradient folds into the last step's
        dhs = dhs.clone()
        if dh_t is not None:
            dhs[-1] += dh_t
        return ctx.cell.backward_from_saved(ctx.xsmm_saved, dhs)


class XsmmLSTM(torch.nn.Module):
    """A fused single-layer LSTM over the port's cell.

    Parameters w [C, 4K], r [K, 4K], b [4K] on the entry points' device,
    gate order (i, c, f, o); w and r drawn uniformly from +-1/sqrt(K) by a
    ``torch.Generator`` seeded with ``seed`` (on the CPU, then moved), b
    zero.
    """

    def __init__(self, input_size: int, hidden_size: int, seed: int = 0):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = torch.Generator().manual_seed(seed)
        s = 1.0 / math.sqrt(hidden_size)
        dev = platform.device()

        def param(*shape):
            x = torch.empty(shape).uniform_(-s, s, generator=g)
            return torch.nn.Parameter(x.to(dev))
        self.w = param(input_size, 4 * hidden_size)
        self.r = param(hidden_size, 4 * hidden_size)
        self.b = torch.nn.Parameter(torch.zeros(4 * hidden_size, device=dev))

    def forward(self, xt, h0=None, c0=None):
        """xt: [T, N, C] -> (hs [T, N, K], (h_T, c_T))."""
        _, n, _ = xt.shape
        shape = (n, self.hidden_size)
        h0 = torch.zeros(shape, device=xt.device) if h0 is None else h0
        c0 = torch.zeros(shape, device=xt.device) if c0 is None else c0
        hs, h_t, c_t = XsmmLSTMFunction.apply(xt, self.w, self.r, self.b,
                                              h0, c0)
        return hs, (h_t, c_t)


def from_torch_lstm(lstm: torch.nn.LSTM) -> XsmmLSTM:
    """A 1-layer ``torch.nn.LSTM`` as an ``XsmmLSTM`` (the weight shuffle).

    torch packs w_ih as [4K, C] with gate order (i, f, g, o) and two bias
    vectors; the cell packs [C, 4K] with gate order (i, c=g, f, o) and one
    bias, the reordering the reference's TF op performs on its inputs.
    """
    if lstm.num_layers != 1 or lstm.bidirectional or lstm.batch_first:
        raise ValueError("from_torch_lstm takes a single-layer, "
                         "unidirectional, sequence-first torch.nn.LSTM")
    k = lstm.hidden_size
    order = [0, 2, 1, 3]  # torch (i, f, g, o) -> the cell's (i, g, f, o)

    def regate(m):  # [4K, X] -> [X, 4K], gates reordered
        return m.reshape(4, k, -1)[order].reshape(4 * k, -1).T

    mod = XsmmLSTM(lstm.input_size, k)
    with torch.no_grad():
        mod.w.copy_(regate(lstm.weight_ih_l0))
        mod.r.copy_(regate(lstm.weight_hh_l0))
        mod.b.copy_((lstm.bias_ih_l0 + lstm.bias_hh_l0).reshape(4, k)[order]
                    .reshape(-1))
    return mod
