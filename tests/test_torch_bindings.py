"""xsmm_tpu_torch.bindings (XsmmLSTM over the port's cell) against
torch.nn.LSTM: the three tests of tests/test_bindings.py at their
tolerances, on the CPU target, and the binding's refusals."""

import dataclasses

import numpy as np
import pytest
import torch

import xsmm_tpu_torch as xp
from xsmm_tpu_torch.bindings import XsmmLSTM, XsmmLSTMFunction, from_torch_lstm
from xsmm_tpu_torch.dnn import rnn_seq as rs
from xsmm_tpu_torch.dnn import rnncell


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    rnncell.reset_scan_calls()
    torch.manual_seed(0)
    yield
    xp.set_config(**saved)


def _ref_lstm(c=6, k=8, seed=0):
    torch.manual_seed(seed)
    return torch.nn.LSTM(c, k, num_layers=1, batch_first=False)


def test_forward_matches_torch():
    t, n, c, k = 5, 4, 6, 8
    ref = _ref_lstm(c, k)
    mod = from_torch_lstm(ref)
    x = torch.randn(t, n, c)
    hs_ref, (h_ref, c_ref) = ref(x)
    hs, (h_t, c_t) = mod(x)
    for got, want in ((hs, hs_ref), (h_t, h_ref[0]), (c_t, c_ref[0])):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_backward_matches_torch():
    t, n, c, k = 4, 3, 5, 7
    ref = _ref_lstm(c, k)
    mod = from_torch_lstm(ref)
    x = torch.randn(t, n, c)

    x_ref = x.clone().requires_grad_()
    hs_ref, _ = ref(x_ref)
    hs_ref.sum().backward()

    x_mine = x.clone().requires_grad_()
    hs, _ = mod(x_mine)
    hs.sum().backward()

    np.testing.assert_allclose(x_mine.grad.numpy(), x_ref.grad.numpy(),
                               rtol=1e-3, atol=1e-4)
    # weight grads: torch's shuffled into the cell's layout
    order = [0, 2, 1, 3]
    gw_ref = (ref.weight_ih_l0.grad.reshape(4, k, -1)[order]
              .reshape(4 * k, -1).T)
    np.testing.assert_allclose(mod.w.grad.numpy(), gw_ref.numpy(),
                               rtol=1e-3, atol=1e-4)
    gr_ref = (ref.weight_hh_l0.grad.reshape(4, k, -1)[order]
              .reshape(4 * k, -1).T)
    np.testing.assert_allclose(mod.r.grad.numpy(), gr_ref.numpy(),
                               rtol=1e-3, atol=1e-4)
    gb_ref = ref.bias_ih_l0.grad.reshape(4, k)[order].reshape(-1)
    np.testing.assert_allclose(mod.b.grad.numpy(), gb_ref.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_module_trains():
    mod = XsmmLSTM(input_size=6, hidden_size=8)
    opt = torch.optim.SGD(mod.parameters(), lr=0.5)
    x = torch.randn(5, 4, 6)
    target = torch.randn(5, 4, 8)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        hs, _ = mod(x)
        loss = ((hs - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], losses


def test_h_t_gradient_folds_into_the_last_step():
    """A loss on h_T gives the gradients of the same loss on hs[-1]; the
    backward runs the cell's backward_from_saved (no scan route)."""
    ref = _ref_lstm(5, 6)
    x = torch.randn(3, 2, 5)
    grads = []
    for use_h_t in (True, False):
        mod = from_torch_lstm(ref)
        hs, (h_t, _) = mod(x)
        (h_t if use_h_t else hs[-1]).pow(2).sum().backward()
        grads.append([p.grad for p in mod.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    assert rnncell.bwd_scan_calls == dict.fromkeys(rnncell.bwd_scan_calls, 0)
    assert rs.bwd_launches == dict.fromkeys(rs.bwd_launches, 0)  # the CPU


def test_nonzero_dc_t_raises():
    """As the JAX binding: a gradient of the final cell state is refused,
    not dropped; a zero one is fine."""
    mod = XsmmLSTM(input_size=4, hidden_size=5, seed=1)
    x = torch.randn(3, 2, 4)
    hs, (_, c_t) = mod(x)
    with pytest.raises(NotImplementedError, match="final cell state"):
        (hs.sum() + c_t.sum()).backward()
    hs, (_, c_t) = mod(x)
    (hs.sum() + 0 * c_t.sum()).backward()
    assert mod.w.grad is not None


def test_module_parameters_and_seed():
    """A real nn.Module: w, r and b are its Parameters, drawn from an
    explicit generator (the same seed gives the same weights, within
    +-1/sqrt(K)); b starts at zero."""
    a, b = XsmmLSTM(6, 8, seed=3), XsmmLSTM(6, 8, seed=3)
    assert isinstance(a, torch.nn.Module)
    assert [n for n, _ in a.named_parameters()] == ["w", "r", "b"]
    assert tuple(a.w.shape) == (6, 32) and tuple(a.r.shape) == (8, 32)
    assert torch.equal(a.w, b.w) and torch.equal(a.r, b.r)
    assert not torch.equal(a.w, XsmmLSTM(6, 8, seed=4).w)
    assert a.w.abs().max() <= 8 ** -0.5 and not a.b.any()


def test_function_refuses_another_device(monkeypatch):
    """The tensors stay on the entry points' device: one elsewhere is
    refused, not copied."""
    mod = XsmmLSTM(4, 5)
    x = torch.randn(2, 3, 4)
    monkeypatch.setattr(xp.platform, "device",
                        lambda: torch.device("meta"))
    with pytest.raises(ValueError, match="entry points run on meta"):
        XsmmLSTMFunction.apply(x, mod.w, mod.r, mod.b, torch.zeros(3, 5),
                               torch.zeros(3, 5))


def test_from_torch_lstm_refuses_stacked():
    with pytest.raises(ValueError, match="single-layer"):
        from_torch_lstm(torch.nn.LSTM(4, 5, num_layers=2))


def test_matches_the_jax_binding():
    """The same seed gives the JAX binding's parameters, and the same
    outputs and gradients (1e-5): the port's cell against the JAX cell."""
    from xsmm_tpu.bindings import XsmmLSTM as JXsmmLSTM
    mine, theirs = XsmmLSTM(5, 6, seed=7), JXsmmLSTM(5, 6, seed=7)
    for p, q in zip(mine.parameters(), theirs.parameters()):
        assert torch.equal(p.detach(), q.detach())
    x = torch.randn(4, 3, 5)
    outs = []
    for mod in (mine, theirs):
        xs = x.clone().requires_grad_()
        hs, (h_t, _) = mod(xs)
        (hs.pow(2).sum() + h_t.sum()).backward()
        outs.append([hs.detach(), xs.grad] + [p.grad for p in
                                              mod.parameters()])
    for a, b in zip(*outs):
        assert (torch.linalg.vector_norm(a - b)
                <= 1e-5 * torch.linalg.vector_norm(b))
