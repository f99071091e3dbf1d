"""xsmm_tpu_torch's RNN forward path (dnn/rnn_seq, dnn/rnncell) against
xsmm_tpu's and numpy f64.

Each test makes its inputs with numpy from a seed and feeds them to the JAX
function and to its port counterpart.  The JAX package runs as
``tests/test_dnn.py`` runs it on the CPU: in interpret mode, which takes its
``rnn_seq`` Pallas kernels.  The port runs with ``target="cpu"``, i.e.
through the kernels' plain PyTorch versions.  Tolerances (rel-Frobenius):
1e-5 on every f32 output (the two sum h@R in other orders); 1e-2 on a bf16
cell's hs (bf16 holds ~3 digits, and the rounding of h to bf16 can flip at
other points); the gates of ``tests/test_dnn.py`` (1e-3, bf16 5e-2) against
gold.  Shapes stay small (T <= 5, K <= 16).
"""

import dataclasses
import enum
import re

import jax
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.dnn import CellType as JCellType
from xsmm_tpu.dnn import RnnDesc as JRnnDesc
from xsmm_tpu.dnn import create_rnncell as jcreate_rnncell
from xsmm_tpu.dnn import rnn_seq as jrs
from xsmm_tpu_torch import dnn
from xsmm_tpu_torch.dnn import CellType, Kind, RnnDesc, create_rnncell
from xsmm_tpu_torch.dnn import rnn_seq as rs
from xsmm_tpu_torch.dnn import rnncell

TOL = 1e-3       # tests/test_dnn.py's gate against gold
PARITY = 1e-5    # port against the JAX package, f32 outputs
BF16_HS = 1e-2   # port against the JAX package, a bf16 cell's hs
GATES = {CellType.LSTM: 4, CellType.GRU: 3}
ACTS = {"relu": jax.nn.relu, "sigmoid": jax.nn.sigmoid, "tanh": jax.numpy.tanh}


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    rs.reset_launches()
    rnncell.reset_scan_calls()
    yield
    xp.set_config(**saved)


def _np(x):
    return (x.double().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float64))


def _rel(want, got):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    assert np.isfinite(got).all()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _close(want, got, tol, what=""):
    err = _rel(want, got)
    assert err <= tol, f"{what}: rel-Frobenius {err:.3e} > {tol:g}"


def _seq_inputs(seed, t, n, k, gates):
    rng = np.random.default_rng(seed)
    zx = rng.standard_normal((t, n, gates * k)).astype(np.float32)
    r = (rng.standard_normal((k, gates * k)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((n, k)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((n, k)) * 0.5).astype(np.float32)
    return zx, r, h0, c0


def _r_pair(r, r_dt):
    """R for both packages in the dtype of the test: the JAX array and the
    torch tensor hold the same bf16 values."""
    if r_dt == "float32":
        return jax.numpy.asarray(r), torch.from_numpy(r)
    rt = torch.from_numpy(r).to(torch.bfloat16)
    return jax.numpy.asarray(r).astype(jax.numpy.bfloat16), rt


def _prec(r_dt):
    return jax.lax.Precision.HIGHEST if r_dt == "float32" else None


def _cell_inputs(seed, ct, t, n, c, k, scale=0.3):
    g = GATES.get(ct, 1)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, c)).astype(np.float32)
    w = (rng.standard_normal((c, g * k)) * scale).astype(np.float32)
    r = (rng.standard_normal((k, g * k)) * scale).astype(np.float32)
    b = rng.standard_normal((g * k,)).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32)
    c0 = rng.standard_normal((n, k)).astype(np.float32)
    return x, w, r, b, h0, c0


def _cells(ct, dt, n, c, k, t):
    kw = dict(n=n, c=c, k=k, max_t=t, in_dtype=dt, out_dtype=dt)
    return (jcreate_rnncell(JRnnDesc(cell_type=JCellType(ct.value), **kw)),
            create_rnncell(RnnDesc(cell_type=ct, **kw)))


def lstm_gold(xt_, w, r, b, h0, c0, k):
    """tests/test_dnn.py:323-336."""
    h, c = h0.astype(np.float64), c0.astype(np.float64)
    w, r, b = (np.asarray(v, np.float64) for v in (w, r, b))
    hs = []
    sig = lambda z: 1 / (1 + np.exp(-z))
    for t in range(xt_.shape[0]):
        z = xt_[t].astype(np.float64) @ w + h @ r + b
        i, g = sig(z[:, :k]), np.tanh(z[:, k:2 * k])
        f, o = sig(z[:, 2 * k:3 * k]), sig(z[:, 3 * k:])
        c = f * c + i * g
        h = o * np.tanh(c)
        hs.append(h)
    return np.stack(hs), h, c


def gru_gold(xt_, w, r, b, h0, k):
    """The recurrence of tests/test_dnn.py:603-614, in f64."""
    sig = lambda z: 1 / (1 + np.exp(-z))
    w, r, b = (np.asarray(v, np.float64) for v in (w, r, b))
    h = h0.astype(np.float64)
    hs = []
    for t in range(xt_.shape[0]):
        zx = xt_[t].astype(np.float64) @ w + b
        zr = h @ r
        ri = sig(zx[:, :k] + zr[:, :k])
        zi = sig(zx[:, k:2 * k] + zr[:, k:2 * k])
        gi = np.tanh(zx[:, 2 * k:] + ri * zr[:, 2 * k:])
        h = (1 - zi) * gi + zi * h
        hs.append(h)
    return np.stack(hs)


# ---------------------------------------------------------------------------
# Kernel parity: each sequence kernel's port against xsmm_tpu.dnn.rnn_seq
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("t,n,k", [(4, 8, 12), (1, 3, 5)])
def test_lstm_seq_matches_jax(r_dt, train, t, n, k):
    zx, r, h0, c0 = _seq_inputs(1, t, n, k, 4)
    jr, pr = _r_pair(r, r_dt)
    want = jrs.lstm_seq(jax.numpy.asarray(zx), jr, jax.numpy.asarray(h0),
                        jax.numpy.asarray(c0), k=k, prec=_prec(r_dt),
                        train=train)
    got = rs.lstm_seq(torch.from_numpy(zx), pr, torch.from_numpy(h0),
                      torch.from_numpy(c0), train=train)
    assert len(got) == len(want) == (8 if train else 3)
    for name, w_, g_ in zip(("hs", "h_T", "c_T", "cs", "i", "g", "f", "o"),
                            want, got):
        assert g_.dtype == torch.float32
        _close(w_, g_, PARITY, f"lstm_seq {r_dt} {name}")
    assert rs.launches == {"lstm_seq": 0, "gru_seq": 0, "rnn_seq": 0}


@pytest.mark.parametrize("r_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("t,n,k", [(4, 8, 12), (1, 3, 5)])
def test_gru_seq_matches_jax(r_dt, train, t, n, k):
    zx, r, h0, _ = _seq_inputs(2, t, n, k, 3)
    jr, pr = _r_pair(r, r_dt)
    want = jrs.gru_seq(jax.numpy.asarray(zx), jr, jax.numpy.asarray(h0), k=k,
                       prec=_prec(r_dt), train=train)
    got = rs.gru_seq(torch.from_numpy(zx), pr, torch.from_numpy(h0),
                     train=train)
    assert len(got) == len(want) == (6 if train else 2)
    for name, w_, g_ in zip(("hs", "h_T", "ri", "zi", "gi", "zr_g"), want,
                            got):
        _close(w_, g_, PARITY, f"gru_seq {r_dt} {name}")


@pytest.mark.parametrize("r_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh"])
def test_rnn_seq_matches_jax(r_dt, act):
    t, n, k = 5, 8, 16
    zx, r, h0, _ = _seq_inputs(3, t, n, k, 1)
    jr, pr = _r_pair(r, r_dt)
    want = jrs.rnn_seq(jax.numpy.asarray(zx), jr, jax.numpy.asarray(h0), k=k,
                       prec=_prec(r_dt), act=ACTS[act])
    got = rs.rnn_seq(torch.from_numpy(zx), pr, torch.from_numpy(h0), act=act)
    assert len(got) == len(want) == 2
    for name, w_, g_ in zip(("hs", "h_T"), want, got):
        _close(w_, g_, PARITY, f"rnn_seq {act} {r_dt} {name}")


def test_seq_kernels_match_f64_gold():
    """The plain versions against the recurrences in f64 (f32 R)."""
    t, n, k = 5, 6, 7
    sig = lambda z: 1 / (1 + np.exp(-z))
    zx, r, h0, c0 = _seq_inputs(4, t, n, k, 4)
    hs, h_t, c_t = rs.lstm_seq(*map(torch.from_numpy, (zx, r, h0, c0)),
                               train=False)
    gold = lstm_gold(zx, np.eye(4 * k, dtype=np.float32), r,
                     np.zeros(4 * k), h0, c0, k)
    for w_, g_ in zip(gold, (hs, h_t, c_t)):
        _close(w_, g_, PARITY, "lstm_seq vs gold")
    zx, r, h0, _ = _seq_inputs(5, t, n, k, 1)
    hs, h_t = rs.rnn_seq(*map(torch.from_numpy, (zx, r, h0)), act="sigmoid")
    h = h0.astype(np.float64)
    for ti in range(t):
        h = sig(zx[ti] + h @ r)
    _close(h, h_t, PARITY, "rnn_seq sigmoid vs gold")
    _close(h, hs[-1], PARITY, "rnn_seq sigmoid vs gold")


def test_bf16_product_is_exact_products_in_k_order():
    """The plain bf16 product rounds h to bf16 and sums the exact products
    in f32 in k order: the same bits as a k-order loop in f64 rounded to f32
    after every step."""
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.standard_normal((5, 9)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32)
                         ).to(torch.bfloat16)
    got = rs._hr(h, r.float(), True)
    hb = h.to(torch.bfloat16).double().numpy()
    rb = r.double().numpy()
    acc = np.zeros((5, 7), np.float32)
    for k in range(9):
        acc = (acc.astype(np.float64) + hb[:, k:k + 1] * rb[k]).astype(
            np.float32)
    np.testing.assert_array_equal(got.numpy(), acc)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "c0", "act",
                                 "empty"])
def test_seq_wrappers_check_inputs(bad):
    zx, r, h0, c0 = map(torch.from_numpy, _seq_inputs(7, 3, 4, 5, 4))
    if bad == "dtype":
        with pytest.raises(ValueError, match="dtype"):
            rs.lstm_seq(zx.double(), r, h0, c0, train=False)
        with pytest.raises(ValueError, match="dtype"):
            rs.gru_seq(zx[:, :, :15].contiguous(),
                       r[:, :15].contiguous().half(), h0, train=False)
    elif bad == "shape":
        with pytest.raises(ValueError, match="shapes disagree"):
            rs.gru_seq(zx, r, h0, train=False)       # 4K columns, 3 gates
        with pytest.raises(ValueError, match="shapes disagree"):
            rs.lstm_seq(zx, r, h0[:3], c0, train=False)
    elif bad == "contiguous":
        with pytest.raises(ValueError, match="contiguous"):
            rs.lstm_seq(zx, r.t().contiguous().t(), h0, c0, train=False)
    elif bad == "c0":
        with pytest.raises(ValueError, match="c0"):
            rs.lstm_seq(zx, r, h0, c0[:, :4], train=True)
    elif bad == "act":
        with pytest.raises(ValueError, match="act"):
            rs.rnn_seq(zx[:, :, :5].contiguous(), r[:, :5].contiguous(), h0,
                       act="gelu")
    else:
        with pytest.raises(ValueError, match="shapes disagree"):
            rs.rnn_seq(zx[:0, :, :5].contiguous(), r[:, :5].contiguous(),
                       h0, act="tanh")
    assert rs.launches == {"lstm_seq": 0, "gru_seq": 0, "rnn_seq": 0}


# ---------------------------------------------------------------------------
# Cell parity: RnnCell.forward / forward_train against the JAX cell's
# ---------------------------------------------------------------------------


def _check_outputs(want, got, dt, what):
    (jhs, jht, jct), (phs, pht, pct) = want, got
    if dt == "bfloat16":
        assert phs.dtype == torch.bfloat16
        _close(np.asarray(jhs, np.float64), phs, BF16_HS, f"{what} hs")
    else:
        assert phs.dtype == torch.float32
        _close(jhs, phs, PARITY, f"{what} hs")
    assert pht.dtype == pct.dtype == torch.float32
    tol = PARITY if dt == "float32" else BF16_HS
    _close(jht, pht, tol, f"{what} h_T")
    _close(jct, pct, tol, f"{what} c_T")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("ct", list(CellType))
def test_cell_forward_matches_jax(ct, dt):
    n, c, k, t = 5, 7, 6, 4
    x, w, r, b, h0, c0 = _cell_inputs(10, ct, t, n, c, k)
    jcell, pcell = _cells(ct, dt, n, c, k, t)
    want = jcell.forward(x, w, r, b, h0, c0)
    got = pcell.forward(x, w, r, b, h0, c0)
    _check_outputs(want, got, dt, f"{ct.value} {dt} forward")
    # the defaults: h0 = c0 = 0
    _check_outputs(jcell.forward(x, w, r, b), pcell.forward(x, w, r, b), dt,
                   f"{ct.value} {dt} forward h0=c0=0")
    assert rnncell.scan_calls == {"lstm": 0, "gru": 0, "rnn": 0}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("ct", list(CellType))
def test_cell_forward_train_matches_jax(ct, dt):
    n, c, k, t = 4, 6, 5, 3
    x, w, r, b, h0, c0 = _cell_inputs(11, ct, t, n, c, k)
    jcell, pcell = _cells(ct, dt, n, c, k, t)
    jout, jsaved = jcell.forward_train(x, w, r, b, h0, c0)
    pout, psaved = pcell.forward_train(x, w, r, b, h0, c0)
    _check_outputs(jout, pout, dt, f"{ct.value} {dt} forward_train")
    jleaves = jax.tree_util.tree_leaves(jsaved)
    pleaves = jax.tree_util.tree_leaves(psaved)   # tuples of tensors
    assert len(jleaves) == len(pleaves) == {CellType.LSTM: 10,
                                            CellType.GRU: 9}.get(ct, 5)
    for i, (a, p) in enumerate(zip(jleaves, pleaves)):
        assert tuple(np.shape(a)) == tuple(p.shape), i
        assert p.dtype == torch.float32, i
        _close(a, p, PARITY if dt == "float32" else BF16_HS,
               f"{ct.value} {dt} saved[{i}]")


# ---------------------------------------------------------------------------
# Mirrors of the forward side of the RNN cases of tests/test_dnn.py
# ---------------------------------------------------------------------------


def test_lstm_forward(rng):
    n, c_, k, t = 8, 10, 12, 5
    cell = create_rnncell(RnnDesc(n=n, c=c_, k=k, max_t=t,
                                  cell_type=CellType.LSTM))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, 4 * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, 4 * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((4 * k,)).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32)
    c0 = rng.standard_normal((n, k)).astype(np.float32)
    hs, hT, cT = cell.forward(xt_, w, r, b, h0, c0)
    ghs, gh, gc = lstm_gold(xt_, w, r, b, h0, c0, k)
    xt.check(ghs, hs.numpy(), TOL, what="lstm seq")
    xt.check(gc, cT.numpy(), TOL, what="lstm cell state")
    xt.check(gh, hT.numpy(), TOL, what="lstm h_T")


def test_lstm_bf16(rng):
    """bf16 cell (bf16 R, f32 sums and gate math) vs f32 gold, loose tol."""
    n, c_, k, t = 8, 10, 12, 5
    cell = create_rnncell(RnnDesc(n=n, c=c_, k=k, max_t=t,
                                  cell_type=CellType.LSTM,
                                  in_dtype="bfloat16", out_dtype="bfloat16"))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, 4 * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, 4 * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((4 * k,)).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32)
    c0 = rng.standard_normal((n, k)).astype(np.float32)
    hs, hT, cT = cell.forward(xt_, w, r, b, h0, c0)
    assert hs.dtype == torch.bfloat16
    assert hT.dtype == cT.dtype == torch.float32
    ghs, _, _ = lstm_gold(xt_, w, r, b, h0, c0, k)
    xt.check(ghs, hs.double().numpy(), 5e-2, what="lstm bf16 seq")


@pytest.mark.parametrize("ct", [CellType.RNN_RELU, CellType.RNN_TANH,
                                CellType.GRU])
def test_other_cells_run(rng, ct):
    n, c_, k, t = 4, 6, 5, 3
    g = GATES.get(ct, 1)
    cell = create_rnncell(RnnDesc(n=n, c=c_, k=k, max_t=t, cell_type=ct))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, g * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, g * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((g * k,)).astype(np.float32)
    hs, hT, cT = cell.forward(xt_, w, r, b)
    assert tuple(hs.shape) == (t, n, k)
    assert torch.isfinite(hs).all()
    assert torch.equal(cT, torch.zeros((n, k)))   # c0 passes through


def test_rnn_tanh_matches_gold(rng):
    n, c_, k, t = 4, 5, 6, 4
    cell = create_rnncell(RnnDesc(n=n, c=c_, k=k, max_t=t,
                                  cell_type=CellType.RNN_TANH))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, k)) * 0.4).astype(np.float32)
    r = (rng.standard_normal((k, k)) * 0.4).astype(np.float32)
    b = rng.standard_normal((k,)).astype(np.float32)
    hs, _, _ = cell.forward(xt_, w, r, b)
    h = np.zeros((n, k))
    for tt in range(t):
        h = np.tanh(xt_[tt].astype(np.float64) @ w + h @ r + b)
    xt.check(h, hs.numpy()[-1], TOL)


def test_gru_forward_matches_gold(rng):
    """The forward half of test_gru_bwd_matches_autodiff_gold."""
    n, c_, k, t = 4, 6, 5, 3
    cell = create_rnncell(RnnDesc(n=n, c=c_, k=k, max_t=t,
                                  cell_type=CellType.GRU))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, 3 * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, 3 * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((3 * k,)).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32)
    hs, _, _ = cell.forward(xt_, w, r, b, h0)
    xt.check(gru_gold(xt_, w, r, b, h0, k), hs.numpy(), TOL, what="gru fwd")


@pytest.mark.parametrize("ct,out_dt", [
    (CellType.LSTM, "float32"), (CellType.GRU, "float32"),
    (CellType.RNN_TANH, "float32"), (CellType.LSTM, "bfloat16")])
def test_rnn_saved_residual_forward_matches_stateless(rng, ct, out_dt):
    """The forward half of test_rnn_saved_residual_path_matches_stateless:
    forward_train's outputs equal forward's."""
    n, c_, k, t = 4, 6, 5, 3
    g = GATES.get(ct, 1)
    cell = create_rnncell(RnnDesc(n=n, c=c_, k=k, max_t=t, cell_type=ct,
                                  in_dtype=out_dt, out_dtype=out_dt))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, g * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, g * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((g * k,)).astype(np.float32)
    (hs, h_t, c_t), saved = cell.forward_train(xt_, w, r, b)
    hs2, h_t2, c_t2 = cell.forward(xt_, w, r, b)
    np.testing.assert_allclose(hs.float().numpy(), hs2.float().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h_t.numpy(), h_t2.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), c_t2.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert saved is not None


@pytest.mark.parametrize("ct", [CellType.LSTM, CellType.GRU,
                                CellType.RNN_TANH])
def test_rnn_scan_route_matches_kernel_route(rng, ct, monkeypatch):
    """The forward half of test_rnn_scan_fallback_matches_pallas: the scan
    route (taken where seq_kernel_ok is False) agrees with the kernel route
    that the CPU target takes by default."""
    n, c_, k, t = 8, 10, 12, 4
    g = GATES.get(ct, 1)
    d = RnnDesc(n=n, c=c_, k=k, max_t=t, cell_type=ct)
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, g * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, g * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((g * k,)).astype(np.float32)

    def run():
        cell = create_rnncell(d)
        (hs, h_t, c_t), saved = cell.forward_train(xt_, w, r, b)
        res = list(saved[-1]) if ct != CellType.RNN_TANH else []
        return [hs, h_t, c_t] + res

    kernel_out = run()
    assert sum(rnncell.scan_calls.values()) == 0
    monkeypatch.setattr(rnncell, "seq_kernel_ok", lambda *a: False)
    scan_out = run()
    assert sum(rnncell.scan_calls.values()) == 1
    assert len(kernel_out) == len(scan_out)
    for a, bb in zip(kernel_out, scan_out):
        _close(a, bb, 1e-4, f"{ct} scan-vs-kernel")


# ---------------------------------------------------------------------------
# Routing and errors
# ---------------------------------------------------------------------------


def test_cpu_counts_no_launch():
    x, w, r, b, h0, c0 = _cell_inputs(12, CellType.LSTM, 3, 4, 5, 6)
    for ct in CellType:
        g = GATES.get(ct, 1)
        cell = create_rnncell(RnnDesc(n=4, c=5, k=6, max_t=3, cell_type=ct))
        cell.forward(x, w[:, :g * 6], r[:, :g * 6], b[:g * 6], h0, c0)
        cell.forward_train(x, w[:, :g * 6], r[:, :g * 6], b[:g * 6])
    assert rs.launches == {"lstm_seq": 0, "gru_seq": 0, "rnn_seq": 0}
    assert rs.train_launches == {"lstm_seq": 0, "gru_seq": 0}
    assert rs.form_launches == dict.fromkeys(rs.FORMS, 0)
    assert rnncell.scan_calls == {"lstm": 0, "gru": 0, "rnn": 0}
    assert rs.seq_kernel_ok(10 ** 6, 10 ** 5, 4, 4)   # the CPU takes any shape


def test_execute_fwd_matches_forward():
    x, w, r, b, h0, c0 = _cell_inputs(14, CellType.GRU, 3, 4, 5, 6)
    cell = create_rnncell(RnnDesc(n=4, c=5, k=6, max_t=3,
                                  cell_type=CellType.GRU))
    got = cell.execute(Kind.FWD, input=x, weight=w, recur_weight=r, bias=b,
                       h0=h0)
    want = cell.forward(x, w, r, b, h0)
    for a, bb in zip(got, want):
        assert torch.equal(a, bb)
    with pytest.raises(ValueError):
        cell.execute("fwd", input=x, weight=w, recur_weight=r, bias=b)
    assert cell.num_gates == 3
    assert create_rnncell(RnnDesc(n=1, c=1, k=1, max_t=1)).num_gates == 4
    assert create_rnncell(RnnDesc(n=1, c=1, k=1, max_t=1,
                                  cell_type=CellType.RNN_RELU)).num_gates == 1


def test_no_card_without_cpu_target_raises(monkeypatch):
    x, w, r, b, _, _ = _cell_inputs(15, CellType.RNN_TANH, 2, 3, 4, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp.set_config(target="")
    cell = create_rnncell(RnnDesc(n=3, c=4, k=5, max_t=2,
                                  cell_type=CellType.RNN_TANH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cell.forward(x, w, r, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.seq_kernel_ok(3, 5, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rnncell.rnn_params_from_numpy(w, r, b)


def test_rnn_params_from_numpy_round_trip():
    _, w, r, b, _, _ = _cell_inputs(16, CellType.LSTM, 2, 3, 4, 5)
    tw, tr, tb = dnn.rnn_params_from_numpy(w, r, b)
    for a, t_ in ((w, tw), (r, tr), (b, tb)):
        assert t_.dtype == torch.float32 and t_.device.type == "cpu"
        np.testing.assert_array_equal(t_.numpy(), a)
    tw, _, _ = dnn.rnn_params_from_numpy(w.astype(np.float64), r, b,
                                         device="cpu")
    np.testing.assert_array_equal(tw.numpy(), w)


def test_cell_accepts_tensors_and_numpy_alike():
    x, w, r, b, h0, c0 = _cell_inputs(17, CellType.LSTM, 3, 4, 5, 6)
    cell = create_rnncell(RnnDesc(n=4, c=5, k=6, max_t=3))
    from_np = cell.forward(x, w, r, b, h0, c0)
    tw, tr, tb = dnn.rnn_params_from_numpy(w, r, b)
    from_t = cell.forward(torch.from_numpy(x), tw, tr, tb,
                          torch.from_numpy(h0), torch.from_numpy(c0))
    for a, bb in zip(from_np, from_t):
        assert torch.equal(a, bb)


def test_types_match_the_jax_package():
    """One RnnDesc argument list drives both packages: the same enums and
    the same dataclass fields and defaults."""
    from xsmm_tpu.dnn import types as jt
    from xsmm_tpu_torch.dnn import types as pt

    def norm(v):
        return (v.name, v.value) if isinstance(v, enum.Enum) else v

    for name in ("Kind", "Format", "FuseOp", "BnFuse", "PoolType",
                 "CellType"):
        assert ([norm(m) for m in getattr(jt, name)]
                == [norm(m) for m in getattr(pt, name)]), name
    for name in ("ConvDesc", "FCDesc", "PoolingDesc", "BnDesc", "RnnDesc"):
        assert ([(f.name, norm(f.default))
                 for f in dataclasses.fields(getattr(jt, name))]
                == [(f.name, norm(f.default))
                    for f in dataclasses.fields(getattr(pt, name))]), name


def test_seq_profile_instruments_the_source(tmp_path):
    """The card profiler (python -m xsmm_tpu_torch.dnn.seq_profile) finds
    its anchors in ops/csrc/rnn_seq.cu, the forward's (in both of its
    forms' kernels) and the backward's, and its variants rewrite one
    constant each; a ``src=`` copy without the anchors or the scratch entry
    point is timed without stamps and gets the entry point; nothing is
    built here."""
    from xsmm_tpu_torch.dnn import seq_profile as sp
    src = sp.SOURCE.read_text()
    out = sp.instrument(src)
    assert len(re.findall(r"(?<!B)STAMP\(t, \d\);", out)) == 5 * sp.FWD_FORMS
    assert len(re.findall(r"[BP]STAMP\(s, \d\);", out)) == 5
    assert "xsmm_prof_read" in out
    assert out.count("g_start[blockIdx.x * 2") == 2 * sp.FWD_FORMS + 2
    assert sp.apply_settings(src, {"PCH": 8}).count(
        "constexpr int PCH = 8;") == 1
    assert sp.sources("base") == {"plain": src, "prof": out}
    old = tmp_path / "rnn_seq.cu"
    old.write_text(src.replace("  // -- the block's partial of dh_{t-1}",
                               "  // partial").replace(
        "extern \"C\" int xsmm_rnn_seq_bwd_scratch", "int unused_scratch"))
    got = sp.sources(f"src={old}")
    assert list(got) == ["plain"]
    assert got["plain"].count("xsmm_rnn_seq_bwd_scratch(") == 1
    v = sp.apply_settings(src, sp.parse_variant("THREADS=256,RM=2,RB=8"))
    for line in ("constexpr int THREADS = 256;", "constexpr int RM = 2;",
                 "constexpr int RB = 8;"):
        assert line in v
    assert sp.parse_variant("base") == {}
    with pytest.raises(ValueError, match="NOPE"):
        sp.apply_settings(src, {"NOPE": 1})
    with pytest.raises(ValueError, match="anchor"):
        sp.instrument(src.replace("// -- the gate epilogue", "// epilogue"))
    with pytest.raises(ValueError, match="anchor"):
        sp.instrument(src.replace("  // -- the block's partial of dh_{t-1}",
                                  "  // partial"))


def _entry_params(src, name):
    """The parameters of ``extern "C" int name(...)`` in ``src``, each
    run of white space one blank."""
    head = f'extern "C" int {name}('
    assert src.count(head) == 1, name
    i = src.index(head) + len(head)
    return " ".join(src[i:src.index(")", i)].split())


@pytest.mark.parametrize("name", ["xsmm_lstm_seq", "xsmm_gru_seq",
                                  "xsmm_rnn_seq"])
def test_seq_profile_shims_a_copy_without_forms(tmp_path, name):
    """A ``src=`` copy from before the forward's forms (no form query, no
    form pointer in the forward entry points) gets each forward entry point
    with the parameters of ops/csrc/rnn_seq.cu's own, calling the copy's
    own under another name, and a form query; nothing is built here."""
    from xsmm_tpu_torch.dnn import seq_profile as sp
    src = sp.SOURCE.read_text()
    assert "int* form" in _entry_params(src, name)
    old = tmp_path / "rnn_seq.cu"
    old.write_text(src.replace("int* form, ", "").replace(
        'extern "C" int xsmm_rnn_seq_form(', "int unused_form("))
    got = sp.sources(f"src={old}")["plain"]
    assert _entry_params(got, name) == _entry_params(src, name)
    assert _entry_params(got, name + "_v0") == _entry_params(
        src, name).replace("int* form, ", "")
    assert got.count('extern "C" int xsmm_rnn_seq_form(') == 1


def test_forms_match_the_source():
    """FORMS, the wrapper's names of the forward kernel's forms, stand in
    the order of rnn_seq.cu's Form codes, which its entry points and
    xsmm_rnn_seq_form return."""
    from xsmm_tpu_torch.dnn import seq_profile as sp
    body = re.search(r"enum Form \{([^}]*)\}", sp.SOURCE.read_text()).group(1)
    codes = {name.strip(): int(code) for name, code in
             (item.split("=") for item in body.split(","))}
    assert codes == {f"FORM_{f.upper()}": i for i, f in enumerate(rs.FORMS)}
