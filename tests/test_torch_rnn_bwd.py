"""xsmm_tpu_torch's RNN training path (the backward kernels' wrappers of
dnn/rnn_seq, autograd through RnnCell.forward, backward_from_saved,
backward_weight_update, execute(BWD/UPD)) against xsmm_tpu's and gold.

Each test makes its inputs with numpy from a seed and feeds them to the JAX
function and to its port counterpart.  The JAX package runs as
``tests/test_dnn.py`` runs it on the CPU: in interpret mode, which takes its
``rnn_seq`` Pallas kernels (forward and backward).  The port runs with
``target="cpu"``, i.e. through the kernels' plain PyTorch versions.
Tolerances (rel-Frobenius): 1e-5 on every f32 output (the two sum their
products in other orders); 1e-2 on a bf16 dz and on a bf16 cell's
gradients (bf16 holds ~3 digits, and the rounding of dz to bf16 can flip at
other points); the gates of ``tests/test_dnn.py`` (1e-3) against its gold.
Shapes stay small (T <= 5, K <= 16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.dnn import CellType as JCellType
from xsmm_tpu.dnn import RnnDesc as JRnnDesc
from xsmm_tpu.dnn import create_rnncell as jcreate_rnncell
from xsmm_tpu.dnn import rnn_seq as jrs
from xsmm_tpu_torch.dnn import CellType, Kind, RnnDesc, create_rnncell
from xsmm_tpu_torch.dnn import rnn_seq as rs
from xsmm_tpu_torch.dnn import rnncell

TOL = 1e-3       # tests/test_dnn.py's gate against gold
PARITY = 1e-5    # port against the JAX package, f32 outputs
BF16 = 1e-2      # port against the JAX package, a bf16 dz or bf16 cell
GATES = {CellType.LSTM: 4, CellType.GRU: 3}
NAMES = ("dxt", "dw", "dr", "db", "dh0", "dc0")
JACT = {"relu": jax.nn.relu, "sigmoid": jax.nn.sigmoid, "tanh": jnp.tanh}
CT_ACT = {CellType.RNN_RELU: "relu", CellType.RNN_SIGMOID: "sigmoid",
          CellType.RNN_TANH: "tanh"}


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    rs.reset_launches()
    rnncell.reset_scan_calls()
    yield
    xp.set_config(**saved)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _close(want, got, tol, what=""):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert np.isfinite(got).all(), what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)
    assert err <= tol, f"{what}: rel-Frobenius {err:.3e} > {tol:g}"


def _dact(act):
    """The JAX cell's activation derivative from the output."""
    if act == "relu":
        return lambda h: (h > 0).astype(jnp.float32)
    if act == "sigmoid":
        return lambda h: h * (1.0 - h)
    return lambda h: 1.0 - h * h


# ---------------------------------------------------------------------------
# Kernel parity: each backward kernel's port against xsmm_tpu.dnn.rnn_seq
# ---------------------------------------------------------------------------


def _residuals(seed, t, n, k, gates, act="tanh"):
    """dhs, the residuals of a forward (gates in their ranges), the states
    and R^T [G*K, K], f32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    sig = lambda z: (1 / (1 + np.exp(-z))).astype(np.float32)
    dhs = f(t, n, k)
    if gates == 4:      # i, g, f, o, cs
        res = [sig(f(t, n, k)), np.tanh(f(t, n, k)), sig(f(t, n, k)),
               sig(f(t, n, k)), f(t, n, k)]
    elif gates == 3:    # ri, zi, gi, zr_g, hs
        res = [sig(f(t, n, k)), sig(f(t, n, k)), np.tanh(f(t, n, k)),
               f(t, n, k), np.tanh(f(t, n, k))]
    else:               # hs
        z = f(t, n, k)
        res = [{"relu": np.maximum(z, 0), "sigmoid": sig(z),
                "tanh": np.tanh(z)}[act]]
    states = [f(n, k) * 0.5 for _ in range(3)]
    rt = f(gates * k, k) * 0.3
    return dhs, res, states, rt


def _pair(x, dt):
    """The same values for both packages: a JAX array and a tensor in
    ``dt`` ("float32" or "bfloat16")."""
    if dt == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _dts(dz_dt):
    return ((jnp.float32, torch.float32) if dz_dt == "float32"
            else (jnp.bfloat16, torch.bfloat16))


def _check_bwd(want, got, dz_dt, names, what):
    assert len(want) == len(got) == len(names)
    for name, w_, g_ in zip(names, want, got):
        is_dz = name in ("dz", "dzx", "dgiri")
        if is_dz:
            assert g_.dtype == _dts(dz_dt)[1], name
        else:
            assert g_.dtype == torch.float32, name
        tol = BF16 if is_dz and dz_dt == "bfloat16" else PARITY
        _close(np.asarray(w_, np.float64), g_, tol, f"{what} {name}")


@pytest.mark.parametrize("r_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("dz_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,n,k", [(4, 8, 12), (1, 3, 5)])
def test_lstm_seq_bwd_matches_jax(r_dt, dz_dt, t, n, k):
    dhs, res, (c0, dht, dct), rt = _residuals(20, t, n, k, 4)
    jrt, prt = _pair(rt, r_dt)
    ops = [dhs, *res, c0, dht, dct]
    want = jrs.lstm_seq_bwd(*map(jnp.asarray, ops), jrt, k=k,
                            prec=jax.lax.Precision.HIGHEST
                            if r_dt == "float32" else None,
                            dz_dt=_dts(dz_dt)[0])
    got = rs.lstm_seq_bwd(*map(torch.from_numpy, ops), prt,
                          dz_dt=_dts(dz_dt)[1])
    _check_bwd(want, got, dz_dt, ("dz", "dh0", "dc0", "db"),
               f"lstm_seq_bwd R {r_dt} dz {dz_dt}")
    assert rs.bwd_launches == dict.fromkeys(rs.bwd_launches, 0)


@pytest.mark.parametrize("r_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("dz_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,n,k", [(4, 8, 12), (1, 3, 5)])
def test_gru_seq_bwd_matches_jax(r_dt, dz_dt, t, n, k):
    dhs, res, (h0, dht, _), rt = _residuals(21, t, n, k, 3)
    jrt, prt = _pair(rt, r_dt)
    ops = [dhs, *res, h0, dht]
    want = jrs.gru_seq_bwd(*map(jnp.asarray, ops), jrt, k=k,
                           prec=jax.lax.Precision.HIGHEST
                           if r_dt == "float32" else None,
                           dz_dt=_dts(dz_dt)[0])
    got = rs.gru_seq_bwd(*map(torch.from_numpy, ops), prt,
                         dz_dt=_dts(dz_dt)[1])
    _check_bwd(want, got, dz_dt, ("dzx", "dgiri", "dh0", "db"),
               f"gru_seq_bwd R {r_dt} dz {dz_dt}")


@pytest.mark.parametrize("r_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("dz_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh"])
def test_rnn_seq_bwd_matches_jax(r_dt, dz_dt, act):
    t, n, k = 5, 8, 16
    dhs, (hs,), (dht, _, _), rt = _residuals(22, t, n, k, 1, act)
    jrt, prt = _pair(rt, r_dt)
    want = jrs.rnn_seq_bwd(*map(jnp.asarray, (dhs, hs, dht)), jrt, k=k,
                           prec=jax.lax.Precision.HIGHEST
                           if r_dt == "float32" else None,
                           dact=_dact(act), dz_dt=_dts(dz_dt)[0])
    got = rs.rnn_seq_bwd(*map(torch.from_numpy, (dhs, hs, dht)), prt,
                         act=act, dz_dt=_dts(dz_dt)[1])
    _check_bwd(want, got, dz_dt, ("dz", "dh0", "db"),
               f"rnn_seq_bwd {act} R {r_dt} dz {dz_dt}")


def test_bwd_plain_versions_match_f64_bptt():
    """The LSTM plain version with f32 R^T against the reverse scan in f64
    (dz = the gate gradients; dh' = dz @ R^T; dc' = dc * f)."""
    t, n, k = 4, 5, 6
    dhs, res, (c0, dht, dct), rt = _residuals(23, t, n, k, 4)
    dz, dh0, dc0, db = rs.lstm_seq_bwd(*map(torch.from_numpy,
                                            (dhs, *res, c0, dht, dct, rt)))
    i, g, f, o, cs = (x.astype(np.float64) for x in res)
    dh_n, dc_n = dht.astype(np.float64), dct.astype(np.float64)
    gold = [None] * t
    for ti in reversed(range(t)):
        tc = np.tanh(cs[ti])
        cp = c0 if ti == 0 else cs[ti - 1]
        dh = dhs[ti] + dh_n
        dc = dc_n + dh * o[ti] * (1 - tc * tc)
        gold[ti] = np.concatenate(
            [dc * g[ti] * i[ti] * (1 - i[ti]), dc * i[ti] * (1 - g[ti] ** 2),
             dc * cp * f[ti] * (1 - f[ti]), dh * tc * o[ti] * (1 - o[ti])], 1)
        dh_n = gold[ti] @ rt.astype(np.float64)
        dc_n = dc * f[ti]
    gold = np.stack(gold)
    for want, got, name in ((gold, dz, "dz"), (dh_n, dh0, "dh0"),
                            (dc_n, dc0, "dc0"),
                            (gold.sum((0, 1))[None], db, "db")):
        _close(want, got, PARITY, f"lstm_seq_bwd vs f64 {name}")


def _f32_sum(a, b):
    """a + b of f32 values, rounded once to f32 (through f64, exact here)."""
    return (np.asarray(a, np.float64) + b).astype(np.float32)


def test_bwd_bf16_product_sums_in_the_kernel_order():
    """With bf16 R^T the plain product rounds dz to bf16 and sums the exact
    products in f32 in the backward kernels' order: per block of 16 units
    j0 .. j0+15 one chain over its positions g*K + j (g, then j), then the
    blocks' partials added in block order.  The same bits as that order in
    f64 rounded to f32 after every step (G 4, K 37: three blocks, the last
    of 5 units)."""
    rng = np.random.default_rng(24)
    g_, k = 4, 37
    dz = torch.from_numpy(rng.standard_normal((5, g_ * k)).astype(np.float32))
    rt = torch.from_numpy(rng.standard_normal((g_ * k, k)).astype(np.float32)
                          ).to(torch.bfloat16)
    got = rs._dz_rt(dz, rt.float(), True)
    dzb = dz.to(torch.bfloat16).double().numpy()
    rtb = rt.double().numpy()
    want = None
    for j0 in range(0, k, 16):
        part = np.zeros((5, k), np.float32)
        for g in range(g_):
            for j in range(j0, min(j0 + 16, k)):
                q = g * k + j
                part = _f32_sum(part, dzb[:, q:q + 1] * rtb[q])
        want = part if want is None else _f32_sum(want, part)
    np.testing.assert_array_equal(got.numpy(), want)


# the backward kernels' (units a block owns, rows a pass) by gate count, as
# rnn_seq.cu's BwdGeo sets them
KERNEL_GEOMETRY = {4: (16, 32), 3: (16, 32), 1: (32, 16)}


@pytest.mark.parametrize("gates,k", [(3, 7), (4, 20), (1, 5), (1, 33),
                                     (1, 70)])
def test_bwd_kernel_reduction_emulation_equals_dz_rt(gates, k):
    """The backward kernel's product as it runs (rnn_seq.cu seq_bwd): each
    column block's FMA chain over all of its G*BU positions in order, the
    positions of units past K holding zeros (dz and R^T), rows padded to a
    pass with zeros; then each block's (row, unit) adds the column blocks'
    partials in block order, the first taken as it is.  Emulated in numpy
    (f64, rounded to f32 after every step) at ragged shapes (G*K not a
    multiple of the block's positions, K below one block or past it), it
    equals ``_dz_rt`` bit for bit."""
    rng = np.random.default_rng(46 + k)
    n, units = 5, KERNEL_GEOMETRY[gates][0]
    assert rs.BWD_UNITS[gates] == units
    dz = torch.from_numpy(rng.standard_normal((n, gates * k)).astype(
        np.float32))
    rt = torch.from_numpy((rng.standard_normal((gates * k, k)) / 4).astype(
        np.float32)).to(torch.bfloat16)
    want = rs._dz_rt(dz, rt.float(), True).numpy()
    dzb = dz.to(torch.bfloat16).double().numpy()
    rtb = rt.double().numpy()
    cb = -(-k // units)
    passrows = KERNEL_GEOMETRY[gates][1]
    rows = np.zeros((passrows, gates * k))
    rows[:n] = dzb
    partials = []
    for cbi in range(cb):
        tile = np.zeros((passrows, gates * units))  # the block's dz tile
        rslice = np.zeros((gates * units, k))       # its R^T slice
        for g in range(gates):
            for u in range(units):
                j = cbi * units + u
                if j < k:
                    tile[:, g * units + u] = rows[:, g * k + j]
                    rslice[g * units + u] = rtb[g * k + j]
        acc = np.zeros((passrows, k), np.float32)
        for q in range(gates * units):              # the FMA chain
            acc = _f32_sum(acc, tile[:, q:q + 1] * rslice[q])
        partials.append(acc)
    got = partials[0]
    for part in partials[1:]:
        got = _f32_sum(got, part)
    np.testing.assert_array_equal(got[:n], want)


@pytest.mark.parametrize("n", [5, 37, 64])
def test_bwd_db_sums_in_the_kernel_order(n):
    """The plain versions sum db as the backward kernels do, whatever their
    launch plan: each step's rows by row group (a pass's rows, 16 for the
    simple RNN; the group's rows in pairs, then the pairs in order, rows
    past N zeros), each group over the steps t = T-1 .. 0, then the groups
    in order.  Emulated in numpy (f64 rounded to f32 after every step) for
    the simple RNN's plain backward at T 3, it is the same bits."""
    rng = np.random.default_rng(47 + n)
    t, k = 3, 6
    dhs, hs = (torch.from_numpy(rng.standard_normal((t, n, k)).astype(
        np.float32)) for _ in range(2))
    hs = torch.tanh(hs)
    rt = torch.from_numpy(rng.standard_normal((k, k)).astype(np.float32))
    dz, _, db = rs.rnn_seq_bwd_plain(dhs, hs, torch.zeros(n, k), rt,
                                     act="tanh")
    rows = KERNEL_GEOMETRY[1][1]
    groups = -(-n // rows)
    run = None
    for ti in reversed(range(t)):
        x = np.zeros((groups * rows, k), np.float32)
        x[:n] = dz[ti].numpy()
        x = x.reshape(groups, rows // 2, 2, k)
        pairs = _f32_sum(x[:, :, 0], x[:, :, 1])
        step = pairs[:, 0]
        for e in range(1, rows // 2):
            step = _f32_sum(step, pairs[:, e])
        run = step if run is None else _f32_sum(run, step)
    want = run[0]
    for row in run[1:]:
        want = _f32_sum(want, row)
    np.testing.assert_array_equal(db.numpy(), want[None])


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "dz_dt",
                                 "act", "empty", "residual"])
def test_bwd_wrappers_check_inputs(bad):
    dhs, res, (c0, dht, dct), rt = (
        [torch.from_numpy(x) for x in v] if isinstance(v, list)
        else torch.from_numpy(v) for v in _residuals(25, 3, 4, 5, 4))
    args = [dhs, *res, c0, dht, dct, rt]
    if bad == "dtype":
        with pytest.raises(ValueError, match="dtype"):
            rs.lstm_seq_bwd(*args[:-1], rt.half())
        with pytest.raises(ValueError, match="dtype"):
            rs.lstm_seq_bwd(dhs.double(), *args[1:])
    elif bad == "shape":
        with pytest.raises(ValueError, match="shapes disagree"):
            rs.gru_seq_bwd(dhs, *res, c0, dht, rt)     # 4K rows, 3 gates
        with pytest.raises(ValueError, match="shapes disagree"):
            rs.lstm_seq_bwd(*args[:-4], c0[:3], dht, dct, rt)
    elif bad == "contiguous":
        with pytest.raises(ValueError, match="contiguous"):
            rs.lstm_seq_bwd(*args[:-1], rt.t().contiguous().t())
    elif bad == "dz_dt":
        with pytest.raises(ValueError, match="dz_dt"):
            rs.lstm_seq_bwd(*args, dz_dt=torch.float16)
    elif bad == "act":
        with pytest.raises(ValueError, match="act"):
            rs.rnn_seq_bwd(dhs, res[0], dht, rt[:5].contiguous(), act="gelu")
    elif bad == "residual":
        with pytest.raises(ValueError, match="shapes disagree"):
            rs.lstm_seq_bwd(dhs, *res[:4], res[4][:2], *args[6:])
    else:
        with pytest.raises(ValueError, match="shapes disagree"):
            rs.rnn_seq_bwd(dhs[:0], res[0][:0], dht, rt[:5].contiguous(),
                           act="tanh")
    assert rs.bwd_launches == dict.fromkeys(rs.bwd_launches, 0)


# ---------------------------------------------------------------------------
# Cell parity: gradients of the port's cell against the JAX cell's
# ---------------------------------------------------------------------------


def _cell_inputs(seed, ct, t, n, c, k, scale=0.3):
    g = GATES.get(ct, 1)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, c)).astype(np.float32)
    w = (rng.standard_normal((c, g * k)) * scale).astype(np.float32)
    r = (rng.standard_normal((k, g * k)) * scale).astype(np.float32)
    b = rng.standard_normal((g * k,)).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32)
    c0 = rng.standard_normal((n, k)).astype(np.float32)
    dhs = rng.standard_normal((t, n, k)).astype(np.float32)
    return x, w, r, b, h0, c0, dhs


def _cells(ct, dt, n, c, k, t):
    kw = dict(n=n, c=c, k=k, max_t=t, in_dtype=dt, out_dtype=dt)
    return (jcreate_rnncell(JRnnDesc(cell_type=JCellType(ct.value), **kw)),
            create_rnncell(RnnDesc(cell_type=ct, **kw)))


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("ct", list(CellType))
def test_autograd_through_forward_matches_jax(ct, dt):
    """torch.autograd.grad through RnnCell.forward in every tensor input,
    with a loss on hs, h_T and c_T (so dh_T and dc_T are not zero), against
    jax.grad through the JAX cell's forward (its custom_vjp)."""
    n, c, k, t = 5, 7, 6, 4
    x, w, r, b, h0, c0, dhs = _cell_inputs(30, ct, t, n, c, k)
    rng = np.random.default_rng(31)
    wh, wc = (rng.standard_normal((n, k)).astype(np.float32) for _ in "hc")
    jcell, pcell = _cells(ct, dt, n, c, k, t)

    def jloss(*a):
        hs, h_t, c_t = jcell._fwd(*a)
        return (jnp.sum(hs.astype(jnp.float32) * dhs) + jnp.sum(h_t * wh)
                + jnp.sum(c_t * wc))

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (x, w, r, b, h0, c0)))
    leaves = _leaves(x, w, r, b, h0, c0)
    hs, h_t, c_t = pcell.forward(*leaves)
    loss = ((hs.float() * torch.from_numpy(dhs)).sum()
            + (h_t * torch.from_numpy(wh)).sum()
            + (c_t * torch.from_numpy(wc)).sum())
    got = torch.autograd.grad(loss, leaves)
    tol = PARITY if dt == "float32" else BF16
    for name, w_, g_ in zip(NAMES, want, got):
        assert g_.dtype == torch.float32
        _close(np.asarray(w_, np.float64), g_, tol,
               f"{ct.value} {dt} d{name[1:]}")
    assert rnncell.scan_calls == dict.fromkeys(rnncell.scan_calls, 0)
    assert rnncell.bwd_scan_calls == dict.fromkeys(rnncell.scan_calls, 0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("ct", list(CellType))
def test_backward_weight_update_matches_jax(ct, dt):
    n, c, k, t = 4, 6, 5, 3
    x, w, r, b, h0, c0, dhs = _cell_inputs(32, ct, t, n, c, k)
    jcell, pcell = _cells(ct, dt, n, c, k, t)
    want = jcell.backward_weight_update(x, w, r, b, dhs, h0, c0)
    got = pcell.backward_weight_update(x, w, r, b, dhs, h0, c0)
    assert len(got) == 6
    tol = PARITY if dt == "float32" else BF16
    for name, w_, g_ in zip(NAMES, want, got):
        assert g_.dtype == torch.float32
        _close(np.asarray(w_, np.float64), g_, tol, f"{ct.value} {dt} {name}")
    if ct != CellType.LSTM:
        assert not got[5].any()


@pytest.mark.parametrize("ct", list(CellType))
def test_backward_single_step_matches_jax(ct):
    """T = 1: h_prev is h0 alone (hs[:-1] is empty)."""
    n, c, k, t = 3, 4, 5, 1
    x, w, r, b, h0, c0, dhs = _cell_inputs(36, ct, t, n, c, k)
    jcell, pcell = _cells(ct, "float32", n, c, k, t)
    want = jcell.backward_weight_update(x, w, r, b, dhs, h0, c0)
    got = pcell.backward_weight_update(x, w, r, b, dhs, h0, c0)
    for name, w_, g_ in zip(NAMES, want, got):
        _close(np.asarray(w_, np.float64), g_, PARITY, f"{ct.value} {name}")


def test_lstm_bwd_upd(rng):
    """tests/test_dnn.py::test_lstm_bwd_upd: dw of backward_weight_update
    against autograd through the cell's forward, and all six against the
    JAX cell's."""
    n, c_, k, t = 4, 6, 5, 3
    cell = create_rnncell(RnnDesc(n=n, c=c_, k=k, max_t=t,
                                  cell_type=CellType.LSTM))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, 4 * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, 4 * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((4 * k,)).astype(np.float32)
    dhs = rng.standard_normal((t, n, k)).astype(np.float32)
    grads = cell.backward_weight_update(xt_, w, r, b, dhs)
    assert len(grads) == 6
    dxt, dw, dr, db, dh0, dc0 = grads
    assert tuple(dxt.shape) == xt_.shape
    assert tuple(dw.shape) == w.shape
    tw = torch.from_numpy(w).requires_grad_()
    hs, _, _ = cell.forward(xt_, tw, r, b, np.zeros((n, k), np.float32),
                            np.zeros((n, k), np.float32))
    (gw,) = torch.autograd.grad((hs * torch.from_numpy(dhs)).sum(), tw)
    xt.check(gw.double().numpy(), dw.numpy(), TOL, what="lstm dw")
    jcell = jcreate_rnncell(JRnnDesc(n=n, c=c_, k=k, max_t=t,
                                     cell_type=JCellType.LSTM))
    for name, w_, g_ in zip(NAMES, jcell.backward_weight_update(
            xt_, w, r, b, dhs), grads):
        _close(np.asarray(w_, np.float64), g_, PARITY, f"lstm {name}")


def test_lstm_bf16_backward(rng):
    """The backward half of tests/test_dnn.py::test_lstm_bf16: the bf16
    cell's gradients are finite, and within 1e-2 of the JAX bf16 cell's."""
    n, c_, k, t = 8, 10, 12, 5
    kw = dict(n=n, c=c_, k=k, max_t=t, in_dtype="bfloat16",
              out_dtype="bfloat16")
    cell = create_rnncell(RnnDesc(cell_type=CellType.LSTM, **kw))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, 4 * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, 4 * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((4 * k,)).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32)
    c0 = rng.standard_normal((n, k)).astype(np.float32)
    dhs = rng.standard_normal((t, n, k)).astype(np.float32)
    grads = cell.backward_weight_update(xt_, w, r, b, dhs, h0, c0)
    assert all(torch.isfinite(g).all() for g in grads)
    want = jcreate_rnncell(JRnnDesc(cell_type=JCellType.LSTM, **kw)
                           ).backward_weight_update(xt_, w, r, b, dhs, h0, c0)
    for name, w_, g_ in zip(NAMES, want, grads):
        _close(np.asarray(w_, np.float64), g_, BF16, f"lstm bf16 {name}")


def test_gru_bwd_matches_autodiff_gold(rng):
    """tests/test_dnn.py::test_gru_bwd_matches_autodiff_gold: the gradients
    against autodiff through an independent plain-scan forward (its gold,
    1e-3), and against the JAX cell's (1e-5)."""
    n, c_, k, t = 4, 6, 5, 3
    d = dict(n=n, c=c_, k=k, max_t=t)
    cell = create_rnncell(RnnDesc(cell_type=CellType.GRU, **d))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, 3 * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, 3 * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((3 * k,)).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32)
    dhs = rng.standard_normal((t, n, k)).astype(np.float32)

    def ref_fwd(xv, wv, rv, bv, h0v):
        def body(h, x_t):
            zx = x_t @ wv
            zr = h @ rv
            ri = jax.nn.sigmoid(zx[:, :k] + zr[:, :k] + bv[:k])
            zi = jax.nn.sigmoid(zx[:, k:2 * k] + zr[:, k:2 * k]
                                + bv[k:2 * k])
            gi = jnp.tanh(zx[:, 2 * k:] + ri * zr[:, 2 * k:] + bv[2 * k:])
            h2 = (1 - zi) * gi + zi * h
            return h2, h2
        _, hs = jax.lax.scan(body, h0v, xv)
        return jnp.sum(hs * dhs)

    gold = jax.grad(ref_fwd, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (xt_, w, r, b, h0)))
    grads = cell.backward_weight_update(xt_, w, r, b, dhs, h0)
    jgrads = jcreate_rnncell(JRnnDesc(cell_type=JCellType.GRU, **d)
                             ).backward_weight_update(xt_, w, r, b, dhs, h0)
    for i, name in enumerate(NAMES[:5]):
        xt.check(np.asarray(gold[i], np.float64), grads[i].numpy(), TOL,
                 what=f"gru {name}")
        _close(np.asarray(jgrads[i], np.float64), grads[i], PARITY,
               f"gru {name} vs jax")


@pytest.mark.parametrize("ct", [CellType.RNN_RELU, CellType.RNN_SIGMOID,
                                CellType.RNN_TANH])
def test_rnn_bwd_matches_autodiff_gold(rng, ct):
    """tests/test_dnn.py::test_rnn_bwd_matches_autodiff_gold, and the JAX
    cell's gradients."""
    n, c_, k, t = 4, 6, 5, 3
    d = dict(n=n, c=c_, k=k, max_t=t)
    cell = create_rnncell(RnnDesc(cell_type=ct, **d))
    act = JACT[CT_ACT[ct]]
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, k)) * 0.4).astype(np.float32)
    r = (rng.standard_normal((k, k)) * 0.4).astype(np.float32)
    b = rng.standard_normal((k,)).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32)
    dhs = rng.standard_normal((t, n, k)).astype(np.float32)

    def ref_fwd(xv, wv, rv, bv, h0v):
        def body(h, x_t):
            h2 = act(x_t @ wv + h @ rv + bv)
            return h2, h2
        _, hs = jax.lax.scan(body, h0v, xv)
        return jnp.sum(hs * dhs)

    gold = jax.grad(ref_fwd, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (xt_, w, r, b, h0)))
    grads = cell.backward_weight_update(xt_, w, r, b, dhs, h0)
    jgrads = jcreate_rnncell(JRnnDesc(cell_type=JCellType(ct.value), **d)
                             ).backward_weight_update(xt_, w, r, b, dhs, h0)
    for i, name in enumerate(NAMES[:5]):
        xt.check(np.asarray(gold[i], np.float64), grads[i].numpy(), TOL,
                 what=f"{ct} {name}")
        _close(np.asarray(jgrads[i], np.float64), grads[i], PARITY,
               f"{ct} {name} vs jax")


@pytest.mark.parametrize("ct,out_dt", [
    (CellType.LSTM, "float32"), (CellType.GRU, "float32"),
    (CellType.RNN_TANH, "float32"), (CellType.LSTM, "bfloat16")])
def test_rnn_saved_residual_path_matches_stateless(rng, ct, out_dt):
    """tests/test_dnn.py::test_rnn_saved_residual_path_matches_stateless:
    backward_from_saved equals backward_weight_update, the bf16 case
    included (the cotangent is rounded through out_dtype on both)."""
    n, c_, k, t = 4, 6, 5, 3
    g = GATES.get(ct, 1)
    d = dict(n=n, c=c_, k=k, max_t=t, in_dtype=out_dt, out_dtype=out_dt)
    cell = create_rnncell(RnnDesc(cell_type=ct, **d))
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, g * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, g * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((g * k,)).astype(np.float32)
    dhs = rng.standard_normal((t, n, k)).astype(np.float32)
    (hs, h_t, c_t), saved = cell.forward_train(xt_, w, r, b)
    g_saved = cell.backward_from_saved(saved, dhs)
    g_free = cell.backward_weight_update(xt_, w, r, b, dhs)
    assert len(g_saved) == len(g_free) == 6
    for a, bb, nm in zip(g_saved, g_free, NAMES):
        np.testing.assert_allclose(a.numpy(), bb.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=nm)
    jsaved = jcreate_rnncell(JRnnDesc(cell_type=JCellType(ct.value), **d))
    jgrads = jsaved.backward_from_saved(jsaved.forward_train(xt_, w, r, b)[1],
                                        dhs)
    tol = PARITY if out_dt == "float32" else BF16
    for nm, w_, g_ in zip(NAMES, jgrads, g_saved):
        _close(np.asarray(w_, np.float64), g_, tol, f"{ct} {out_dt} {nm}")


@pytest.mark.parametrize("route", ["bwd_scan", "fwd_scan", "both_scan"])
@pytest.mark.parametrize("ct", [CellType.LSTM, CellType.GRU,
                                CellType.RNN_TANH])
def test_rnn_scan_route_backward_matches_kernel_route(rng, ct, route,
                                                      monkeypatch):
    """The backward half of test_rnn_scan_fallback_matches_pallas: the
    reverse scan of torch ops (taken where seq_bwd_kernel_ok is False)
    agrees with the kernel route, also when only the forward takes its scan
    route (the residuals are the same on both)."""
    n, c_, k, t = 8, 10, 12, 4
    g = GATES.get(ct, 1)
    d = RnnDesc(n=n, c=c_, k=k, max_t=t, cell_type=ct)
    xt_ = rng.standard_normal((t, n, c_)).astype(np.float32)
    w = (rng.standard_normal((c_, g * k)) * 0.3).astype(np.float32)
    r = (rng.standard_normal((k, g * k)) * 0.3).astype(np.float32)
    b = rng.standard_normal((g * k,)).astype(np.float32)
    dhs = rng.standard_normal((t, n, k)).astype(np.float32)

    def run():
        cell = create_rnncell(d)
        return cell.backward_weight_update(xt_, w, r, b, dhs)

    kernel_out = run()
    assert sum(rnncell.bwd_scan_calls.values()) == 0
    if route != "fwd_scan":
        monkeypatch.setattr(rnncell, "seq_bwd_kernel_ok", lambda *a: False)
    if route != "bwd_scan":
        monkeypatch.setattr(rnncell, "seq_kernel_ok", lambda *a: False)
    scan_out = run()
    assert sum(rnncell.bwd_scan_calls.values()) == int(route != "fwd_scan")
    assert sum(rnncell.scan_calls.values()) == int(route != "bwd_scan")
    for a, bb, nm in zip(kernel_out, scan_out, NAMES):
        _close(a, bb, 1e-4, f"{ct} {route} {nm}")


# ---------------------------------------------------------------------------
# API: execute, routing of the forward's form, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ct", list(CellType))
def test_execute_bwd_upd_matches_backward_weight_update(ct):
    x, w, r, b, h0, c0, dhs = _cell_inputs(33, ct, 3, 4, 5, 6)
    cell = create_rnncell(RnnDesc(n=4, c=5, k=6, max_t=3, cell_type=ct))
    want = cell.backward_weight_update(x, w, r, b, dhs, h0, c0)
    args = dict(input=x, weight=w, recur_weight=r, bias=b, grad_hidden=dhs,
                h0=h0, c0=c0)
    for kind in (Kind.BWD, Kind.UPD):
        got = cell.execute(kind, **args)
        assert len(got) == 6
        for a, bb in zip(got, want):
            assert torch.equal(a, bb)
    with pytest.raises(ValueError):
        cell.execute("bwd", **args)


def test_forward_keeps_residuals_only_for_a_gradient(monkeypatch):
    """Without a tensor that wants a gradient, forward runs the sequence
    kernel's inference form and builds no graph; with one, its train form."""
    forms = []
    real = rnncell.lstm_seq

    def spy(*a, train):
        forms.append(train)
        return real(*a, train=train)
    monkeypatch.setattr(rnncell, "lstm_seq", spy)
    x, w, r, b, h0, c0, _ = _cell_inputs(34, CellType.LSTM, 3, 4, 5, 6)
    cell = create_rnncell(RnnDesc(n=4, c=5, k=6, max_t=3))
    hs, _, _ = cell.forward(x, w, r, b, h0, c0)
    assert hs.grad_fn is None
    tw = torch.from_numpy(w).requires_grad_()
    hs, _, _ = cell.forward(x, tw, r, b, h0, c0)
    assert hs.grad_fn is not None
    with torch.no_grad():
        cell.forward(x, tw, r, b, h0, c0)
    assert forms == [False, True, False]


def test_cpu_counts_no_backward_launch():
    for ct in CellType:
        x, w, r, b, h0, c0, dhs = _cell_inputs(35, ct, 3, 4, 5, 6)
        cell = create_rnncell(RnnDesc(n=4, c=5, k=6, max_t=3, cell_type=ct))
        _, saved = cell.forward_train(x, w, r, b, h0, c0)
        cell.backward_from_saved(saved, dhs)
        leaves = _leaves(x, w)
        hs, _, _ = cell.forward(*leaves, r, b, h0, c0)
        hs.sum().backward()
        assert all(t.grad is not None for t in leaves)
    assert rs.bwd_launches == dict.fromkeys(rs.bwd_launches, 0)
    assert rnncell.bwd_scan_calls == dict.fromkeys(rnncell.scan_calls, 0)
    assert rs.seq_bwd_kernel_ok(10 ** 6, 10 ** 5, 4, 4)  # the CPU takes any


def test_no_card_backward_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp.set_config(target="")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.seq_bwd_kernel_ok(3, 5, 1, 4)
