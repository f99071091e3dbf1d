"""xsmm_tpu_torch's DNN layer handles (conv, fully connected, pooling with
the max-pool window backward, fused batchnorm) against xsmm_tpu's and gold.

Each test makes its inputs with numpy from a seed and feeds them to the JAX
layer and to its port.  The JAX package runs as ``tests/test_dnn.py`` runs
it on the CPU: its window kernel in interpret mode.  The port runs with
``target="cpu"`` (the window kernel's plain version).  Tolerances, stated
once here:

* max pooling, forward and both backward routes: bit-exact against JAX,
  except the sign of a max of zeros (which of a tied -0/+0 pair a max
  returns is the library's choice; the backward routes them alike); avg
  pooling 1e-6 rel-Frobenius (the window sum's order is torch's);
* conv, FC and BN in f32: 1e-5 rel-Frobenius against JAX (``PARITY``), BN
  dx 1e-4 (``PARITY_BN_DX``: a difference of E[x^2] - mean^2 rounding
  grows through the (x - mean) terms);
* bf16 layers: 1e-2 (``PARITY_BF16``: bf16 holds ~3 digits, and a rounding
  may flip where the two sum in other orders);
* the gates of ``tests/test_dnn.py`` against gold (1e-3; BN dx 1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu.dnn as jd
import xsmm_tpu_torch as xp
from xsmm_tpu_torch import dnn as pd
from xsmm_tpu_torch.dnn import conv as pconv
from xsmm_tpu_torch.dnn import pooling as ppool

TOL = 1e-3            # tests/test_dnn.py's gate against gold
PARITY = 1e-5         # port against the JAX package, f32
PARITY_BN_DX = 1e-4
PARITY_BF16 = 1e-2
PARITY_AVG = 1e-6
STATS_FIELDS = ("sum", "sumsq", "mean", "var", "absmax")


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    ppool.reset_launches()
    yield
    xp.set_config(**saved)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(np.asarray(x, np.float32), np.float64)


def _close(want, got, tol, what=""):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert np.isfinite(got).all(), what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)
    assert err <= tol, f"{what}: rel-Frobenius {err:.3e} > {tol:g}"


def _exact(want, got, what="", signed_zeros=True):
    """Bit for bit; with ``signed_zeros=False`` a zero's sign may differ."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if signed_zeros:
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32)), what
    else:
        assert np.array_equal(want, got), what


def _both(desc_cls, **kw):
    """The same descriptor for both packages (enums mapped by name)."""
    jkw, pkw = {}, {}
    for k, v in kw.items():
        if hasattr(v, "name") and hasattr(jd, type(v).__name__):
            jkw[k] = getattr(jd, type(v).__name__)(v.value)
            pkw[k] = v
        else:
            jkw[k] = pkw[k] = v
    return getattr(jd, desc_cls)(**jkw), getattr(pd, desc_cls)(**pkw)


def conv_gold(x, w, stride, pad):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
        window_strides=stride, padding=(pad, pad),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST))


def _conv_pair(**kw):
    jdesc, pdesc = _both("ConvDesc", **kw)
    return jd.create_conv_layer(jdesc), pd.create_conv_layer(pdesc)


# ------------------------------------------------------------------ conv ----

@pytest.mark.parametrize("stride,pad", [(1, 0), (1, 1), (2, 1)])
def test_conv_forward(rng, stride, pad):
    jl, pl = _conv_pair(n=2, c=5, h=8, w=8, k=7, r=3, s=3, u=stride,
                        v=stride, pad_h=pad, pad_w=pad)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    wt = rng.standard_normal((3, 3, 5, 7)).astype(np.float32) * 0.2
    y = pl.forward(x, wt)
    assert tuple(y.shape) == (2, pl.desc.out_h, pl.desc.out_w, 7)
    _close(jl.forward(x, wt), y, PARITY, "conv fwd vs JAX")
    xt.check(conv_gold(x, wt, (stride, stride), (pad, pad)), _np(y), TOL)


def test_conv_fused_bias_relu(rng):
    jl, pl = _conv_pair(n=2, c=4, h=6, w=6, k=8, r=3, s=3, pad_h=1,
                        pad_w=1, fuse_ops=pd.FuseOp.BIAS | pd.FuseOp.RELU)
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    wt = rng.standard_normal((3, 3, 4, 8)).astype(np.float32) * 0.2
    b = rng.standard_normal((8,)).astype(np.float32)
    y = pl.forward(x, wt, b)
    _close(jl.forward(x, wt, b), y, PARITY, "conv bias+relu vs JAX")
    gold = np.maximum(conv_gold(x, wt, (1, 1), (1, 1)) + b, 0)
    xt.check(gold, _np(y), TOL)
    assert (y >= 0).all()
    with pytest.raises(ValueError, match="bias"):
        pl.forward(x, wt)


def test_conv_relu_bwd_fusion(rng):
    fuse = pd.FuseOp.RELU | pd.FuseOp.RELU_BWD
    jl, pl = _conv_pair(n=2, c=4, h=6, w=6, k=8, r=3, s=3, pad_h=1,
                        pad_w=1, fuse_ops=fuse)
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    wt = rng.standard_normal((3, 3, 4, 8)).astype(np.float32) * 0.2
    dy = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    y = pl.forward(x, wt)
    dx = pl.backward(dy, wt, y)
    _close(jl.backward(dy, wt, np.asarray(jl.forward(x, wt))), dx, PARITY,
           "conv relu_bwd vs JAX")

    _, vjp = jax.vjp(lambda x_: jnp.maximum(jax.lax.conv_general_dilated(
        x_, jnp.asarray(wt), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST), 0.0), jnp.asarray(x))
    xt.check(np.asarray(vjp(jnp.asarray(dy))[0]), _np(dx), TOL)
    with pytest.raises(ValueError):
        pl.backward(dy, wt)  # y is required with RELU_BWD


def test_conv_batch_stats(rng):
    jl, pl = _conv_pair(n=2, c=3, h=5, w=5, k=6, r=1, s=1,
                        fuse_ops=pd.FuseOp.BATCH_STATS_FWD)
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    wt = rng.standard_normal((1, 1, 3, 6)).astype(np.float32)
    y, stats = pl.forward(x, wt)
    jy, jstats = jl.forward(x, wt)
    _close(jy, y, PARITY)
    for f in ("sum", "sumsq"):
        _close(getattr(jstats, f), getattr(stats, f), PARITY, f)
    assert stats.mean is None and stats.absmax is None
    y = _np(y)
    assert np.allclose(_np(stats.sum), y.sum((0, 1, 2)), atol=1e-3)
    assert np.allclose(_np(stats.sumsq), (y * y).sum((0, 1, 2)), atol=1e-3)


def test_conv_s2d_shape_polymorphic(rng):
    """The space-to-depth fold honours the runtime shapes, odd ones too,
    and gives the JAX package's results."""
    jl, pl = _conv_pair(n=2, c=4, h=16, w=16, k=8, r=3, s=3, pad_h=1,
                        pad_w=1)
    assert pl._use_s2d and pl._fold == jl._fold == (2, 2)
    wt = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    for shape in ((2, 24, 24, 4), (1, 17, 19, 4)):
        x = rng.standard_normal(shape).astype(np.float32)
        y = pl.forward(x, wt)
        gold = conv_gold(x, wt, (1, 1), (1, 1))
        assert tuple(y.shape) == gold.shape
        xt.check(gold, _np(y), TOL, what=f"s2d conv at {shape}")
        _close(jl.forward(x, wt), y, PARITY, f"s2d conv vs JAX at {shape}")


@pytest.mark.parametrize("k,c", [(8, 4), (64, 48), (32, 16)])
def test_conv_fold_routing_matches_jax(rng, k, c):
    """``_fold`` and ``_use_s2d`` are the JAX package's, and the folded
    conv (forward and its backward fold) equals the direct one."""
    kw = dict(n=2, c=c, h=12, w=12, k=k, r=3, s=3, pad_h=1, pad_w=1)
    jl, pl = _conv_pair(**kw)
    assert pl._fold == jl._fold and pl._use_s2d == jl._use_s2d
    x = torch.tensor(rng.standard_normal((2, 12, 12, c)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((3, 3, c, k)) * 0.2,
                     dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((2, 12, 12, k)),
                      dtype=torch.float32)
    direct = pconv._conv(x, w, (1, 1), pl._pad)
    _close(direct, pl._core_conv(x, w), PARITY, "fold vs direct fwd")
    wr = torch.flip(w, (0, 1)).transpose(2, 3)
    _close(pconv._conv(dy, wr, (1, 1), pl._pad), pl._bwd_direct(dy, w),
           PARITY, "fold vs direct bwd")


def test_conv_fused_stats_full_set(rng):
    """MAX_STATS / BATCHNORM_STATS fwd + BATCH_STATS_BWD / ELTWISE_BWD bwd
    (libxsmm_dnn.h:265-287 parity)."""
    F_ = pd.FuseOp
    jl, pl = _conv_pair(n=2, c=3, h=5, w=5, k=6, r=1, s=1,
                        fuse_ops=(F_.BATCH_STATS_FWD | F_.BATCHNORM_STATS
                                  | F_.MAX_STATS))
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    wt = rng.standard_normal((1, 1, 3, 6)).astype(np.float32)
    y, stats = pl.forward(x, wt)
    _, jstats = jl.forward(x, wt)
    for f in STATS_FIELDS:
        _close(getattr(jstats, f), getattr(stats, f), PARITY, f)
    y64 = _np(y)
    assert np.allclose(_np(stats.mean), y64.mean((0, 1, 2)), atol=1e-4)
    assert np.allclose(_np(stats.var), y64.var((0, 1, 2)), atol=1e-3)
    assert np.allclose(_np(stats.absmax), np.abs(y64).max((0, 1, 2)),
                       atol=1e-4)

    jlb, plb = _conv_pair(n=2, c=3, h=5, w=5, k=6, r=1, s=1,
                          fuse_ops=(F_.BATCH_STATS_BWD | F_.ELTWISE_BWD
                                    | F_.MAX_STATS))
    dy = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    yn = y.numpy()
    dx, d_elt, bstats = plb.backward(dy, wt, y=yn)
    jdx, jd_elt, jbstats = jlb.backward(dy, wt, y=yn)
    _close(jdx, dx, PARITY, "dx")
    _exact(jd_elt, d_elt, "d_eltwise")
    for f in ("dbeta", "dgamma_y", "dx_absmax"):
        _close(getattr(jbstats, f), getattr(bstats, f), PARITY, f)
    assert np.allclose(_np(d_elt), dy, atol=1e-6)
    assert np.allclose(_np(bstats.dbeta), dy.sum((0, 1, 2)), atol=1e-3)
    assert np.allclose(_np(bstats.dgamma_y), (dy * yn).sum((0, 1, 2)),
                       atol=1e-3)
    assert np.allclose(_np(bstats.dx_absmax),
                       np.abs(_np(dx)).max((0, 1, 2)), atol=1e-5)
    with pytest.raises(ValueError):
        plb.backward(dy, wt)  # y required with BATCH_STATS_BWD



@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 1), (2, 0), (1, 2)])
def test_conv_bwd_upd_vs_autodiff(rng, stride, pad):
    """(2, 0) has (H - R) % u != 0, where the input size settles dx's
    shape; (1, 2) has pad > R - 1 (no direct backward)."""
    jl, pl = _conv_pair(n=2, c=4, h=8, w=8, k=6, r=3, s=3, u=stride,
                        v=stride, pad_h=pad, pad_w=pad)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    wt = rng.standard_normal((3, 3, 4, 6)).astype(np.float32) * 0.3
    d = pl.desc
    dy = rng.standard_normal((2, d.out_h, d.out_w, 6)).astype(np.float32)

    def f(x_, w_):
        return jnp.sum(jax.lax.conv_general_dilated(
            x_, w_, (stride, stride), ((pad, pad), (pad, pad)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST) * dy)

    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wt))
    dx, dw = pl.backward(dy, wt), pl.weight_update(x, dy)
    assert tuple(dx.shape) == x.shape and tuple(dw.shape) == wt.shape
    xt.check(np.asarray(gx, np.float64), _np(dx), TOL, what="conv bwd")
    xt.check(np.asarray(gw, np.float64), _np(dw), TOL, what="conv upd")
    _close(jl.backward(dy, wt), dx, PARITY, "conv bwd vs JAX")
    _close(jl.weight_update(x, dy), dw, PARITY, "conv upd vs JAX")


def test_conv_nchw_kcrs_formats(rng):
    jl, pl = _conv_pair(n=2, c=3, h=6, w=6, k=4, r=3, s=3, pad_h=1, pad_w=1,
                        buffer_format=pd.Format.NCHW,
                        filter_format=pd.Format.KCRS)
    x = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    wt = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    y = pl.forward(x, wt)
    assert tuple(y.shape) == (2, 4, 6, 6) and y.is_contiguous()
    gold = np.transpose(conv_gold(np.transpose(x, (0, 2, 3, 1)),
                                  np.transpose(wt, (2, 3, 1, 0)), (1, 1),
                                  (1, 1)), (0, 3, 1, 2))
    xt.check(gold, _np(y), TOL)
    _close(jl.forward(x, wt), y, PARITY)
    dy = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    _close(jl.backward(dy, wt), pl.backward(dy, wt), PARITY, "NCHW dx")
    dw = pl.weight_update(x, dy)
    assert tuple(dw.shape) == (4, 3, 3, 3)
    _close(jl.weight_update(x, dy), dw, PARITY, "KCRS dw")


def test_conv_execute_api(rng):
    jl, pl = _conv_pair(n=1, c=2, h=4, w=4, k=2, r=3, s=3, pad_h=1, pad_w=1)
    x = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
    wt = rng.standard_normal((3, 3, 2, 2)).astype(np.float32)
    K = pd.Kind
    y = pl.execute(K.FWD, input=x, filter=wt)
    dy = np.ones(tuple(y.shape), np.float32)
    dx = pl.execute(K.BWD, grad_output=dy, filter=wt)
    dw = pl.execute(K.UPD, input=x, grad_output=dy)
    assert tuple(dx.shape) == x.shape and tuple(dw.shape) == wt.shape
    _close(jl.execute(jd.Kind.BWD, grad_output=dy, filter=wt), dx, PARITY)
    _close(jl.execute(jd.Kind.UPD, input=x, grad_output=dy), dw, PARITY)
    with pytest.raises(ValueError):
        pl.execute("nope")


@pytest.mark.parametrize("shape", [(2, 4, 10, 10, 8), (2, 4, 10, 10, 80)])
def test_conv_custom_vjp_matches_autodiff(rng, shape):
    """Autograd through ConvLayer.forward (``_ConvCore``: the direct dx,
    folded where C is narrow, and the conv's dw) equals JAX's grad through
    its forward and the plain conv's autodiff."""
    n, c, h, w, k = shape
    jl, pl = _conv_pair(n=n, c=c, h=h, w=w, k=k, r=3, s=3, pad_h=1, pad_w=1)
    assert pl._custom_core and jl._custom_core
    xn = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wn = rng.standard_normal((3, 3, c, k)).astype(np.float32)
    x = torch.tensor(xn, requires_grad=True)
    wt = torch.tensor(wn, requires_grad=True)
    (pl.forward(x, wt) ** 2).sum().backward()
    gx, gw = jax.grad(lambda x_, w_: jnp.sum(jl.forward(x_, w_) ** 2),
                      argnums=(0, 1))(jnp.asarray(xn), jnp.asarray(wn))
    _close(gx, x.grad, PARITY, "dx vs JAX")
    _close(gw, wt.grad, PARITY, "dw vs JAX")
    xr = torch.tensor(xn, requires_grad=True)
    wr = torch.tensor(wn, requires_grad=True)
    y = torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2),
                                   wr.permute(3, 2, 0, 1), padding=1)
    (y ** 2).sum().backward()
    assert float((x.grad - xr.grad).abs().max()) < 1e-4
    assert float((wt.grad - wr.grad).abs().max()) < 1e-3
    _, ps = _conv_pair(n=2, c=4, h=10, w=10, k=8, r=3, s=3, u=2, v=2,
                       pad_h=1, pad_w=1)
    assert not ps._custom_core


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bf16(rng, stride):
    """bf16 convs round the conv's output to bf16 before the epilogue;
    BWD and UPD run on f32 operands."""
    jl, pl = _conv_pair(n=2, c=16, h=8, w=8, k=32, r=3, s=3, u=stride,
                        v=stride, pad_h=1, pad_w=1, in_dtype="bfloat16",
                        out_dtype="bfloat16",
                        fuse_ops=pd.FuseOp.BIAS | pd.FuseOp.RELU)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 16, 32)) * 0.2).astype(np.float32)
    b = rng.standard_normal((32,)).astype(np.float32)
    y = pl.forward(x, wt, b)
    assert y.dtype == torch.bfloat16
    _close(jl.forward(x, wt, b), y, PARITY_BF16, "bf16 fwd")
    d = pl.desc
    dy = rng.standard_normal((2, d.out_h, d.out_w, 32)).astype(np.float32)
    dx, dw = pl.backward(dy, wt), pl.weight_update(x, dy)
    assert dx.dtype == dw.dtype == torch.bfloat16
    _close(jl.backward(dy, wt), dx, PARITY_BF16, "bf16 bwd")
    _close(jl.weight_update(x, dy), dw, PARITY_BF16, "bf16 upd")


def test_conv_restores_cudnn_tf32():
    """An f32 conv leaves cuDNN's TF32 flag as the caller set it."""
    _, pl = _conv_pair(n=1, c=2, h=4, w=4, k=2, r=3, s=3, pad_h=1, pad_w=1)
    x = np.ones((1, 4, 4, 2), np.float32)
    w = np.ones((3, 3, 2, 2), np.float32)
    saved = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            pl.forward(x, w)
            pl.backward(x, w)
            pl.weight_update(x, x)
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_conv_restores_per_backend_precision():
    """Where the caller set cuDNN's conv and RNN TF32 apart (the legacy
    ``allow_tf32`` getter then refuses to read), an f32 conv sets the
    per-backend conv precisions for the call and restores them."""
    _, pl = _conv_pair(n=1, c=2, h=4, w=4, k=2, r=3, s=3, u=2, v=2)
    x = torch.ones((1, 4, 4, 2), requires_grad=True)
    w = np.ones((3, 3, 2, 2), np.float32)
    backends = (torch.backends.cudnn.conv, torch.backends.cudnn.rnn,
                torch.backends.mkldnn.conv)
    saved = [b.fp32_precision for b in backends]
    try:
        backends[0].fp32_precision = "tf32"
        backends[1].fp32_precision = "ieee"
        with pytest.raises(RuntimeError):
            torch.backends.cudnn.allow_tf32
        pl.forward(x, w).sum().backward()
        pl.backward(np.ones((1, 1, 1, 2), np.float32), w)
        assert [b.fp32_precision for b in backends] == ["tf32", "ieee",
                                                        saved[2]]
    finally:
        for b, v in zip(backends, saved):
            b.fp32_precision = v


# -------------------------------------------------------------------- fc ----

@pytest.mark.parametrize("dt,fuse", [
    ("float32", "BIAS|RELU"), ("float32", "NONE"), ("float32", "BIAS"),
    ("bfloat16", "BIAS|RELU")])
def test_fc_fwd_bwd_upd(rng, dt, fuse):
    fuse_ops = pd.FuseOp.NONE
    for f in fuse.split("|"):
        fuse_ops |= pd.FuseOp[f]
    jdesc, pdesc = _both("FCDesc", n=16, c=32, k=24, in_dtype=dt,
                         out_dtype=dt, fuse_ops=fuse_ops)
    jl = jd.create_fullyconnected_layer(jdesc)
    pl = pd.create_fullyconnected_layer(pdesc)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32) * 0.2
    b = rng.standard_normal((24,)).astype(np.float32) if "BIAS" in fuse \
        else None
    tol = PARITY if dt == "float32" else PARITY_BF16
    out, jout = pl.forward(x, w, b), jl.forward(x, w, b)
    relu = "RELU" in fuse
    y, mask = out if relu else (out, None)
    jy, jmask = jout if relu else (jout, None)
    assert y.dtype == pd.fullyconnected.TORCH_DTYPES[dt]
    _close(jy, y, tol, "fc fwd")
    if relu:
        assert mask.dtype == torch.bool
        assert (mask.numpy() == np.asarray(jmask)).mean() > 0.99
    if dt == "float32":
        gold = x.astype(np.float64) @ w.astype(np.float64) + \
            (0 if b is None else b)
        xt.check(np.maximum(gold, 0) if relu else gold, _np(y), TOL)
    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    # both packages take the same mask: the port's
    m = None if mask is None else mask.numpy()
    dx = pl.backward(dy, w, m)
    dw, db = pl.weight_update(x, dy, m)
    jdw, jdb = jl.weight_update(x, dy, m)
    _close(jl.backward(dy, w, m), dx, tol, "fc bwd")
    _close(jdw, dw, tol, "fc upd dw")
    _close(jdb, db, PARITY, "fc upd db")
    if dt == "float32" and relu:
        def f(x_, w_, b_):
            return jnp.sum(jnp.maximum(x_ @ w_ + b_, 0) * dy)
        gx, gw, gb = jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        xt.check(np.asarray(gx, np.float64), _np(dx), TOL)
        xt.check(np.asarray(gw, np.float64), _np(dw), TOL)
        xt.check(np.asarray(gb, np.float64), _np(db), TOL)
    if "BIAS" in fuse:
        with pytest.raises(ValueError, match="bias"):
            pl.forward(x, w)


def test_fc_execute_api(rng):
    _, pdesc = _both("FCDesc", n=4, c=8, k=6)
    pl = pd.create_fullyconnected_layer(pdesc)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    K = pd.Kind
    y = pl.execute(K.FWD, input=x, filter=w)
    dy = np.ones((4, 6), np.float32)
    dx = pl.execute(K.BWD, grad_output=dy, filter=w)
    dw, db = pl.execute(K.UPD, input=x, grad_output=dy)
    _close(x.astype(np.float64) @ w, y, 1e-6)
    _close(dy @ w.T.astype(np.float64), dx, 1e-6)
    _close(x.T.astype(np.float64) @ dy, dw, 1e-6)
    assert np.allclose(_np(db), 4.0)


# --------------------------------------------------------------- pooling ----

def _pool_pair(**kw):
    jdesc, pdesc = _both("PoolingDesc", **kw)
    return jd.create_pooling_layer(jdesc), pd.create_pooling_layer(pdesc)


@pytest.mark.parametrize("ptype", ["MAX", "AVG"])
def test_pooling(rng, ptype):
    jl, pl = _pool_pair(n=2, c=6, h=8, w=8, r=2, s=2, u=2, v=2,
                        pool_type=pd.PoolType[ptype])
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    y = pl.forward(x)
    assert tuple(y.shape) == (2, 4, 4, 6) and y.is_contiguous()
    xr = x.reshape(2, 4, 2, 4, 2, 6)
    gold = xr.max((2, 4)) if ptype == "MAX" else xr.mean((2, 4))
    xt.check(gold, _np(y), TOL)
    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    dx = pl.backward(dy, x)
    assert tuple(dx.shape) == x.shape and pl.bwd_kind == "vjp"
    assert abs(float(dx.sum()) - dy.sum()) < 1e-2
    if ptype == "MAX":
        _exact(jl.forward(x), y, "max fwd", signed_zeros=False)
        _exact(jl.backward(dy, x), dx, "max bwd")
    else:
        _close(jl.forward(x), y, PARITY_AVG, "avg fwd")
        _close(jl.backward(dy, x), dx, PARITY_AVG, "avg bwd")
    assert ppool.launches["maxpool2x2_bwd"] == 0


@pytest.mark.parametrize("ptype", ["MAX", "AVG"])
@pytest.mark.parametrize("r,u,pad", [(3, 2, 1), (3, 1, 1), (2, 2, 1),
                                     (3, 2, 2), (2, 1, 0)])
def test_pooling_windows_pads_and_ties(rng, ptype, r, u, pad):
    """Overlapping windows, pad > r/2 (which torch's own ``padding=``
    refuses), and tied inputs (values rounded to 0.5): max pads with -inf
    and routes ties to the first maximal element, avg counts the padding,
    on the port's vjp route as on JAX's."""
    jl, pl = _pool_pair(n=2, c=5, h=9, w=7, r=r, s=r, u=u, v=u, pad_h=pad,
                        pad_w=pad, pool_type=pd.PoolType[ptype])
    x = (np.round(rng.standard_normal((2, 9, 7, 5)) * 2) / 2
         ).astype(np.float32)
    y = pl.forward(x)
    d = pl.desc
    assert tuple(y.shape) == (2, d.out_h, d.out_w, 5)
    dy = (np.round(rng.standard_normal(tuple(y.shape)) * 4) / 4
          ).astype(np.float32)
    dx = pl.backward(dy, x)
    if ptype == "MAX":
        _exact(jl.forward(x), y, "max fwd", signed_zeros=False)
        _exact(jl.backward(dy, x), dx, "max bwd")
    else:
        _close(jl.forward(x), y, PARITY_AVG, "avg fwd")
        _close(jl.backward(dy, x), dx, PARITY_AVG, "avg bwd")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_maxpool_bwd_pallas_window_bitexact(rng, monkeypatch, dt):
    """The window route (``XSMM_POOL_WINDOW_KERNEL=1``) gives, bit for bit,
    the JAX window kernel's dx (interpret mode) and JAX's select-and-scatter
    VJP, including tie routing; non-qualifying shapes keep the vjp route."""
    monkeypatch.setenv("XSMM_POOL_WINDOW_KERNEL", "1")
    jl, pl = _pool_pair(n=2, c=128, h=8, w=8, r=2, s=2, u=2, v=2,
                        pool_type=pd.PoolType.MAX, dtype=dt)
    assert pl.bwd_kind == jl.bwd_kind == "pallas_window"
    x = (np.round(rng.standard_normal((2, 8, 8, 128)) * 2) / 2
         ).astype(np.float32)
    dy = rng.standard_normal((2, 4, 4, 128)).astype(np.float32)
    got = pl.backward(dy, x)
    assert got.dtype == pd.pooling.TORCH_DTYPES[dt]
    _exact(np.asarray(jl.backward(dy, x), np.float32), got.float(),
           "window bwd vs JAX's window kernel")
    _exact(np.asarray(jl._bwd(jnp.asarray(dy), jnp.asarray(x))),
           ppool.maxpool2x2_bwd(torch.tensor(dy), torch.tensor(x)),
           "window plain vs JAX's window kernel, f32")

    def fwd(xx):
        return jax.lax.reduce_window(
            xx, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1),
            ((0, 0),) * 4)
    _, vjp = jax.vjp(fwd, jnp.asarray(x))
    _exact(np.asarray(vjp(jnp.asarray(dy))[0]),
           ppool.maxpool2x2_bwd(torch.tensor(dy), torch.tensor(x)),
           "window plain vs JAX's VJP")
    assert ppool.launches["maxpool2x2_bwd"] == 0   # CPU: plain version
    for kw in (dict(c=6), dict(c=128, pad_h=1, pad_w=1),
               dict(c=128, pool_type=pd.PoolType.AVG),
               dict(c=128, r=3, s=3)):
        full = dict(n=2, h=8, w=8, r=2, s=2, u=2, v=2,
                    pool_type=pd.PoolType.MAX)
        full.update(kw)
        assert pd.create_pooling_layer(
            pd.PoolingDesc(**full)).bwd_kind == "vjp"


def test_maxpool_window_routes_agree(rng, monkeypatch):
    """On tied, finite inputs the window route and the vjp route give the
    same dx, bit for bit, and the kernel's plain version equals a numpy
    loop of the first-match rule."""
    x = (np.round(rng.standard_normal((3, 6, 10, 8)) * 2) / 2
         ).astype(np.float32)
    dy = rng.standard_normal((3, 3, 5, 8)).astype(np.float32)
    d = pd.PoolingDesc(n=3, c=8, h=6, w=10, r=2, s=2, u=2, v=2)
    dx_vjp = pd.create_pooling_layer(d).backward(dy, x)
    dx_win = ppool.maxpool2x2_bwd(torch.tensor(dy), torch.tensor(x))
    assert torch.equal(dx_vjp, dx_win)
    gold = np.zeros_like(x)
    for a in range(3):
        for i in range(3):
            for j in range(5):
                win = [(2 * i, 2 * j), (2 * i, 2 * j + 1),
                       (2 * i + 1, 2 * j), (2 * i + 1, 2 * j + 1)]
                for ch in range(8):
                    m = max(x[a, p, q, ch] for p, q in win)
                    p, q = next((p, q) for p, q in win
                                if x[a, p, q, ch] >= m)
                    gold[a, p, q, ch] = dy[a, i, j, ch]
    _exact(gold, dx_win, "numpy first-match gold")


def test_maxpool_window_nan_windows_get_zero():
    """A window holding a NaN gets 0 from the window kernel's plain
    version, as from the Pallas kernel (module docstring)."""
    x = torch.zeros((1, 2, 2, 4))
    x[0, 1, 0, 1] = float("nan")
    dy = torch.ones((1, 1, 1, 4))
    dx = ppool.maxpool2x2_bwd(dy, x)
    assert (dx[..., 1] == 0).all()
    assert dx[0, 0, 0, 0] == 1 and dx[..., 0].sum() == 1


@pytest.mark.parametrize("bad", ["odd", "c", "dtype", "dy", "strided"])
def test_maxpool_window_refuses(bad):
    x = torch.zeros((1, 4, 4, 8))
    dy = torch.zeros((1, 2, 2, 8))
    if bad == "odd":
        x, dy = torch.zeros((1, 5, 4, 8)), torch.zeros((1, 2, 2, 8))
    elif bad == "c":
        x, dy = torch.zeros((1, 4, 4, 6)), torch.zeros((1, 2, 2, 6))
    elif bad == "dtype":
        x, dy = x.double(), dy.double()
    elif bad == "dy":
        dy = torch.zeros((1, 2, 3, 8))
    else:
        x = torch.zeros((1, 4, 8, 4)).transpose(2, 3)
    with pytest.raises(ValueError):
        ppool.maxpool2x2_bwd(dy, x)


def test_pooling_execute_api(rng):
    jl, pl = _pool_pair(n=1, c=4, h=4, w=4, r=2, s=2, u=2, v=2)
    x = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    y = pl.execute(pd.Kind.FWD, input=x)
    dy = np.ones(tuple(y.shape), np.float32)
    _exact(jl.execute(jd.Kind.BWD, grad_output=dy, input=x),
           pl.execute(pd.Kind.BWD, grad_output=dy, input=x))
    with pytest.raises(ValueError):
        pl.execute(pd.Kind.UPD)


# ----------------------------------------------------------------- bnorm ----

def _bn_pair(**kw):
    jdesc, pdesc = _both("BnDesc", **kw)
    return jd.create_fusedbatchnorm(jdesc), pd.create_fusedbatchnorm(pdesc)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_batchnorm_fwd_bwd(rng, dt):
    jb, pb = _bn_pair(n=4, c=6, h=5, w=5, fuse=pd.BnFuse.RELU, dtype=dt)
    x = rng.standard_normal((4, 5, 5, 6)).astype(np.float32) * 2 + 1
    gamma = rng.standard_normal((6,)).astype(np.float32)
    beta = rng.standard_normal((6,)).astype(np.float32)
    y, state = pb.forward(x, gamma, beta)
    jy, jstate = jb.forward(x, gamma, beta)
    tol = PARITY if dt == "float32" else PARITY_BF16
    _close(jy, y, tol, "bn y")
    for f in ("mean", "var", "inv_std", "x_hat"):
        _close(getattr(jstate, f), getattr(state, f), PARITY, f)
    mean = x.astype(np.float64).mean((0, 1, 2))
    var = x.astype(np.float64).var((0, 1, 2))
    gold = np.maximum((x - mean) / np.sqrt(var + 1e-5) * gamma + beta, 0)
    xt.check(gold, _np(y), TOL if dt == "float32" else 1e-2)

    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    dx, dgamma, dbeta = pb.backward(dy, gamma, state)
    jdx, jdg, jdb = jb.backward(dy, gamma, jstate)
    assert dx.dtype == pd.batchnorm.TORCH_DTYPES[dt]
    _close(jdx, dx, PARITY_BN_DX if dt == "float32" else PARITY_BF16, "dx")
    _close(jdg, dgamma, PARITY, "dgamma")
    _close(jdb, dbeta, PARITY, "dbeta")
    if dt == "float32":
        def f(x_, g_, b_):
            m = jnp.mean(x_, axis=(0, 1, 2))
            v = jnp.var(x_, axis=(0, 1, 2))
            yy = jnp.maximum((x_ - m) * jax.lax.rsqrt(v + 1e-5) * g_ + b_, 0)
            return jnp.sum(yy * dy)
        gx, gg, gb = jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        xt.check(np.asarray(gx, np.float64), _np(dx), 1e-2, what="bn dx")
        xt.check(np.asarray(gg, np.float64), _np(dgamma), TOL)
        xt.check(np.asarray(gb, np.float64), _np(dbeta), TOL)


def test_batchnorm_eltwise_residual(rng):
    jb, pb = _bn_pair(n=2, c=4, h=3, w=3, fuse=pd.BnFuse.ELTWISE_RELU)
    x = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    res = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    g = np.ones(4, np.float32)
    b = np.zeros(4, np.float32)
    y, state = pb.forward(x, g, b, res)
    jy, jstate = jb.forward(x, g, b, res)
    assert (y >= 0).all()
    _close(jy, y, PARITY)
    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    out = pb.backward(dy, g, state)
    jout = jb.backward(dy, g, jstate)
    assert len(out) == len(jout) == 4  # dx, dgamma, dbeta, dresidual
    for want, got, tol in zip(jout, out, (PARITY_BN_DX, PARITY, PARITY, 0)):
        _close(want, got, tol)
    with pytest.raises(ValueError, match="residual"):
        pb.forward(x, g, b)


def test_batchnorm_running_stats_eval(rng):
    """The GxM moving sums and the use_global_stats eval, against JAX and
    a numpy reference; the fresh state (scf = 0) evaluates with the
    identity statistics."""
    jb, pb = _bn_pair(n=4, c=6, h=5, w=5, mmf=0.9)
    gamma = rng.standard_normal((6,)).astype(np.float32)
    beta = rng.standard_normal((6,)).astype(np.float32)
    x1 = rng.standard_normal((1, 5, 5, 6)).astype(np.float32)
    running, jrunning = pb.init_running(), jb.init_running()
    _close(jb.forward_eval(x1, gamma, beta, jrunning),
           pb.forward_eval(x1, gamma, beta, running), PARITY, "scf=0 eval")
    _close(x1 / np.sqrt(1 + 1e-5) * gamma + beta,
           pb.forward_eval(x1, gamma, beta, running), 1e-6, "identity")
    gm = np.zeros(6)
    gv = np.zeros(6)
    scf = 0.0
    nhw = 4 * 5 * 5
    for step in range(3):
        x = rng.standard_normal((4, 5, 5, 6)).astype(np.float32) * (step + 1)
        running = pb.update_running(running, pb.forward(x, gamma, beta)[1])
        jrunning = jb.update_running(jrunning, jb.forward(x, gamma, beta)[1])
        bm = x.astype(np.float64).mean((0, 1, 2))
        bv = x.astype(np.float64).var((0, 1, 2))
        gm = gm * 0.9 + bm
        gv = gv * 0.9 + bv * nhw / (nhw - 1)
        scf = scf * 0.9 + 1.0
    for f in ("gmean", "gvar", "scf"):
        _close(getattr(jrunning, f), getattr(running, f), PARITY, f)
    xt.check(gm, _np(running.gmean), TOL)
    xt.check(gv, _np(running.gvar), TOL)
    assert abs(float(running.scf) - scf) < 1e-6
    y1 = pb.forward_eval(x1, gamma, beta, running)
    gold = (x1 - gm / scf) / np.sqrt(gv / scf + 1e-5) * gamma + beta
    xt.check(gold, _np(y1), TOL, what="bn eval batch1")
    _close(jb.forward_eval(x1, gamma, beta, jrunning), y1, PARITY)
    y_batch, _ = pb.forward(x1, gamma, beta)
    assert float((y_batch - y1).abs().max()) > 1e-2
    y_exec = pb.execute(pd.Kind.FWD, input=x1, gamma=gamma, beta=beta,
                        running=running)
    assert torch.equal(y_exec, y1)


@pytest.mark.parametrize("fuse", ["RELU", "ELTWISE_RELU", "BN"])
def test_batchnorm_forward_from_moments(rng, fuse):
    """Moments from a conv's BATCH_STATS_FWD give forward's result."""
    jb, pb = _bn_pair(n=2, c=8, h=4, w=4, fuse=pd.BnFuse[fuse])
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    res = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    gamma = rng.standard_normal((8,)).astype(np.float32)
    beta = rng.standard_normal((8,)).astype(np.float32)
    r = res if "ELTWISE" in fuse else None
    mean = x.astype(np.float64).mean((0, 1, 2)).astype(np.float32)
    var = x.astype(np.float64).var((0, 1, 2)).astype(np.float32)
    y, st = pb.forward_from_moments(x, gamma, beta, mean, var, r)
    jy, jst = jb.forward_from_moments(x, gamma, beta, mean, var, r)
    _close(jy, y, PARITY)
    _close(jst.x_hat, st.x_hat, PARITY)
    _close(pb.forward(x, gamma, beta, r)[0], y, 1e-5)
    dy = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    for want, got in zip(jb.backward(dy, gamma, jst),
                         pb.backward(dy, gamma, st)):
        _close(want, got, PARITY_BN_DX)


def test_batchnorm_sync_needs_parallel():
    """Cross-replica BN takes its replicas as a sequence (one controller
    drives the axis); a lone tensor is refused with the reason."""
    bn = pd.create_fusedbatchnorm(pd.BnDesc(n=2, c=4, h=3, w=3),
                                  axis_name="dp")
    assert bn.axis_name == "dp"
    x = torch.ones((2, 3, 3, 4))
    ys, states = bn.forward([x, 2 * x], torch.ones(4), torch.zeros(4))
    assert len(ys) == len(states) == 2
    # the moments are averaged across the replicas: mean 1.5, var 0.25
    assert torch.allclose(states[0].mean, torch.full((4,), 1.5))
    assert torch.allclose(states[1].var, torch.full((4,), 0.25))
    with pytest.raises(ValueError, match="one tensor a replica"):
        bn.forward(x, torch.ones(4), torch.zeros(4))


@pytest.mark.parametrize("replicas", [2, 4])
@pytest.mark.parametrize("fuse", ["BN", "RELU", "ELTWISE_RELU"])
def test_sync_bn_matches_global_batch(rng, replicas, fuse):
    """Cross-replica BN over 2 and 4 replicas equals the single-device BN
    on the whole batch, the port's and the JAX package's (JAX's own check
    is tests/test_dnn.py's test_sync_bn_matches_global_batch), forward and
    backward: y, dx, dgamma, dbeta (and dresidual) at 1e-5."""
    f = getattr(pd.BnFuse, fuse)
    x = rng.standard_normal((8, 4, 4, 6)).astype(np.float32) * 2 + 1
    gamma = rng.standard_normal((6,)).astype(np.float32)
    beta = rng.standard_normal((6,)).astype(np.float32)
    dy = rng.standard_normal((8, 4, 4, 6)).astype(np.float32)
    res = (rng.standard_normal((8, 4, 4, 6)).astype(np.float32)
           if "ELTWISE" in fuse else None)
    jb, pb = _bn_pair(n=8, c=6, h=4, w=4, fuse=f)
    jy, jst = jb.forward(x, gamma, beta, res)
    jback = jb.backward(dy, gamma, jst)
    py, pst = pb.forward(x, gamma, beta, res)
    pback = pb.backward(dy, gamma, pst)
    bn = pd.create_fusedbatchnorm(pd.BnDesc(n=8 // replicas, c=6, h=4, w=4,
                                            fuse=f), axis_name="dp")
    split = lambda v: [torch.from_numpy(p) for p in np.split(v, replicas)]
    ys, sts = bn.forward(split(x), torch.from_numpy(gamma),
                         torch.from_numpy(beta),
                         None if res is None else split(res))
    back = bn.backward(split(dy), torch.from_numpy(gamma), sts)
    got = [torch.cat(ys), torch.cat(back[0]), back[1][0], back[2][0]]
    if res is not None:
        got.append(torch.cat(back[3]))
    for want in ([jy] + list(jback), [py] + list(pback)):
        for name, w, g in zip(("y", "dx", "dgamma", "dbeta", "dresidual"),
                              want, got):
            _close(w, g, PARITY, f"sync bn {name}")
    # every replica carries the same summed dgamma and dbeta
    for r in range(1, replicas):
        assert torch.equal(back[1][r], back[1][0])
        assert torch.equal(back[2][r], back[2][0])


# ------------------------------------------------------- parameters, chain --

def test_dnn_params_from_numpy(rng):
    jb, _ = _bn_pair(n=2, c=4, h=3, w=3)
    running = jb.init_running()
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    (tw, tb), tr = pd.dnn_params_from_numpy((w, b), running, device="cpu")
    assert isinstance(tr, pd.BnRunning) and tr.scf.shape == ()
    assert tw.dtype == torch.float32 and np.array_equal(tw.numpy(), w)
    assert np.array_equal(tb.numpy(), b)
    assert pd.dnn_params_from_numpy(b, device="cpu").shape == (8,)


def test_stage_chain_matches_jax(rng, monkeypatch):
    """One stage-shaped training step at a small size: conv 1x1
    (BATCH_STATS_FWD) -> forward_from_moments (RELU) -> max pool 2x2/s2;
    then the window backward -> BN backward -> conv BWD and UPD, in both
    packages, every output against JAX."""
    monkeypatch.setenv("XSMM_POOL_WINDOW_KERNEL", "1")
    n, c, h, k = 2, 16, 8, 128
    jc, pc = _conv_pair(n=n, c=c, h=h, w=h, k=k, r=1, s=1,
                        fuse_ops=pd.FuseOp.BATCH_STATS_FWD)
    jb, pb = _bn_pair(n=n, c=k, h=h, w=h, fuse=pd.BnFuse.RELU)
    jp, pp = _pool_pair(n=n, c=k, h=h, w=h, r=2, s=2, u=2, v=2)
    assert pp.bwd_kind == jp.bwd_kind == "pallas_window"
    x = rng.standard_normal((n, h, h, c)).astype(np.float32)
    w = (rng.standard_normal((1, 1, c, k)) * 0.3).astype(np.float32)
    gamma = rng.standard_normal((k,)).astype(np.float32)
    beta = rng.standard_normal((k,)).astype(np.float32)
    dz = rng.standard_normal((n, h // 2, h // 2, k)).astype(np.float32)
    cnt = n * h * h

    def step(conv, bn, pool, to_np):
        y, st = conv.forward(x, w)
        mean = st.sum / cnt
        var = st.sumsq / cnt - mean * mean
        a, bst = bn.forward_from_moments(y, gamma, beta, mean, var)
        z = pool.forward(a)
        da = pool.backward(dz, a)
        dy, dg, db = bn.backward(da, gamma, bst)
        return [to_np(v) for v in (y, a, z, da, dy, dg, db,
                                   conv.backward(dy, w),
                                   conv.weight_update(x, dy))]

    want = step(jc, jb, jp, lambda v: np.asarray(v, np.float64))
    got = step(pc, pb, pp, _np)
    names = ("y", "a", "z", "da", "dy", "dgamma", "dbeta", "dx", "dw")
    for name, wv, gv in zip(names, want, got):
        _close(wv, gv, PARITY_BN_DX if name in ("dy", "dx", "dw")
               else PARITY, name)
