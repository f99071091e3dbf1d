"""xsmm_tpu_torch's model zoo (models/{resnet,toynets,alexnet,googlenet,
inception}.py) against xsmm_tpu's, on the CPU.

Each member is built by both packages with the same arguments; inputs are
made with numpy from a seed; the port's parameters and BN state come from
the JAX package's through ``models.convert``.  Tolerances, stated once:

* initial parameters: bit for bit, every member;
* forwards in f32 (train mode, eval on the BN state): 1e-4 rel-Frobenius
  (``F32``); in bf16: 5e-2 (``BF16``);
* the batch-statistics forwards of ResNet-50 and Inception-v3 at these
  sizes: 1e-3 (``DEEP_BN``).  They are ill-conditioned: one f32 ulp on
  each input moves the port's own output by 1.1e-4 (ResNet-50, width 4,
  8x64x64) and 1.9e-4 (Inception-v3, width 8, 8x32x32), so two packages that sum
  in other orders part by a few times that;
* the logits' dtype is the JAX package's (bf16 in a bf16 model).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsmm_tpu.models as jm
import xsmm_tpu_torch as xp
import xsmm_tpu_torch.models as pm
from xsmm_tpu_torch.models import params_from_jax, state_from_jax
from xsmm_tpu_torch.models.engine import tree_flatten_with_path

F32 = 1e-4
BF16 = 5e-2
DEEP_BN = 1e-3

# name -> (builder, kwargs, input shape); batch 8 where BN's last stages
# are 1x1: a batch of 2 would normalize pairs of values, where E[x^2] -
# mean^2 cancels to rounding noise in either package
ZOO = {
    "resnet18": ("resnet", dict(depth=18, num_classes=10, width=8),
                 (8, 16, 16, 3)),
    "resnet34": ("resnet", dict(depth=34, num_classes=10, width=4),
                 (8, 16, 16, 3)),
    "resnet50": ("resnet", dict(depth=50, num_classes=10, width=4),
                 (8, 64, 64, 3)),
    "lenet": ("lenet", dict(num_classes=10), (2, 28, 28, 1)),
    "cifar10net": ("cifar10net", dict(num_classes=10), (2, 32, 32, 3)),
    "alexnet": ("alexnet", dict(num_classes=10), (2, 64, 64, 3)),
    "googlenet": ("googlenet", dict(num_classes=10, width=8),
                  (2, 32, 32, 3)),
    "inception_v3": ("inception_v3", dict(num_classes=10, width=8),
                     (8, 64, 64, 3)),
}


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved)


def close(want, got, tol, what=""):
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    got = got.detach().double().numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert np.isfinite(got).all(), what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= tol, f"{what}: rel-Frobenius {err:.3e} > {tol:g}"


def build(name, dtype="float32", **extra):
    fn, kw, shape = ZOO[name]
    kw = dict(kw, input_shape=shape, dtype=dtype, **extra)
    return getattr(jm, fn)(**kw), getattr(pm, fn)(**kw), shape


@pytest.mark.parametrize("name", sorted(ZOO))
def test_init_bit_identical(name):
    (jp, jf), (pp, pf), _ = build(name)
    jflat = jax.tree_util.tree_flatten_with_path(jp["layers"])[0]
    pflat = tree_flatten_with_path(pp["layers"])
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [k for k, _ in pflat]
    for (k, a), (_, b) in zip(jflat, pflat):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        assert np.array_equal(np.asarray(a), b.numpy()), k
    assert pp["_meta"] == jp["_meta"]
    assert pf.aux_loss_weights == jf.aux_loss_weights
    assert sorted(pf.init_state) == sorted(jf.init_state)
    assert pf.graph.out_shape == jf.graph.out_shape


def _forwards(name, dtype, tol, stateful=True):
    (jp, jf), (_, pf), shape = build(name, dtype)
    pp = params_from_jax(jp)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jf(jp, jnp.asarray(x))
    got = pf(pp, x)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    close(want, got, tol, f"{name} {dtype} forward")
    if jf.init_state and stateful:
        # the rngs feed dropout nodes of rate 0 (Inception-v3's aux head)
        jy, js = jf(jp, jnp.asarray(x), train=True,
                    state=dict(jf.init_state), rng=jax.random.PRNGKey(0))
        py, ps = pf(pp, x, train=True, state=state_from_jax(jf.init_state),
                    rng=torch.Generator())
        if isinstance(jy, tuple):
            assert len(jy) == len(py)
            for a, b in zip(jy[1:], py[1:]):
                close(a, b, tol, f"{name} {dtype} aux logits")
            jy, py = jy[0], py[0]
        close(jy, py, tol, f"{name} {dtype} apply train")
        je, _ = jf(jp, jnp.asarray(x), state=js)
        pe, _ = pf(pp, x, state=ps)
        close(je, pe, tol, f"{name} {dtype} apply eval")


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "lenet",
                                  "cifar10net", "alexnet", "googlenet",
                                  "inception_v3"])
def test_forward_equals_jax_f32(name):
    # Inception-v3's forward alone: the JAX package compiles each of its
    # ~100 handles once a path, and ResNet-18/50 cover the BN state's
    _forwards(name, "float32",
              DEEP_BN if name in ("resnet50", "inception_v3") else F32,
              stateful=name != "inception_v3")


@pytest.mark.parametrize("name", ["resnet18", "lenet"])
def test_forward_equals_jax_bf16(name):
    _forwards(name, "bfloat16", BF16)


def test_aux_taps_train_only_with_their_weights():
    """GoogLeNet's two taps (weight 0.3) and Inception-v3's one (0.4) add
    logits in train mode only; eval gives the bare logits."""
    (_, jf), (pp, pf), shape = build("googlenet")
    assert pf.aux_loss_weights == (0.3, 0.3) == jf.aux_loss_weights
    assert pp["_meta"]["aux_heads"] == 2
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    out = pf(pp, x, train=True, rng=torch.Generator().manual_seed(0))
    assert isinstance(out, tuple) and len(out) == 3
    assert all(o.shape == (shape[0], 10) for o in out)
    ev = pf(pp, x)
    assert isinstance(ev, torch.Tensor) and ev.shape == (shape[0], 10)
    # zero-init heads: the main logits start uniform, and the train-mode
    # trunk is the eval trunk
    assert torch.equal(out[0], ev)
    (_, jf3), (pp3, pf3), _ = build("inception_v3")
    assert pf3.aux_loss_weights == (0.4,) == jf3.aux_loss_weights
    assert len(pp3["_meta"]["kinds"]) == 11
    assert sum(isinstance(p, list) for p in pp3["layers"]) == 12
    (_, _), (pn, pfn), _ = build("googlenet", aux=False)
    assert pfn.aux_loss_weights == () and pn["_meta"]["aux_heads"] == 0


def test_alexnet_dropout_fires_in_train_only():
    (_, _), (pp, pf), shape = build("alexnet")
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ev = pf(pp, x)
    assert torch.equal(ev, pf(pp, x))
    tr = pf(pp, x, train=True, rng=torch.Generator().manual_seed(0))
    assert not torch.equal(tr, ev)
    with pytest.raises(ValueError, match="rng"):
        pf(pp, x, train=True)
