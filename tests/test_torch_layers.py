"""xsmm_tpu_torch's layer-graph builder (dnn/layers.py) against xsmm_tpu's,
on the CPU.

Each graph is built by both packages from the same specs and seed; inputs
are made with numpy from a seed.  The port's parameters come from the JAX
package's through ``models.convert.params_from_jax``.  Tolerances, stated
once here:

* initial parameters: bit for bit (the same numpy draws in the same order);
* forwards in f32 (train, eval, with BN state): 1e-4 rel-Frobenius
  (``F32``), BN running state 1e-4 absolute;
* forwards in bf16: 5e-2 (``BF16``: bf16 holds ~3 digits, and the two sum
  in other orders);
* gradients through a graph in f32: 1e-3 (``GRAD``);
* dropout: its rate, scale and eval identity (the bits differ by design:
  the port draws from a ``torch.Generator``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsmm_tpu_torch as xp
from xsmm_tpu.dnn import layers as jl
from xsmm_tpu_torch.dnn import layers as pl
from xsmm_tpu_torch.models import params_from_jax, state_from_jax
from xsmm_tpu_torch.models.engine import tree_flatten_with_path

F32 = 1e-4
BF16 = 5e-2
GRAD = 1e-3

SEQ = [
    {"type": "conv", "k": 8, "r": 3, "stride": 1},
    {"type": "batchnorm", "relu": True},
    {"type": "pooling", "op": "max", "r": 2, "stride": 2, "pad": "valid"},
    {"type": "conv", "k": 6, "r": 3, "stride": 2, "bias": True,
     "relu": True, "init": "xavier"},
    {"type": "pooling", "op": "avg", "r": 3, "stride": 1, "pad": "same"},
    {"type": "global_avg_pool"},
    {"type": "fc", "k": 5},
]
RESIDUAL = [
    {"type": "conv", "k": 4, "r": 3},
    {"type": "branch", "combine": "add", "relu": True, "paths": [
        [{"type": "conv", "k": 4, "r": 3}, {"type": "batchnorm"}],
        [],
    ]},
    {"type": "flatten"},
    {"type": "fc", "k": 3, "relu": True},
    {"type": "fc", "k": 2, "bias": False, "init": "zero"},
]
CONCAT = [{"type": "branch", "combine": "concat", "paths": [
    [{"type": "conv", "k": 4, "r": 1}],
    [{"type": "conv", "k": 6, "r": 3}, {"type": "relu"}],
    [{"type": "pooling", "op": "avg", "r": 3, "stride": 1, "pad": "same"}],
]}, {"type": "conv", "k": 3, "r": 1, "s": 3, "pad": 1}]
GRAPHS = {"sequential": (SEQ, (2, 16, 16, 3)),
          "residual": (RESIDUAL, (2, 8, 8, 3)),
          "concat": (CONCAT, (2, 8, 8, 5))}


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(np.asarray(x, np.float32), np.float64)


def close(want, got, tol, what=""):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert np.isfinite(got).all(), what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= tol, f"{what}: rel-Frobenius {err:.3e} > {tol:g}"


def both(specs, shape, **kw):
    jp, jg = jl.build_graph(specs, shape, **kw)
    pp, pg = pl.build_graph(specs, shape, **kw)
    return jp, jg, pp, pg


def leaves_equal(jtree, ptree):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    pflat = tree_flatten_with_path(ptree)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [k for k, _ in pflat]
    for (k, a), (_, b) in zip(jflat, pflat):
        assert b.dtype == torch.float32, k
        assert np.array_equal(np.asarray(a), b.numpy()), k


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_init_params_bit_identical(name):
    specs, shape = GRAPHS[name]
    jp, jg, pp, pg = both(specs, shape, seed=11)
    leaves_equal(jp, pp)
    assert pg.out_shape == jg.out_shape
    leaves_equal(jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_forward_equals_jax(name, dtype):
    specs, shape = GRAPHS[name]
    jp, jg, _, pg = both(specs, shape, dtype=dtype)
    pp = params_from_jax(jp)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    y = pg(pp, torch.from_numpy(x))
    want = jg(jp, jnp.asarray(x))
    assert str(y.dtype).split(".")[-1] == str(want.dtype)
    close(want, y, F32 if dtype == "float32" else BF16, f"{name} {dtype}")
    # any batch runs through a graph built at a nominal one
    x3 = np.random.default_rng(2).standard_normal((3,) + shape[1:]) \
        .astype(np.float32)
    close(jg(jp, jnp.asarray(x3)), pg(pp, x3),
          F32 if dtype == "float32" else BF16, "batch 3")


@pytest.mark.parametrize("fuse", [False, True])
def test_apply_with_bn_state_equals_jax(fuse):
    specs, shape = GRAPHS["sequential"]
    jp, jg, _, pg = both(specs, shape, fuse_conv_bn=fuse)
    pp = params_from_jax(jp)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jy, js = jg.apply(jp, dict(jg.init_state), jnp.asarray(x), train=True)
    py, ps = pg.apply(pp, state_from_jax(jg.init_state), x, train=True)
    close(jy, py, F32, "train")
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(js)[0],
                              tree_flatten_with_path(ps)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= F32, k
    je, _ = jg.apply(jp, js, jnp.asarray(x[:1]), train=False)
    pe, ps2 = pg.apply(pp, ps, x[:1], train=False)
    assert ps2 is ps
    close(je, pe, F32, "eval on the state")


def test_fuse_conv_bn_equals_unfused():
    """The fused conv+BN build gives the unfused build's outputs, state
    and gradient norms."""
    from xsmm_tpu_torch.models import resnet
    p0, f0 = resnet(depth=18, num_classes=10, width=8,
                    input_shape=(4, 16, 16, 3), seed=3)
    p1, f1 = resnet(depth=18, num_classes=10, width=8,
                    input_shape=(4, 16, 16, 3), seed=3, fuse_conv_bn=True)
    assert len(f1.graph.nodes) < len(f0.graph.nodes)
    assert len(f1.init_state) == len(f0.init_state)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 16, 16, 3)).astype(np.float32))
    close(f0(p0, x), f1(p1, x), F32, "train")
    _, s0 = f0(p0, x, train=True, state=dict(f0.init_state))
    _, s1 = f1(p1, x, train=True, state=dict(f1.init_state))
    for k in s0:
        close(s0[k].gmean, s1[k].gmean, F32, k)
    e0, _ = f0(p0, x, state=s0)
    e1, _ = f1(p1, x, state=s1)
    close(e0, e1, F32, "eval")

    def gnorm(p, f):
        leaves = [t.requires_grad_() for _, t in
                  tree_flatten_with_path(p["layers"])]
        (f(p, x) ** 2).sum().backward()
        return sum(float(t.grad.abs().sum()) for t in leaves)

    n0, n1 = gnorm(p0, f0), gnorm(p1, f1)
    assert abs(n0 - n1) / n0 < GRAD, (n0, n1)


def test_grad_through_graph_equals_jax():
    specs = [
        {"type": "conv", "k": 4, "r": 3, "bias": True, "relu": True},
        {"type": "conv", "k": 4, "r": 3, "stride": 2},
        {"type": "batchnorm", "relu": True},
        {"type": "global_avg_pool"},
        {"type": "fc", "k": 3},
    ]
    jp, jg, _, pg = both(specs, (2, 8, 8, 3))
    pp = params_from_jax(jp)
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 3)) \
        .astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jg(p, jnp.asarray(x)) ** 2))(jp)
    leaves = [t.requires_grad_() for _, t in tree_flatten_with_path(pp)]
    (pg(pp, torch.from_numpy(x)) ** 2).sum().backward()
    for (k, g), t in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                         leaves):
        close(g, t.grad, GRAD, jax.tree_util.keystr(k))


def test_dropout_train_vs_eval():
    _, g = pl.build_graph([{"type": "dropout", "rate": 0.5}],
                          (4, 4, 4, 2))
    x = torch.ones((64, 16, 16, 2))
    assert torch.equal(g([None], x), x)                       # eval
    y = g([None], x, train=True, rng=torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}  # keep 0.5, scale 2
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.02
    with pytest.raises(ValueError, match="rng"):
        g([None], x, train=True)
    y2 = pl.dropout(x, 0.25, gen=torch.Generator().manual_seed(1),
                    train=True)
    assert set(torch.unique(y2).tolist()) <= {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((y2 == 0).float().mean()) - 0.25) < 0.02
    assert pl.dropout(x, 0.5, gen=None, train=False) is x
    xb = x.bfloat16()
    assert pl.dropout(xb, 0.5, gen=torch.Generator(), train=True).dtype \
        == torch.bfloat16


def test_functional_nodes_equal_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for relu in (False, True):
        close(jl.eltwise_add(jnp.asarray(a), jnp.asarray(b), relu),
              pl.eltwise_add(ta, tb, relu), 0.0, f"eltwise relu={relu}")
    close(jl.concat([a, b]), pl.concat([ta, tb]), 0.0, "concat")
    assert pl.split(ta, 3) == (ta, ta, ta)
    close(jl.global_avg_pool(jnp.asarray(a)), pl.global_avg_pool(ta), 1e-6,
          "gap")
    close(jl.flatten(jnp.asarray(a)), pl.flatten(ta), 0.0, "flatten")


def test_bad_specs_raise():
    with pytest.raises(ValueError, match="unknown layer type"):
        pl.build_graph([{"type": "softmax"}], (1, 4, 4, 1))
    with pytest.raises(ValueError, match="concat branches"):
        pl.build_graph([{"type": "branch", "paths": [
            [{"type": "conv", "k": 2, "r": 1, "stride": 2}], []]}],
            (1, 4, 4, 1))


def test_forward_flops_count_the_descriptors():
    _, g = pl.build_graph(SEQ, (2, 16, 16, 3))
    want = (2 * 2 * 16 * 16 * 8 * 3 * 9 + 2 * 2 * 4 * 4 * 6 * 8 * 9
            + 2 * 2 * 6 * 5)
    assert g.forward_flops() == want
    assert g.forward_flops(batch=4) == 2 * want
    assert [k for k, _ in g.layers] == ["conv", "conv", "fc"]
