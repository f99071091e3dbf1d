"""xsmm_tpu_torch's training engine (models/engine.py) against xsmm_tpu's,
on the CPU.

Both engines start from the same parameters (the port's through
``models.convert``) and take the same numpy batches.  Tolerances, stated
once here:

* the loss of a step: 1e-5 relative (``LOSS``);
* each parameter's update p' - p after a step, f32: 1e-3 rel-Frobenius
  (``UPDATE``, the repo's gate); bf16: 1e-1 (``UPDATE_BF16``: every
  backward conv rounds its output to bf16, and the two packages sum in
  other orders, so the roundings part in places and carry through the
  layers below; measured 5.3e-2 at most on ResNet-18 width 8);
* the BN running state: 1e-4 absolute (``STATE``);
* schedules: the same lr to 1e-12;
* a JAX checkpoint resumed by the port, then one more step on both: 1e-3.

The JAX engine's f32 run is made once for the module (``jax_run``), since
its train step compiles once per engine.
"""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

import xsmm_tpu.models as jm
import xsmm_tpu_torch as xp
import xsmm_tpu_torch.models as pm
from xsmm_tpu.models import engine as je
from xsmm_tpu.parallel.mesh import make_mesh
from xsmm_tpu_torch.models import engine as pe
from xsmm_tpu_torch.models import params_from_jax
from xsmm_tpu_torch.models.engine import tree_flatten_with_path
from xsmm_tpu_torch.parallel import mesh as pmesh

LOSS = 1e-5
UPDATE = 1e-3
UPDATE_BF16 = 1e-1
STATE = 1e-4


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved)


def mesh1():
    """The JAX engine's mesh over every (virtual CPU) device."""
    return make_mesh((len(jax.devices()), 1), ("dp", "mp"))


def port_mesh(dp, mp=1):
    """The port's mesh of dp x mp ranks, every one on the CPU."""
    return pmesh.make_mesh((dp, mp), devices=["cpu"] * (dp * mp))


def flat(tree):
    return [(k, np.asarray(v, np.float64)) for k, v in
            ((jax.tree_util.keystr(k), v) for k, v in
             jax.tree_util.tree_flatten_with_path(tree)[0])]


def pflat(tree):
    return [(k, v.detach().double().numpy())
            for k, v in tree_flatten_with_path(tree)]


def rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


def check_updates(j_eng, p_eng, p0, tol):
    """Each leaf's update p' - p of both engines from the common p0."""
    base = dict(flat(p0))
    for (k, a), (kp, b) in zip(flat(j_eng.params), pflat(p_eng.params)):
        assert k == kp
        err = rel(a - base[k], b - base[k])
        assert err <= tol, f"{k}: update rel-Frobenius {err:.3e} > {tol:g}"


def check_state(j_eng, p_eng):
    for (k, a), (kp, b) in zip(flat(j_eng.state), pflat(p_eng.state)):
        assert k == kp and np.abs(a - b).max() <= STATE, k


def engines(builder, solver, **kw):
    jp, jf = getattr(jm, builder)(**kw)
    _, pf = getattr(pm, builder)(**kw)
    j_eng = je.MLEngine(jp, jf, je.SolverConfig(**solver), mesh=mesh1())
    p_eng = pe.MLEngine(params_from_jax(jp), pf, pe.SolverConfig(**solver))
    return jp, j_eng, p_eng


RESNET = dict(depth=18, num_classes=10, width=8, input_shape=(8, 16, 16, 3))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's run that the f32 tests compare with, made once (its
    train step compiles once): a step, a checkpoint ("one"), a second
    step, a validate pass."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    jp, jf = jm.resnet(**RESNET)
    eng = je.MLEngine(jp, jf, je.SolverConfig(lr=0.05), mesh=mesh1(),
                      checkpoint_dir=d)
    b1, b2 = list(je.template_batches(2, 8, hw=16))
    val = list(je.template_batches(2, 8, hw=16, epoch=7))
    o1 = eng.train_epoch(iter([b1]), verbose=False)
    after1 = (eng.params, eng.state, eng.step)
    eng.checkpoint(tag="one")
    o2 = eng.train_epoch(iter([b2]), verbose=False)
    return {"p0": {"layers": jp["layers"]}, "jp": jp, "dir": d,
            "batches": (b1, b2), "val": val, "loss1": o1["loss"],
            "after1": after1, "loss2": o2["loss"], "eng": eng,
            "metrics": eng.validate(iter(val))}


def port_engine(params, **kw):
    _, pf = pm.resnet(**RESNET)
    return pe.MLEngine(params, pf, pe.SolverConfig(lr=0.05), **kw)


def test_one_step_equals_jax(jax_run):
    p_eng = port_engine(params_from_jax(jax_run["jp"]))
    po = p_eng.train_epoch(iter(jax_run["batches"][:1]), verbose=False)
    assert abs(po["loss"] - jax_run["loss1"]) <= LOSS * abs(jax_run["loss1"])
    assert p_eng.step == 1
    params, state, _ = jax_run["after1"]
    j = types.SimpleNamespace(params=params, state=state)
    check_updates(j, p_eng, jax_run["p0"], UPDATE)
    check_state(j, p_eng)
    # every trainable leaf moved (BN gamma/beta and biases included)
    for (k, a), (_, b) in zip(flat(jax_run["p0"]), pflat(p_eng.params)):
        assert not np.array_equal(a, b), k


def test_one_step_bf16_equals_jax():
    jp, j_eng, p_eng = engines(
        "resnet", dict(lr=0.05, momentum=0.9, weight_decay=1e-4),
        dtype="bfloat16", **RESNET)
    x, y = next(je.template_batches(1, 8, hw=16))
    jo = j_eng.train_epoch(iter([(x, y)]), verbose=False)
    po = p_eng.train_epoch(iter([(x, y)]), verbose=False)
    assert abs(po["loss"] - jo["loss"]) <= LOSS * abs(jo["loss"])
    check_updates(j_eng, p_eng, {"layers": jp["layers"]}, UPDATE_BF16)
    check_state(j_eng, p_eng)


def test_two_steps_with_momentum_and_aux_loss_equal_jax():
    """A trunk with a dropout-free aux tap (weight 0.25): the weighted
    multi-loss, then the momentum of the first step in the second."""
    specs = [
        {"type": "conv", "k": 6, "r": 3, "bias": True, "relu": True},
        {"type": "aux_head", "classes": 5, "weight": 0.25, "conv_k": 4,
         "fc": 8, "dropout": 0.0},
        {"type": "conv", "k": 8, "r": 3, "stride": 2},
        {"type": "batchnorm", "relu": True},
        {"type": "global_avg_pool"},
        {"type": "fc", "k": 5},
    ]
    from xsmm_tpu.dnn import layers as jl
    from xsmm_tpu_torch.dnn import layers as pl
    jparams, jg = jl.build_graph(specs, (8, 8, 8, 3))
    _, pg = pl.build_graph(specs, (8, 8, 8, 3))
    jf, pf = jl.make_model_forward(jg), pl.make_model_forward(pg)
    assert pf.aux_loss_weights == jf.aux_loss_weights == (0.25,)
    solver = dict(lr=0.1, momentum=0.9, weight_decay=1e-3)
    jp = {"layers": jparams, "_meta": {}}
    j_eng = je.MLEngine(jp, jf, je.SolverConfig(**solver), mesh=mesh1())
    p_eng = pe.MLEngine(params_from_jax(jp), pf, pe.SolverConfig(**solver))
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((8, 8, 8, 3)).astype(np.float32),
                rng.integers(0, 5, (8,)).astype(np.int32))
               for _ in range(2)]
    jo = j_eng.train_epoch(iter(batches), verbose=False)
    po = p_eng.train_epoch(iter(batches), verbose=False)
    assert abs(po["loss"] - jo["loss"]) <= LOSS * abs(jo["loss"])
    check_updates(j_eng, p_eng, {"layers": jparams}, UPDATE)
    for (k, a), (_, b) in zip(flat(j_eng.momentum), pflat(p_eng.momentum)):
        assert rel(a, b) <= UPDATE, k
    check_state(j_eng, p_eng)


@pytest.mark.parametrize("cfg,epochs", [
    (dict(lr=1.0, lr_policy="fixed"), (0, 3, 50)),
    (dict(lr=1.0, lr_policy="step", gamma=0.1, step_epochs=(2, 4)),
     (0, 1, 2, 3, 4, 9)),
    (dict(lr=0.5, lr_policy="poly", max_epochs=10, power=2.0),
     (0, 2.5, 5, 9)),
    (dict(lr=1.0, lr_policy="inv", gamma=0.5, power=2.0), (0, 1, 2, 7)),
    (dict(lr=1.0, lr_policy="step", gamma=0.1, step_epochs=(6,),
          warmup_epochs=4, warmup_lr=0.1), (0, 1, 2, 4, 5, 6, 8)),
])
def test_schedules_equal_jax(cfg, epochs):
    for e in epochs:
        want = je._schedule(je.SolverConfig(**cfg), e)
        assert pe._schedule(pe.SolverConfig(**cfg), e) == \
            pytest.approx(want, rel=1e-12, abs=1e-12)


def test_validate_equals_jax(jax_run):
    p_eng = port_engine(params_from_jax(jax_run["jp"]))
    p_eng.train_epoch(iter(jax_run["batches"]), verbose=False)
    jv, pv = jax_run["metrics"], p_eng.validate(iter(jax_run["val"]))
    assert pv["loss"] == pytest.approx(jv["loss"], rel=1e-3)
    assert pv["acc"] == jv["acc"] and pv["acc5"] == jv["acc5"]
    assert 0 <= pv["acc"] <= pv["acc5"] <= 1


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    """JAX trained one step and checkpointed; the port resumes it (the same
    file names and keys) into an engine built afresh, and one more step on
    both agrees."""
    pp, _ = pm.resnet(**RESNET)
    p_eng = port_engine(pp, checkpoint_dir=jax_run["dir"])
    assert p_eng.resume(tag="one")
    params1, _, step1 = jax_run["after1"]
    assert (p_eng.epoch, p_eng.step) == (1, step1) == (1, 1)
    for (k, a), (_, b) in zip(flat(params1), pflat(p_eng.params)):
        assert np.array_equal(a, b), k
    po = p_eng.train_epoch(iter(jax_run["batches"][1:]), verbose=False)
    assert abs(po["loss"] - jax_run["loss2"]) <= 1e-3 * abs(jax_run["loss2"])
    check_updates(jax_run["eng"], p_eng, params1, UPDATE)
    check_state(jax_run["eng"], p_eng)


def test_port_checkpoint_round_trip(tmp_path):
    kw = dict(depth=18, num_classes=10, width=4, input_shape=(4, 16, 16, 3))
    pp, pf = pm.resnet(**kw)
    d = str(tmp_path)
    eng = pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.01, step_epochs=(1,)),
                      checkpoint_dir=d)
    eng.train_epoch(pe.synthetic_batches(2, 4, hw=16), verbose=False)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"{n}_{t}.{e}" for t in ("latest", "epoch1")
                           for n, e in (("params", "npz"),
                                        ("momentum", "npz"),
                                        ("state", "npz"), ("meta", "json")))
    assert json.load(open(tmp_path / "meta_latest.json"))["step"] == 2
    with np.load(tmp_path / "params_latest.npz") as z:
        assert "['layers'][0]['w']" in z.files
    with np.load(tmp_path / "state_latest.npz") as z:
        assert "['bn0'].scf" in z.files
    pp2, _ = pm.resnet(**kw)
    eng2 = pe.MLEngine(pp2, pf, pe.SolverConfig(lr=0.01), checkpoint_dir=d)
    assert eng2.resume() and (eng2.epoch, eng2.step) == (1, 2)
    for tree in ("params", "momentum", "state"):
        for (k, a), (_, b) in zip(pflat(getattr(eng, tree)),
                                  pflat(getattr(eng2, tree))):
            assert np.array_equal(a, b), (tree, k)
    assert not pe.MLEngine(pp2, pf, pe.SolverConfig(),
                           checkpoint_dir=str(tmp_path / "none")).resume()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        pe.MLEngine(pp2, pf, pe.SolverConfig()).checkpoint()


def test_engine_owns_its_tensors():
    """The engine trains copies: the caller's parameters stay as built."""
    pp, pf = pm.resnet(depth=18, num_classes=10, width=4,
                       input_shape=(4, 16, 16, 3))
    before = pflat(pp["layers"])
    eng = pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.1))
    eng.train_epoch(pe.synthetic_batches(1, 4, hw=16), verbose=False)
    for (k, a), (_, b) in zip(before, pflat(pp["layers"])):
        assert np.array_equal(a, b), k
    assert eng.state["bn0"].scf.item() == 1.0
    assert pf.init_state["bn0"].scf.item() == 0.0


def test_host_batch_sources_equal_jax():
    for fn, kw in (("synthetic_batches", dict(hw=8, classes=7, seed=3)),
                   ("template_batches", dict(hw=8, classes=7, seed=3,
                                             sigma=1.5, epoch=2))):
        for (xj, yj), (xp_, yp) in zip(getattr(je, fn)(3, 5, **kw),
                                       getattr(pe, fn)(3, 5, **kw)):
            assert np.array_equal(xj, xp_) and np.array_equal(yj, yp)


def test_device_batch_makers():
    """Same distributions as the JAX package's device makers, not the
    same bits: shapes, dtypes, label range, template structure."""
    gen = torch.Generator().manual_seed(0)
    x, y = pe.synthetic_batch_fn(64, hw=4, classes=5)(gen)
    assert x.shape == (64, 4, 4, 3) and x.dtype == torch.float32
    assert y.dtype == torch.int32 and 0 <= int(y.min()) <= int(y.max()) < 5
    bf = pe.template_batch_fn(256, hw=4, classes=3, sigma=0.0)
    x, y = bf(gen)
    for c in range(3):   # sigma 0: every sample is its class's template
        assert torch.equal(x[y == c], x[y == c][:1].expand_as(x[y == c]))
    xs = [b for b, _ in pe.device_template_batches(2, 8, hw=4, sigma=0.6)]
    assert len(xs) == 2 and not torch.equal(xs[0], xs[1])
    assert len(list(pe.device_synthetic_batches(3, 2, hw=4))) == 3
    # over a mesh: each batch split along "dp" over the ranks
    mesh = port_mesh(4)
    x, y = next(pe.device_synthetic_batches(1, 8, hw=4, classes=5,
                                            sharding=pmesh.dp_sharding(mesh)))
    assert isinstance(x, pmesh.Sharded) and x.shape == (8, 4, 4, 3)
    assert len(x.shards) == 4 and tuple(x.shards[0].shape) == (2, 4, 4, 3)
    assert y.shape == (8,) and tuple(y.spec) == ("dp",)
    assert 0 <= int(y.gather().min()) <= int(y.gather().max()) < 5


def test_scan_epoch_equals_eager_loop_and_learns():
    """On the CPU ``train_epoch_scan`` runs its steps eagerly; they are
    the steps of ``train_epoch`` over the same generator's batches."""
    params, fwd = pm.lenet(num_classes=10)
    a = pe.MLEngine(params, fwd, pe.SolverConfig(lr=0.002))
    b = pe.MLEngine(params, fwd, pe.SolverConfig(lr=0.002))
    bf = pe.template_batch_fn(16, hw=28, classes=10, chans=1)
    gen = torch.Generator().manual_seed(b.scan_seed(0))
    first = a.train_epoch_scan(4, bf, 16, verbose=False)
    ref = b.train_epoch((bf(gen) for _ in range(4)), verbose=False)
    assert first["losses"] == ref["losses"] and len(first["losses"]) == 4
    for _ in range(8):
        last = a.train_epoch_scan(4, bf, 16, verbose=False)
    assert a.step == 36 and a.epoch == 9
    assert last["loss"] < first["loss"], (first["loss"], last["loss"])


def test_mesh_raises_and_dropout_fires():
    """A port mesh is taken (dropout fires over its ranks too); the JAX
    package's mesh is not one."""
    params, fwd = pm.alexnet(num_classes=10, input_shape=(4, 64, 64, 3))
    with pytest.raises(ValueError, match="parallel.mesh.Mesh"):
        pe.MLEngine(params, fwd, pe.SolverConfig(), mesh=mesh1())
    on_mesh = pe.MLEngine(params, fwd, pe.SolverConfig(lr=0.0,
                                                       weight_decay=0.0,
                                                       momentum=0.0),
                          mesh=port_mesh(2))
    eng = pe.MLEngine(params, fwd, pe.SolverConfig(lr=0.0, weight_decay=0.0,
                                                   momentum=0.0))
    assert eng._train_kwargs
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, (4,)).astype(np.int32)
    out = eng.train_epoch(iter([(x, y)]), verbose=False)
    ev = eng.validate(iter([(x, y)]))
    assert not np.isclose(out["loss"], ev["loss"], rtol=1e-6)
    out = on_mesh.train_epoch(iter([(x, y)]), verbose=False)
    ev2 = on_mesh.validate(iter([(x, y)]))
    assert not np.isclose(out["loss"], ev2["loss"], rtol=1e-6)
    assert ev2["loss"] == pytest.approx(ev["loss"], rel=1e-5)


def test_training_converges():
    """The template task: the loss falls and eval on the running stats is
    far above chance (tests/test_models.py's criterion)."""
    params, fwd = pm.resnet(depth=18, num_classes=10, width=8,
                            input_shape=(32, 16, 16, 3))
    eng = pe.MLEngine(params, fwd, pe.SolverConfig(lr=0.01))
    losses = [eng.train_epoch(pe.template_batches(10, 32, hw=16, sigma=0.3,
                                                  epoch=ep),
                              verbose=False)["loss"] for ep in range(2)]
    val = eng.validate(pe.template_batches(2, 64, hw=16, sigma=0.3,
                                           epoch=99))
    assert losses[-1] < 0.6 * losses[0], losses
    assert val["acc"] >= 0.6, (val, losses)


# ----------------------------------------------------------- over a mesh --


def check_momentum(j_eng, p_eng):
    for (k, a), (_, b) in zip(flat(j_eng.momentum), pflat(p_eng.momentum)):
        assert rel(a, b) <= UPDATE, k


def check_replicas(p_eng):
    """Every rank's replica of the parameters, momentum and BN state is
    rank 0's, bit for bit."""
    for reps in (p_eng._rep_params, p_eng._rep_moms, p_eng._rep_states):
        for rep in reps[1:]:
            for (k, a), (_, b) in zip(pflat(reps[0]), pflat(rep)):
                assert np.array_equal(a, b), k


def test_mesh_engine_equals_jax(jax_run):
    """The port's engine over make_mesh((4, 1)) against the JAX engine over
    its 8-device mesh, two steps on the same batches, each from the same
    state: step 1 from the initial parameters; step 2 resumed on the mesh
    from the JAX engine's checkpoint after step 1.  Loss, every update,
    the momentum and the BN state at the module's tolerances."""
    p_eng = port_engine(params_from_jax(jax_run["jp"]), mesh=port_mesh(4))
    po = p_eng.train_epoch(iter(jax_run["batches"][:1]), verbose=False)
    assert abs(po["loss"] - jax_run["loss1"]) <= LOSS * abs(jax_run["loss1"])
    params, state, _ = jax_run["after1"]
    j = types.SimpleNamespace(params=params, state=state)
    check_updates(j, p_eng, jax_run["p0"], UPDATE)
    check_state(j, p_eng)
    check_replicas(p_eng)
    pp, _ = pm.resnet(**RESNET)
    p2 = port_engine(pp, mesh=port_mesh(4), checkpoint_dir=jax_run["dir"])
    assert p2.resume(tag="one") and p2.step == 1
    check_replicas(p2)
    po = p2.train_epoch(iter(jax_run["batches"][1:]), verbose=False)
    assert abs(po["loss"] - jax_run["loss2"]) <= LOSS * abs(jax_run["loss2"])
    check_updates(jax_run["eng"], p2, params, UPDATE)
    check_momentum(jax_run["eng"], p2)
    check_state(jax_run["eng"], p2)
    check_replicas(p2)


@pytest.mark.parametrize("dp", [2, 4])
def test_mesh_step_equals_one_device(dp):
    """A (dp, 1) step equals the one-device engine's on the whole batch
    (the loss, each leaf's update, the BN state), and a (2, 2) mesh's mp
    ranks are replicas of their dp rank.  One step from the same state:
    over two, the roundings of the first step's sums (in another order on
    the ranks) move the second step's loss by ~2e-5, as they move the
    one-device engine's against the JAX package's by ~1e-5."""
    pp, pf = pm.resnet(**RESNET)
    batches = list(pe.template_batches(1, 8, hw=16))
    one = pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.05))
    lo = one.train_epoch(iter(batches), verbose=False)["losses"]
    base = dict(pflat({"layers": pp["layers"]}))
    for mesh in (port_mesh(dp), port_mesh(2, 2)):
        eng = pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.05), mesh=mesh)
        lm = eng.train_epoch(iter(batches), verbose=False)["losses"]
        assert np.allclose(lo, lm, rtol=LOSS, atol=0)
        for (k, a), (_, b) in zip(pflat(one.params), pflat(eng.params)):
            assert rel(a - base[k], b - base[k]) <= UPDATE, k
        for (k, a), (_, b) in zip(pflat(one.state), pflat(eng.state)):
            assert np.abs(a - b).max() <= STATE, k
        check_replicas(eng)


def test_mesh_scan_epoch_and_validate():
    """``train_epoch_scan`` over the mesh (eager on the CPU) runs the
    steps of ``train_epoch`` on the same generator's batches, and
    ``validate`` over the mesh equals the one-device engine's."""
    params, fwd = pm.lenet(num_classes=10)
    mesh = port_mesh(2)
    a = pe.MLEngine(params, fwd, pe.SolverConfig(lr=0.002), mesh=mesh)
    b = pe.MLEngine(params, fwd, pe.SolverConfig(lr=0.002), mesh=mesh)
    bf = pe.template_batch_fn(16, hw=28, classes=10, chans=1)
    gen = torch.Generator().manual_seed(b.scan_seed(0))
    first = a.train_epoch_scan(4, bf, 16, verbose=False)
    ref = b.train_epoch((bf(gen) for _ in range(4)), verbose=False)
    assert first["losses"] == ref["losses"] and a.step == 4
    check_replicas(a)
    one = pe.MLEngine(params, fwd, pe.SolverConfig(lr=0.002))
    one.train_epoch_scan(4, bf, 16, verbose=False)
    val = list(pe.template_batches(2, 16, hw=28, classes=10, chans=1,
                                   epoch=3))
    va, vo = a.validate(iter(val)), one.validate(iter(val))
    assert va["loss"] == pytest.approx(vo["loss"], rel=1e-4)
    assert va["acc"] == vo["acc"] and va["acc5"] == vo["acc5"]


def test_mesh_checkpoint_resume_across_single_device(tmp_path):
    """A mesh engine's checkpoint (rank 0's replica, the same files and
    keys) resumes in a one-device engine, and back: every replica takes
    it."""
    kw = dict(depth=18, num_classes=10, width=4, input_shape=(4, 16, 16, 3))
    pp, pf = pm.resnet(**kw)
    d = str(tmp_path)
    eng = pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.01), mesh=port_mesh(2),
                      checkpoint_dir=d)
    eng.train_epoch(pe.synthetic_batches(2, 4, hw=16), verbose=False)
    one = pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.01), checkpoint_dir=d)
    assert one.resume() and (one.epoch, one.step) == (1, 2)
    for tree in ("params", "momentum", "state"):
        for (k, a), (_, b) in zip(pflat(getattr(eng, tree)),
                                  pflat(getattr(one, tree))):
            assert np.array_equal(a, b), (tree, k)
    one.train_epoch(pe.synthetic_batches(1, 4, hw=16, seed=5), verbose=False)
    one.checkpoint(tag="one")
    back = pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.01), mesh=port_mesh(4),
                       checkpoint_dir=d)
    assert back.resume(tag="one") and back.step == 3
    check_replicas(back)
    for (k, a), (_, b) in zip(pflat(one.params), pflat(back.params)):
        assert np.array_equal(a, b), k


# ------------------------------------------------------ the compiled form --

from test_torch_parallel import cpu_graphs  # noqa: E402,F401  (a fixture)


def test_engine_runs_eagerly_on_the_cpu():
    """On the CPU target the engine's steps count "eager" (train_epoch,
    validate and the scan epoch), and ``compiled=True`` raises."""
    pp, pf = pm.lenet(num_classes=10)
    eng = pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.002))
    assert eng.compiled is False
    batches = list(pe.template_batches(2, 8, hw=28, classes=10, chans=1))
    eng.train_epoch(iter(batches), verbose=False)
    eng.validate(iter(batches[:1]))
    eng.train_epoch_scan(3, pe.template_batch_fn(8, hw=28, classes=10,
                                                 chans=1), 8, verbose=False)
    assert eng.forms == {"graph": 0, "graph_copy": 0, "eager": 6,
                         "captures": 0}
    for mesh in (None, port_mesh(2)):
        with pytest.raises(ValueError, match="compiled=True"):
            pe.MLEngine(pp, pf, pe.SolverConfig(), mesh=mesh, compiled=True)


@pytest.mark.parametrize("dp", [1, 2])
def test_compiled_train_epoch_and_validate_equal_eager(cpu_graphs, dp):
    """``train_epoch`` and ``validate`` in the compiled form (graphs stood
    in by test_torch_parallel's ``_Rerun``) against the eager form over 3
    steps of ResNet-18 (one device, and dp = 2 in lock-step): the losses,
    parameters, momentum, BN state and metrics bit for bit; the first step
    of a key captures, the later ones copy their batch in; a new batch
    shape captures anew."""
    pp, pf = pm.resnet(**RESNET)
    mesh = None if dp == 1 else port_mesh(dp)
    engs = [pe.MLEngine(pp, pf, pe.SolverConfig(lr=0.05), mesh=mesh,
                        compiled=c) for c in (None, False)]
    assert engs[0].compiled and not engs[1].compiled
    batches = list(pe.template_batches(3, 8, hw=16))
    val = list(pe.template_batches(2, 8, hw=16, epoch=5))
    outs = [e.train_epoch(iter(batches), verbose=False) for e in engs]
    assert outs[0]["losses"] == outs[1]["losses"]
    for tree in ("params", "momentum", "state"):
        for (k, a), (_, b) in zip(pflat(getattr(engs[0], tree)),
                                  pflat(getattr(engs[1], tree))):
            assert np.array_equal(a, b), (tree, k)
    assert [e.validate(iter(val)) for e in engs[:1]] == \
        [engs[1].validate(iter(val))]
    assert engs[0].forms == {"graph": 0, "graph_copy": 3, "eager": 0,
                             "captures": 2}
    assert engs[1].forms["eager"] == 5
    small = list(pe.template_batches(1, 4, hw=16))
    engs[0].validate(iter(small))
    assert engs[0].forms["captures"] == 3 and len(engs[0]._graphs) == 3
