"""xsmm_tpu_torch's distributed layer (parallel/) against xsmm_tpu's, on the
CPU.

The JAX side runs on the JAX tests' 8-device virtual CPU mesh
(``tests/conftest.py``); the port's meshes repeat the CPU device, one rank
a repeat, driven by one controller.  Inputs come from
``np.random.default_rng(seed)``.  Tolerances, stated once here:

* dense ring and column-sharded products, port against JAX: 1e-5
  rel-Frobenius (``DENSE``);
* the CSR ring in f32: port against JAX 1e-6 (``RING_JAX``), against the
  numpy f64 gold 1e-3 (the repo's gate); f64 (split2, fold) against gold
  1e-5 (``RING_F64``); chunks 1, 2 and 4 bit for bit;
* the data-parallel SMM and packed getrf: 1e-6 against JAX, and the gold
  gates of ``tests/test_parallel.py`` (1e-3);
* padding and placement: exact;
* the dp x mp train step against the one-rank step: the loss 1e-6
  relative, each leaf's update 1e-3 rel-Frobenius (``UPDATE``, the gate
  of tests/test_torch_engine.py: the ranks' BN moments average f32 means
  of the shards, as the JAX package's sync BN does, which moves a beta's
  update by ~1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.parallel import dist_spmm as jd
from xsmm_tpu.parallel.mesh import make_mesh as jmake_mesh
from xsmm_tpu_torch.parallel import dist_spmm as pd
from xsmm_tpu_torch.parallel import mesh as pm
from xsmm_tpu_torch.parallel import schedule_check as sc

DENSE = 1e-5
RING_JAX = 1e-6
RING_F64 = 1e-5
UPDATE = 1e-3
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved)


def rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.linalg.norm(want - got) / max(np.linalg.norm(want), 1e-30)


def pmesh(shape, names=("dp", "mp")):
    return pm.make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def sparse(rng, m, k, density):
    return np.where(rng.random((m, k)) < density,
                    rng.standard_normal((m, k)), 0.0)


# ------------------------------------------------------------------- mesh --

def test_mesh_shapes():
    m = pm.make_mesh((2, 4), ("dp", "mp"), devices=CPU8)
    assert m.shape == {"dp": 2, "mp": 4} == jmake_mesh((2, 4)).shape
    m2 = pm.make_mesh((-1, 2), ("dp", "mp"), devices=CPU8)
    assert m2.shape == {"dp": 4, "mp": 2}
    assert m.local_ranks() == list(range(8)) and m.size == 8
    assert m.coords(5) == (1, 1) and m.coord(6, "mp") == 2
    assert m.groups("mp") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.groups("dp")[1] == [1, 5]
    assert not m.spans_processes()
    assert m.streams(0) == (None, None)
    # the default devices follow the target: the CPU here, one rank
    assert pm.make_mesh().shape == {"dp": 1, "mp": 1}
    assert pm.local_device_count() == 1 and pm.host_count() == 1


def test_mesh_bad_shape():
    with pytest.raises(ValueError):
        pm.make_mesh((3, 3), ("dp", "mp"), devices=CPU8)
    with pytest.raises(ValueError):
        jmake_mesh((3, 3), ("dp", "mp"))
    with pytest.raises(ValueError, match="axis"):
        pm.make_mesh((2, 4), ("dp", "mp"), devices=CPU8).groups("xx")


def test_sharded_place_and_gather(rng):
    mesh = pmesh((2, 4))
    x = rng.standard_normal((8, 12)).astype(np.float32)
    for spec in (pm.P("dp", "mp"), pm.P("mp", None), pm.P(None, "dp"),
                 pm.P()):
        s = pm.device_put(x, pm.NamedSharding(mesh, spec))
        assert len(s.shards) == 8 and s.shape == (8, 12)
        assert np.array_equal(s.numpy(), x)
    s = pm.device_put(x, pm.dp_sharding(mesh))
    assert tuple(s.shard(5).shape) == (4, 12)
    assert np.array_equal(s.shard(5).numpy(), x[4:])
    r = pm.device_put(x, pm.replicated(mesh))
    # every rank owns its memory
    assert len({t.data_ptr() for t in r.shards}) == 8
    with pytest.raises(ValueError, match="divide"):
        pm.device_put(x[:7], pm.dp_sharding(mesh))


def test_collectives_over_axes(rng):
    mesh = pmesh((2, 4))
    vals = [torch.tensor([float(r)]) for r in range(8)]
    assert [v.item() for v in pm.psum(mesh, "mp", vals)] == \
        [6.0] * 4 + [22.0] * 4
    assert [v.item() for v in pm.pmean(mesh, "dp", vals)] == \
        [2.0, 3.0, 4.0, 5.0] * 2
    assert [v.item() for v in pm.psum(mesh, ("dp", "mp"), vals)] == [28.0] * 8
    g = pm.all_gather(mesh, "mp", [v[None] for v in vals], dim=1)
    assert g[1].tolist() == [[0.0, 1.0, 2.0, 3.0]]
    # differentiable: d(sum over dp of x_r)/d x_r = 1 on each replica
    xs = [torch.ones(3, requires_grad=True) for _ in range(8)]
    tot = sum(v.sum() for v in pm.psum(mesh, "dp", xs))
    for x_ in xs:
        assert torch.equal(torch.autograd.grad(tot, x_, retain_graph=True)[0],
                           torch.full((3,), 2.0))


def test_backend_follows_the_layout():
    assert pm.pick_backend(["cpu", "cpu"], 2) == "gloo"
    with pytest.raises(ValueError, match="refuses two ranks"):
        pm.pick_backend(["cuda:0", "cuda:0"], 2, "nccl")
    with pytest.raises(ValueError, match="cards"):
        pm.pick_backend(["cpu"], 2, "nccl")
    assert pm.pick_backend(["cuda:0"], 2) == "gloo"   # shared card


# ----------------------------------------------------- padding, placement --

def test_shard_rows_and_cols_pad_like_jax(rng):
    jmesh = jmake_mesh((1, 8))
    mesh = pmesh((1, 8))
    x = rng.standard_normal((13, 10)).astype(np.float32)
    rows = pd.shard_rows(mesh, x)
    assert rows.shape == (16, 10) and tuple(rows.shards[0].shape) == (2, 10)
    assert np.array_equal(rows.numpy(),
                          np.asarray(jd.shard_rows(jmesh, x)))
    cols = pd.shard_cols(mesh, x)
    assert cols.shape == (13, 16) and tuple(cols.shards[7].shape) == (13, 2)
    assert np.array_equal(cols.numpy(),
                          np.asarray(jd.shard_cols(jmesh, x)))
    assert np.array_equal(rows.numpy()[13:], np.zeros((3, 10), np.float32))


# -------------------------------------------------------- dense products --

def test_ring_spmm_equals_jax(rng):
    jmesh, mesh = jmake_mesh((1, 8)), pmesh((1, 8))
    m, k, n = 64, 64, 96
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jd.ring_spmm(jmesh)(jd.shard_rows(jmesh, a),
                                          jd.shard_rows(jmesh, b)))
    got = pd.ring_spmm(mesh)(pd.shard_rows(mesh, a),
                             pd.shard_rows(mesh, b))
    assert got.shape == (m, n) and tuple(got.spec) == ("mp", None)
    assert rel(want, got.numpy()) <= DENSE
    xt.check(a.astype(np.float64) @ b, got.numpy(), 1e-3)


def test_col_sharded_spmm_equals_jax(rng):
    jmesh, mesh = jmake_mesh((1, 8)), pmesh((1, 8))
    m, k, n = 32, 40, 64
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jd.col_sharded_spmm(jmesh)(jnp.asarray(a),
                                                 jd.shard_cols(jmesh, b)))
    got = pd.col_sharded_spmm(mesh)(a, pd.shard_cols(mesh, b)).numpy()
    assert rel(want, got) <= DENSE


# ---------------------------------------------------------- the CSR ring --

def _ring_case(rng, m=52, k=44, n=256, d=8, density=0.15):
    a = sparse(rng, m, k, density)
    b = rng.standard_normal((k, n))
    kl = -(-k // d)
    bp = np.zeros((kl * d, n))
    bp[:k] = b
    return a, bp, a @ b


def test_ring_spmm_csr_f32_equals_jax(rng):
    """d = 8 with M and K not multiples of d; the port's chunks 1, 2 and 4
    bit for bit against each other."""
    jmesh, mesh = jmake_mesh((1, 8)), pmesh((1, 8))
    a, bp, gold = _ring_case(rng)
    m, n = a.shape[0], bp.shape[1]
    fj = jd.ring_spmm_csr(jmesh, a.astype(np.float32), n, dtype="float32",
                          strategy="unroll")
    want = np.asarray(fj(jd.shard_rows(jmesh,
                                       jnp.asarray(bp, jnp.float32))))
    b32 = pd.shard_rows(mesh, bp.astype(np.float32))
    outs = []
    for chunks in (1, 2, 4):
        fn = pd.ring_spmm_csr(mesh, a.astype(np.float32), n,
                              dtype="float32", strategy="unroll",
                              chunks=chunks)
        c = fn(b32)
        assert c.shape == (56, n) and tuple(c.spec) == ("mp", None)
        outs.append(c.numpy())
    assert rel(want, outs[0]) <= RING_JAX
    xt.check(gold, outs[0][:m], 1e-3, what="ring csr f32 8 ranks")
    for o in outs[1:]:
        assert np.array_equal(o, outs[0])


@pytest.mark.parametrize("schedule", ["split2", "fold"])
def test_ring_spmm_csr_f64_against_gold(rng, schedule):
    mesh = pmesh((1, 8))
    a, bp, gold = _ring_case(rng)
    m, n = a.shape[0], bp.shape[1]
    bh = bp.astype(np.float32)
    bl = (bp - bh.astype(np.float64)).astype(np.float32)
    outs = []
    for chunks in (1, 2, 4):
        fn = pd.ring_spmm_csr(mesh, a, n, dtype="float64", strategy="unroll",
                              chunks=chunks, f64_schedule=schedule)
        assert fn.streams == ((2, 2) if schedule == "split2" else (1, 1))
        if schedule == "split2":
            ch, cl = fn(pd.shard_rows(mesh, bh), pd.shard_rows(mesh, bl))
            c = ch.numpy().astype(np.float64) + cl.numpy()
        else:
            c = fn(pd.shard_rows(mesh, bh)).numpy().astype(np.float64)
        outs.append(c)
        assert rel(gold, c[:m]) <= RING_F64
    for o in outs[1:]:
        assert np.array_equal(o, outs[0])


def test_ring_spmm_csr_f64_equals_jax_fold(rng):
    jmesh, mesh = jmake_mesh((1, 8)), pmesh((1, 8))
    a, bp, gold = _ring_case(rng, m=40, k=48, density=0.2)
    n = bp.shape[1]
    fj = jd.ring_spmm_csr(jmesh, a, n, dtype="float64", chunks=2,
                          f64_schedule="fold")
    want = np.asarray(fj(jd.shard_rows(jmesh, jnp.asarray(bp, jnp.float32))))
    got = pd.ring_spmm_csr(mesh, a, n, dtype="float64", chunks=2,
                           f64_schedule="fold")(
        pd.shard_rows(mesh, bp.astype(np.float32))).numpy()
    assert rel(want, got) <= RING_JAX
    assert rel(gold, got.astype(np.float64)[:40]) <= RING_F64


def test_ring_one_rank_is_the_local_kernel(rng):
    """d = 1, chunks 1: one call of the operator's kernel, no hop."""
    a, bp, _ = _ring_case(rng, d=1)
    n = bp.shape[1]
    pd.reset_counts()
    c = pd.ring_spmm_csr(pmesh((1, 1)), a.astype(np.float32), n)(
        bp.astype(np.float32))
    local = xp.create_csr_soa(a.astype(np.float32), n)(
        torch.from_numpy(bp.astype(np.float32)))
    assert torch.equal(c.shards[0], local)
    assert pd.hops == {"device": 0, "process": 0}


def test_ring_hop_count_and_checks(rng):
    a, bp, _ = _ring_case(rng, m=16, k=16, n=64, d=4, density=0.5)
    mesh = pmesh((2, 4))      # two rings (dp rows) of four
    pd.reset_counts()
    fn = pd.ring_spmm_csr(mesh, a.astype(np.float32), 64, chunks=2)
    c = fn(pd.shard_rows(mesh, bp.astype(np.float32)))
    assert pd.hops["device"] == 2 * 4 * 3 * 2
    assert np.array_equal(c.shards[1].numpy(), c.shards[5].numpy())
    with pytest.raises(ValueError, match="divide"):
        pd.ring_spmm_csr(mesh, a, 64, chunks=3)
    with pytest.raises(ValueError, match="B stream"):
        pd.ring_spmm_csr(mesh, a, 64, dtype="float64")(bp.astype(np.float32))


# ------------------------------------------------- data-parallel wrappers --

def test_dp_batched_smm_equals_jax(rng):
    jmesh, mesh = jmake_mesh((8, 1)), pmesh((8, 1))
    B, m, n, k = 1024, 8, 8, 8
    a = rng.standard_normal((B, m, k)).astype(np.float32)
    b = rng.standard_normal((B, k, n)).astype(np.float32)
    jk = xt.smmdispatch(m, n, k, batch=B, beta=0.0)
    sh = JNamedSharding(jmesh, JP(None, None, "dp"))
    want = np.asarray(jk.unpack_c(jd.dp_batched_smm(jmesh, jk)(
        jax.device_put(jk.pack_a(a), sh), jax.device_put(jk.pack_b(b), sh)),
        B))
    pk = xp.smmdispatch(m, n, k, batch=B, beta=0.0)
    cp = pd.dp_batched_smm(mesh, pk)(pk.pack_a(a), pk.pack_b(b))
    assert cp.shape == (m, n, B) and tuple(cp.spec) == (None, None, "dp")
    got = pk.unpack_c(cp.gather(), B).numpy()
    assert rel(want, got) <= RING_JAX
    xt.check(np.einsum("bmk,bkn->bmn", a.astype(np.float64), b), got, 1e-3)


def test_dp_batched_smm_f64_split2_fast(rng, monkeypatch):
    mesh = pmesh((4, 1))
    monkeypatch.setenv("XSMM_F64", "split2_fast")
    xp.set_config(f64_strategy="split2_fast")
    B, m = 512, 6
    a = rng.standard_normal((B, m, m))
    b = rng.standard_normal((B, m, m))
    kern = xp.dmmdispatch(m, m, m, batch=B, beta=0.0)
    assert kern.strategy == "split2_fast"
    ah = torch.from_numpy(a).float()
    bh = torch.from_numpy(b).float()
    bl = (torch.from_numpy(b) - bh.double()).float()
    ops = [kern.pack_a(ah), kern.pack_b(bh), kern.pack_b(bl)]
    c = pd.dp_batched_smm(mesh, kern)(*ops).gather()
    want = kern.packed(*ops)
    assert torch.equal(c, want)
    xt.check(np.einsum("bmk,bkn->bmn", a, b),
             kern.unpack_c(c, B).double().numpy(), 1e-6)


def test_dp_packed_getrf_equals_jax(rng):
    jmesh, mesh = jmake_mesh((8, 1)), pmesh((8, 1))
    B, mm = 2048, 8
    a = rng.standard_normal((B, mm, mm)).astype(np.float32)
    a += mm * np.eye(mm, dtype=np.float32)
    jk = xt.getrf_dispatch(mm, mm, batch=B)
    ap = np.ascontiguousarray(np.transpose(a, (1, 2, 0)))
    want = np.asarray(jd.dp_packed(jmesh, jk.packed, 1)(jax.device_put(
        jnp.asarray(ap), JNamedSharding(jmesh, JP(None, None, "dp")))))
    pk = xp.getrf_dispatch(mm, mm, batch=B)
    lu = pd.dp_packed(mesh, pk.packed, 1)(ap).numpy()
    assert rel(want, lu) <= RING_JAX
    lu = lu.transpose(2, 0, 1)
    low = np.tril(lu, -1) + np.eye(mm)
    xt.check(a, low @ np.triu(lu), 1e-3, what="dp packed getrf 8 ranks")
    with pytest.raises(ValueError, match="operands"):
        pd.dp_packed(mesh, pk.packed, 1)(ap, ap)


def test_dp_packed_trsm(rng):
    mesh = pmesh((4, 1))
    B, m, n = 256, 8, 5
    a = np.tril(rng.standard_normal((B, m, m))) + 4 * np.eye(m)
    b = rng.standard_normal((B, m, n))
    kern = xp.trsm_dispatch(m, n, batch=B)
    ap = torch.from_numpy(a.transpose(1, 2, 0).copy()).float()
    bp = torch.from_numpy(b.transpose(1, 2, 0).copy()).float()
    x = pd.dp_packed(mesh, kern.packed, 2)(ap, bp).gather()
    assert torch.equal(x, kern.packed(ap, bp))
    xt.check(np.linalg.solve(a, b), x.permute(2, 0, 1).double().numpy(),
             1e-5)


# ------------------------------------------------------ the compiled form --

class _Rerun:
    """A CPU stand-in for a captured CUDA graph: its replay runs the body
    again on the inputs it captured and writes the outputs it holds, as a
    graph writes its pool.  It lets the CPU drive the compiled form's keys,
    copies and counts; the card tests hold real graphs."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        _assign(self.out, self.body())


def _mirror(x):
    if isinstance(x, tuple):
        return tuple(_mirror(v) for v in x)
    if isinstance(x, pm.Sharded):
        return pm.Sharded(x.sharding, [torch.empty_like(t) for t in x.shards],
                          x.shape)
    return torch.empty_like(x)


def _assign(dst, src):
    if isinstance(dst, tuple):
        for d, s_ in zip(dst, src):
            _assign(d, s_)
    elif isinstance(dst, pm.Sharded):
        for d, s_ in zip(dst.shards, src.shards):
            d.copy_(s_)
    else:
        dst.copy_(src)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The compiled form on the CPU through ``_Rerun``: the graph form
    allowed on CPU ranks, ``graphs.capture`` a warm-up and a stand-in."""
    import contextlib

    from xsmm_tpu_torch.utils import graphs

    def capture(body, inputs=(), generators=(), device=None, what="",
                args=()):
        warm = body()
        g = _Rerun(body, _mirror(warm))
        return graphs.Entry(g, inputs, g.out, graphs.Counts(), args), warm
    monkeypatch.setattr(graphs, "graph_form",
                        lambda devs, compiled, what, processes=1:
                        compiled is not False)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return graphs


def _builders(rng, mesh):
    """Each builder's callable and arguments on a small case: (name,
    build(**kw), args)."""
    a = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal((16, 24)).astype(np.float32)
    op = sparse(rng, 16, 16, 0.3).astype(np.float32)
    kern = xp.smmdispatch(4, 4, 4, batch=64, beta=0.0)
    pa, pb = (kern.pack_a(rng.standard_normal((64, 4, 4)).astype(np.float32)),
              kern.pack_b(rng.standard_normal((64, 4, 4)).astype(np.float32)))
    lu = xp.getrf_dispatch(4, 4, batch=64)
    ap = rng.standard_normal((4, 4, 64)).astype(np.float32) + \
        4 * np.eye(4, dtype=np.float32)[:, :, None]
    return [
        ("ring_spmm", lambda **kw: pd.ring_spmm(mesh, **kw), (a, b)),
        ("ring_spmm_csr", lambda **kw: pd.ring_spmm_csr(mesh, op, 24, **kw),
         (b,)),
        ("col_sharded_spmm", lambda **kw: pd.col_sharded_spmm(mesh, **kw),
         (a, b)),
        ("dp_batched_smm", lambda **kw: pd.dp_batched_smm(mesh, kern, "mp",
                                                           **kw), (pa, pb)),
        ("dp_packed", lambda **kw: pd.dp_packed(mesh, lu.packed, 1, "mp",
                                                **kw), (ap,)),
    ]


def test_builders_run_eagerly_on_the_cpu(rng):
    """On the CPU target every builder's call counts "eager", equals its
    ``compiled=False`` form bit for bit, and ``compiled=True`` raises."""
    mesh = pmesh((1, 4))
    for name, build, args in _builders(rng, mesh):
        pd.reset_counts()
        got = build()(*args)
        assert pd.forms == {"graph": 0, "graph_copy": 0, "eager": 1,
                            "captures": 0}, name
        assert torch.equal(got.gather(),
                           build(compiled=False)(*args).gather()), name
        with pytest.raises(ValueError, match="compiled=True"):
            build(compiled=True)


def test_graph_form_and_signature():
    """Where the graph form runs, and the key: a new shape, dtype or
    stride is a new key, the same ones the same key."""
    from xsmm_tpu_torch.utils import graphs
    card = torch.device("cuda", 0)
    assert graphs.graph_form([card, card], None, "f")
    assert not graphs.graph_form([card], False, "f")
    for devs, procs, why in (([torch.device("cpu")], 1, "CPU"),
                             ([card], 2, "processes"),
                             ([card, torch.device("cuda", 1)], 1,
                              "several cards")):
        assert not graphs.graph_form(devs, None, "f", procs)
        with pytest.raises(ValueError, match=why):
            graphs.graph_form(devs, True, "f", procs)
    t = torch.zeros((4, 6))
    sig = graphs.signature([t])
    assert graphs.signature([torch.ones((4, 6))]) == sig
    for other in (torch.zeros((4, 7)), torch.zeros((4, 6), dtype=torch.int32),
                  torch.zeros((6, 4)).t(), torch.zeros((4, 12))[:, ::2]):
        assert graphs.signature([other]) != sig


def test_graph_cache_evicts_the_least_recently_used():
    from xsmm_tpu_torch.utils.graphs import GraphCache
    cache = GraphCache(3)
    for k in "abc":
        cache.put(k, k.upper())
    assert cache.get("a") == "A"
    cache.put("d", "D")
    assert cache.evictions == 1 and len(cache) == 3
    assert "b" not in cache and all(k in cache for k in "cad")


def test_compiled_form_keys_copies_and_counts(rng, cpu_graphs):
    """The compiled form's control flow, graphs stood in by ``_Rerun``:
    the first call of a key captures and returns the warm-up's result; a
    later call with the caller's tensors copies them in ("graph_copy"),
    one with the graph's own inputs reads them ("graph"), and new values
    written there reach the next call; results stay apart; the hop count
    is the eager call's each call; a new shape captures anew and the 9th
    key evicts the first; each builder's calls equal its eager form."""
    mesh = pmesh((1, 4))
    a, bp, gold = _ring_case(rng, m=16, k=16, n=64, d=4, density=0.5)
    b = pd.shard_rows(mesh, bp.astype(np.float32))
    eager = pd.ring_spmm_csr(mesh, a.astype(np.float32), 64, chunks=2,
                             compiled=False)
    pd.reset_counts()
    want = eager(b).gather()
    hops = pd.hops["device"]
    fn = pd.ring_spmm_csr(mesh, a.astype(np.float32), 64, chunks=2)
    pd.reset_counts()
    first = fn(b)
    second = fn(b)
    assert pd.forms == {"graph": 0, "graph_copy": 1, "eager": 0,
                        "captures": 1}
    assert pd.hops["device"] == 2 * hops
    assert torch.equal(first.gather(), want)
    assert torch.equal(second.gather(), want)
    assert second.shards[0] is not fn.entry(b).out.shards[0]
    inputs = fn.entry(b).args
    assert inputs[0].shards[0] is not b.shards[0]
    for t in inputs[0].shards:
        t.mul_(2)
    third = fn(*inputs)
    assert pd.forms["graph"] == 1 and len(fn.cache) == 1
    assert torch.equal(third.gather(), 2 * want)
    assert torch.equal(first.gather(), want)    # results stay apart
    # keys: the dense ring over 9 widths, the first evicted at the 9th
    dense = pd.ring_spmm(mesh)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    for n in range(1, 10):
        y = rng.standard_normal((16, n)).astype(np.float32)
        assert np.allclose(dense(x, y).numpy(), x @ y, atol=1e-5)
    assert len(dense.cache) == 8 and dense.cache.evictions == 1
    assert pd.forms["captures"] == 1 + 9
    for name, build, args in _builders(rng, mesh):
        fn, ref = build(), build(compiled=False)
        for _ in range(2):
            assert torch.equal(fn(*args).gather(), ref(*args).gather()), name


# ----------------------------------------------------------- entry points --

def test_entry_forward():
    from xsmm_tpu_torch import entry
    fn, (params, x) = entry.entry()
    out = fn(params, x)
    assert tuple(out.shape) == (8, 100) and bool(torch.isfinite(out).all())


def test_dryrun_multichip_4():
    from xsmm_tpu_torch import entry
    got = entry.dryrun_multichip(4)
    assert got["mesh"] == {"dp": 2, "mp": 2} and got["scf"] == 1.0
    assert got["ring_err"] < 1e-5


def test_dp_mp_step_equals_one_rank():
    """The dp x mp step (batch on dp, classifier shards on mp) equals the
    one-rank step on the whole batch: the loss and each leaf's update
    (the classifier's shards put side by side).  The one-rank step is
    itself held to the single-device ``MLEngine``'s plain SGD step on the
    same batch (the engine held against JAX in test_torch_engine.py)."""
    import xsmm_tpu_torch.models as pmodels
    from xsmm_tpu_torch.models.engine import tree_flatten_with_path
    from xsmm_tpu_torch.parallel.multihost import dp_mp_train_step
    one = dp_mp_train_step(pmesh((1, 1)), classes=32, batch=4)
    two = dp_mp_train_step(pmesh((2, 2)), classes=32, batch=4)
    assert abs(one["loss"] - two["loss"]) <= 1e-6 * abs(one["loss"])
    p0, fwd = pmodels.resnet(depth=18, num_classes=32, width=8,
                             input_shape=(4, 32, 32, 3))
    base = dict(tree_flatten_with_path({"layers": p0["layers"]}))
    # dp_mp_train_step's batch: x then y from one generator seeded 0
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 32, 32, 3), generator=gen)
    y = torch.randint(0, 32, (4,), generator=gen)
    eng = pmodels.MLEngine(p0, fwd, pmodels.SolverConfig(
        lr=0.01, momentum=0.0, weight_decay=0.0))
    loss = eng.train_epoch(iter([(x, y)]), verbose=False)["loss"]
    assert abs(one["loss"] - loss) <= 1e-6 * abs(loss)
    ref = dict(tree_flatten_with_path(one["params"][0]))
    for k, v in dict(tree_flatten_with_path({"layers": eng.params[
            "layers"]})).items():
        b = base[k].numpy()
        assert rel(v.detach().numpy() - b, ref[k].detach().numpy() - b) \
            <= UPDATE, k
    r0 = dict(tree_flatten_with_path(two["params"][0]))
    r1 = dict(tree_flatten_with_path(two["params"][1]))
    last = len(one["params"][0]["layers"]) - 1
    for k, v in ref.items():
        got = r0[k]
        if k.startswith(f"['layers'][{last}]"):
            got = torch.cat([r0[k], r1[k]], dim=-1)
        b = base[k].numpy()
        assert rel(v.detach().numpy() - b, got.detach().numpy() - b) \
            <= UPDATE, k


# ------------------------------------------------------- schedule check --

def _schedule(kind: str, d: int = 4, chunks: int = 4):
    """Intervals of a d-rank ring with ``chunks`` sub-panels: "overlapped"
    (each hop of sub-panel s right after its compute, under the next
    sub-panels' compute), "hoisted" (every hop before any compute), or
    "serial" (hop after compute, nothing else running)."""
    items, t = [], 0.0
    for i in range(d):
        for s in range(chunks):
            for r in range(d):
                if kind == "hoisted":
                    start = 1000.0 + (i * chunks + s) * 10
                else:
                    start = t
                items.append(dict(kind="compute", rank=r, step=i, chunk=s,
                                  start=start, end=start + 10))
            if kind == "serial":
                t += 10
            if i < d - 1:
                for r in range(d):
                    if kind == "overlapped":
                        hs = t + 10
                    elif kind == "serial":
                        hs = t
                    else:
                        hs = (i * chunks + s) * 5.0
                    items.append(dict(kind="hop", src=(r + 1) % d, rank=r,
                                      step=i, chunk=s, start=hs,
                                      end=hs + (5 if kind != "overlapped"
                                                else 8)))
                if kind == "serial":
                    t += 5
            if kind == "overlapped":
                t += 10
    return items


def test_schedule_check_cases():
    ok = sc.check_schedule(_schedule("overlapped"), chunks=4, d=4, ranks=4)
    assert ok["ok"] and ok["hops"] == 4 * 3 * 4 and ok["max_live_images"] <= 2
    hoisted = sc.check_schedule(_schedule("hoisted"), chunks=4, d=4, ranks=4)
    assert not hoisted["order_ok"] and not hoisted["live_ok"]
    assert not hoisted["ok"]
    serial = sc.check_schedule(_schedule("serial"), chunks=4, d=4, ranks=4)
    assert not serial["overlap_ok"] and serial["order_ok"]
    assert serial["under_compute"] == 0 and not serial["ok"]


def test_intervals_from_a_chrome_trace():
    """Device events tie to the ring's ranges through their launches'
    correlation ids."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "ring.compute r1 i0 s2",
         "ts": 100, "dur": 50, "pid": 1, "tid": 7},
        {"ph": "X", "cat": "user_annotation",
         "name": "ring.hop r2->r1 i0 s2", "ts": 160, "dur": 30, "pid": 1,
         "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 5, "pid": 1, "tid": 7, "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 170, "dur": 5, "pid": 1, "tid": 7, "args": {"correlation": 6}},
        {"ph": "X", "cat": "kernel", "name": "spgemm_kernel", "ts": 300,
         "dur": 40, "pid": 0, "tid": 3,
         "args": {"correlation": 5, "stream": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 320,
         "dur": 10, "pid": 0, "tid": 4,
         "args": {"correlation": 6, "stream": 4}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 400, "dur": 1,
         "pid": 0, "tid": 3, "args": {"correlation": 9}},
    ]
    got = sc.intervals_from_trace({"traceEvents": ev})
    assert [(g["kind"], g["rank"], g["step"], g["chunk"]) for g in got] == \
        [("compute", 1, 0, 2), ("hop", 1, 0, 2)]
    assert got[1]["src"] == 2 and got[1]["cat"] == "gpu_memcpy"
    assert (got[0]["start"], got[0]["end"]) == (300.0, 340.0)
