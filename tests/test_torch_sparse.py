"""xsmm_tpu_torch's sparse x dense path against xsmm_tpu's and f64 gold.

Each test of ``tests/test_sparse.py`` has a counterpart here that feeds the
same seeded numpy inputs to both packages: the JAX package runs its Pallas
kernels in interpret mode (``tests/conftest.py``), the port runs with
``target="cpu"``, i.e. through each CUDA kernel's plain PyTorch version.
Beyond those: digest and descriptor bytes, each of the four kernel
wrappers against the JAX kernel on degenerate operators, the README call
as a whole on a PyFR-shaped operator, and the no-card error.

Stated tolerances (rel-Frobenius):
* port vs JAX: 1e-6 for f32 and every f64 schedule (same term order; the
  two may differ in the last bit where XLA fuses a multiply-add); 1e-2 for
  bf16 spmdm (bf16 rounding of the inputs is the same, the product order
  of XLA's dot and PyTorch's may differ);
* both packages vs f64 gold: ``tests/test_sparse.py``'s gates, 1e-3 for
  f32 (1e-2 for bf16), 1e-5 for f64.
"""

import dataclasses
import itertools
import os
import tempfile

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.ops import fsspmdm as jfs
from xsmm_tpu.ops import spgemm as jsg
from xsmm_tpu.ops import spmdm as jsp
from xsmm_tpu.utils import mtx as jmtx
from xsmm_tpu_torch.ops import fsspmdm as pfs
from xsmm_tpu_torch.ops import spgemm as psg
from xsmm_tpu_torch.ops import spgemm_kernels as sk
from xsmm_tpu_torch.utils import mtx as pmtx

PORT_VS_JAX = 1e-6
BF16_PAIR = 1e-2
TOL32, TOL64 = 1e-3, 1e-5
SCHEDULES = sorted(psg.F64_SCHEDULES)


@pytest.fixture(autouse=True)
def cpu_target():
    saved_p = dataclasses.asdict(xp.get_config())
    saved_j = dataclasses.asdict(xt.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved_p)
    xt.set_config(**saved_j)


def make_operator(rng, m, k, density=0.1):
    """PyFR-style operator matrix: structured sparsity, f64 values."""
    a = rng.standard_normal((m, k))
    mask = rng.random((m, k)) < density
    return np.where(mask, a, 0.0)


def np64(x):
    """Either package's result as numpy f64."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x).astype(np.float64)


def agree(ref_out, port_out, gold, tol_gold, tol_pair=PORT_VS_JAX, what=""):
    r, p = np64(ref_out), np64(port_out)
    assert r.shape == p.shape == gold.shape, (r.shape, p.shape, gold.shape)
    xp.check(r, p, tol_pair, what=f"port vs JAX {what}")
    xp.check(gold, p, tol_gold, what=f"port vs gold {what}")
    xt.check(gold, r, tol_gold, what=f"JAX vs gold {what}")


def g64(*xs):
    """Gold of a product chain in f64."""
    out = np.asarray(xs[0], np.float64)
    for x in xs[1:]:
        out = out @ np.asarray(x, np.float64)
    return out


# ---------------------------------------------------------------- mtx io ----

def test_mtx_roundtrip(rng):
    a = make_operator(rng, 17, 23, 0.2)
    with tempfile.TemporaryDirectory() as d:
        p, q = os.path.join(d, "p.mtx"), os.path.join(d, "j.mtx")
        pmtx.write_mtx(p, a)
        jmtx.write_mtx(q, a)
        with open(p) as f1, open(q) as f2:
            assert f1.read() == f2.read()
        b = pmtx.read_mtx(p)
        np.testing.assert_array_equal(b, jmtx.read_mtx(p))
    assert np.allclose(a, b)


@pytest.mark.parametrize("body", [
    "%%MatrixMarket matrix array real general\n% c\n2 3\n1\n2\n3\n4\n5\n6\n",
    "%%MatrixMarket matrix coordinate real symmetric\n3 3 3\n1 1 2.5\n"
    "3 1 -1\n2 2 4\n",
    "%%MatrixMarket matrix coordinate pattern general\n2 4 2\n1 4\n2 1\n",
], ids=["array", "symmetric", "pattern"])
def test_mtx_formats_match_jax(body):
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.mtx")
        with open(p, "w") as f:
            f.write(body)
        np.testing.assert_array_equal(pmtx.read_mtx(p), jmtx.read_mtx(p))


def test_mtx_rejects_skew():
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.mtx")
        with open(p, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                    "2 2 1\n2 1 1\n")
        with pytest.raises(ValueError):
            pmtx.read_mtx(p)


def test_csr_from_dense_roundtrip(rng):
    a = make_operator(rng, 11, 13, 0.3)
    csr = xp.Csr.from_dense(a)
    assert csr.nnz == np.count_nonzero(a)
    assert np.array_equal(csr.toarray(), a)
    ref = jmtx.Csr.from_dense(a)
    for f in ("row_ptr", "col_idx", "values"):
        got, want = getattr(csr, f), getattr(ref, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_csc_roundtrip(rng):
    a = make_operator(rng, 9, 12, 0.25)
    csc = xp.Csc.from_dense(a)
    assert np.array_equal(csc.toarray(), a)
    ref = jmtx.Csc.from_dense(a)
    assert (csc.m, csc.k) == (ref.m, ref.k)
    np.testing.assert_array_equal(csc.col_ptr, ref.col_ptr)
    np.testing.assert_array_equal(csc.row_idx, ref.row_idx)
    np.testing.assert_array_equal(
        pmtx.Csc.from_fields(ref).toarray(), ref.toarray())


def test_structure_digest_distinguishes(rng):
    a = make_operator(rng, 8, 8, 0.4)
    b = a.copy()
    b[b != 0] *= 1.0000001  # same structure, different values
    assert xp.Csr.from_dense(a).structure_digest() != \
        xp.Csr.from_dense(b).structure_digest()


@pytest.mark.parametrize("case", ["f64", "f32", "empty_row", "nnz0", "fields"])
def test_structure_digest_matches_jax(rng, case):
    a = make_operator(rng, 10, 7, 0.3)
    if case == "f32":
        a = a.astype(np.float32)
    elif case == "empty_row":
        a[4] = 0.0
    elif case == "nnz0":
        a[:] = 0.0
    ref = jmtx.Csr.from_dense(a)
    port = (pmtx.Csr.from_fields(ref) if case == "fields"
            else pmtx.Csr.from_dense(a))
    assert len(port.structure_digest()) == 8
    assert port.structure_digest() == ref.structure_digest()


# ------------------------------------------------------------- spgemm -------

@pytest.mark.parametrize("strategy", ["unroll", "dense"])
def test_csr_asparse_f32(rng, strategy):
    m, k, n = 24, 32, 256
    a = make_operator(rng, m, k, 0.15).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    kr = jsg.create_csr_soa(a, n, dtype="float32", strategy=strategy)
    kp = xp.create_csr_soa(a, n, dtype="float32", strategy=strategy)
    assert kp.strategy == kr.strategy == strategy
    out = kp(b)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    agree(kr(b), out, g64(a, b), TOL32, what=f"csr_asparse f32 {strategy}")


@pytest.mark.parametrize("strategy", ["unroll", "dense"])
def test_csr_asparse_f64(rng, strategy):
    m, k, n = 16, 20, 128
    a = make_operator(rng, m, k, 0.2)
    b = rng.standard_normal((k, n))
    out = xp.create_dcsr_reg(a, n, strategy=strategy)(b)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    agree(jsg.create_dcsr_reg(a, n, strategy=strategy)(b), out, a @ b, TOL64,
          what=f"dcsr_reg {strategy}")


@pytest.mark.parametrize("strategy", ["unroll", "dense"])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_csr_f64_schedules(rng, sched, strategy):
    """All four f64 stream schedules land ~1e-7 in both packages, and the
    byte model is the JAX package's."""
    m, k, n = 16, 20, 128
    a = make_operator(rng, m, k, 0.2)
    b = rng.standard_normal((k, n))
    kr = jsg.create_dcsr_reg(a, n, strategy=strategy, f64_schedule=sched)
    kp = xp.create_dcsr_reg(a, n, strategy=strategy, f64_schedule=sched)
    agree(kr(b), kp(b), a @ b, TOL64, what=f"{sched} {strategy}")
    assert (kp.b_lo, kp.c_lo) == (kr.b_lo, kr.c_lo)
    assert kp.stream_bytes == kr.stream_bytes
    rd, wr = kp.stream_bytes
    assert rd == k * n * 4 * (2 if kp.b_lo else 1)
    assert wr == m * n * 4 * (2 if kp.c_lo else 1)


@pytest.mark.parametrize("strategy", ["unroll", "dense"])
def test_csr_accumulate_f32(rng, strategy):
    """beta=1 form: C_in + A@B; empty rows pass C_in through, and the
    port's acc_fn leaves C_in as it was."""
    m, k, n = 16, 12, 200
    a = make_operator(rng, m, k, 0.25).astype(np.float32)
    a[5, :] = 0.0
    b = rng.standard_normal((k, n)).astype(np.float32)
    c0 = rng.standard_normal((m, n)).astype(np.float32)
    kr = jsg.create_csr_soa(a, n, strategy=strategy)
    kp = xp.create_csr_soa(a, n, strategy=strategy)
    cin = torch.from_numpy(c0.copy())
    got = kp.acc_fn(cin, torch.from_numpy(b))
    assert torch.equal(cin, torch.from_numpy(c0))
    np.testing.assert_array_equal(np64(got)[5], c0[5])
    agree(kr.acc_fn(jnp.asarray(c0), jnp.asarray(b)), got,
          c0.astype(np.float64) + g64(a, b), TOL32, what=f"acc {strategy}")


@pytest.mark.parametrize("strategy", ["unroll", "dense"])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_csr_accumulate_f64(rng, sched, strategy):
    m, k, n = 12, 16, 128
    a = make_operator(rng, m, k, 0.25)
    a[2, :] = 0.0
    b = rng.standard_normal((k, n))
    c0 = rng.standard_normal((m, n)).astype(np.float32)
    c1 = (1e-8 * rng.standard_normal((m, n))).astype(np.float32)
    kr = jsg.create_dcsr_reg(a, n, strategy=strategy, f64_schedule=sched)
    kp = xp.create_dcsr_reg(a, n, strategy=strategy, f64_schedule=sched)
    bh = b.astype(np.float32)
    bs = [bh] + ([(b - bh.astype(np.float64)).astype(np.float32)]
                 if kp.b_lo else [])
    cs = [c0, c1] if kp.c_lo else [c0]
    ref = kr.acc_fn(*map(jnp.asarray, cs + bs))
    got = kp.acc_fn(*map(torch.from_numpy, cs + bs))
    if kp.c_lo:
        ref = np64(ref[0]) + np64(ref[1])
        got = np64(got[0]) + np64(got[1])
    gold = sum(c.astype(np.float64) for c in cs) + a @ b
    agree(ref, got, gold, TOL64, what=f"acc {sched} {strategy}")


def test_csr_empty_rows(rng):
    a = make_operator(rng, 8, 8, 0.3).astype(np.float32)
    a[3, :] = 0.0  # fully empty row
    b = rng.standard_normal((8, 128)).astype(np.float32)
    c = np64(xp.create_csr_soa(a, 128, strategy="unroll")(b))
    assert not c[3].any()
    agree(jsg.create_csr_soa(a, 128, strategy="unroll")(b), c, g64(a, b),
          TOL32)


def test_csr_unpadded_n(rng):
    """N not a multiple of the JAX package's 1024 SOA tile, nor of the CUDA
    kernel's 64-column tile."""
    m, k, n = 12, 16, 300
    a = make_operator(rng, m, k, 0.25).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    agree(jsg.create_csr_soa(a, n, strategy="unroll")(b),
          xp.create_csr_soa(a, n, strategy="unroll")(b), g64(a, b), TOL32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csc_bsparse(rng, dtype):
    m, k, n = 64, 20, 24
    a = rng.standard_normal((m, k)).astype(dtype)
    bsp = make_operator(rng, k, n, 0.2).astype(dtype)
    kr = jsg.create_csc_soa(bsp, m, dtype=dtype, strategy="unroll")
    kp = xp.create_csc_soa(bsp, m, dtype=dtype, strategy="unroll")
    assert kp.strategy == kr.strategy and kp.is_f64 == kr.is_f64
    out = kp(a)
    assert out.shape == (m, n)
    agree(kr(a), out, g64(a, bsp), TOL32 if dtype == "float32" else TOL64,
          what=f"csc {dtype}")


def test_spgemm_cached(rng):
    a = make_operator(rng, 8, 8, 0.3)
    k1 = xp.create_csr_soa(a, 64)
    assert xp.create_csr_soa(a, 64) is k1
    # different values -> different kernel (the values key too)
    assert xp.create_csr_soa(a * 2.0, 64) is not k1
    assert xp.create_csr_soa(xp.Csr.from_dense(a), 64) is k1


def test_auto_strategy_thresholds(rng, monkeypatch):
    small = make_operator(rng, 8, 8, 0.5)
    assert xp.create_csr_soa(small, 64, strategy="auto").strategy == "unroll"
    assert psg.UNROLL_MAX == jsg.UNROLL_MAX
    # above UNROLL_MAX both packages go dense
    for mod in (psg, jsg):
        monkeypatch.setattr(mod, "UNROLL_MAX", 4)
    big = make_operator(rng, 8, 8, 0.6)
    kr = jsg.create_csr_soa(big, 48, strategy="auto")
    kp = xp.create_csr_soa(big, 48, strategy="auto")
    assert kp.strategy == kr.strategy == "dense"
    assert kp.bn is kr.bn is None


def _captured_descriptors(monkeypatch, call):
    """The descriptor each package's registry is asked for by ``call(pkg)``
    (nothing is built)."""
    seen = {}
    for name, reg in (("jax", xt.get_registry()), ("port", xp.get_registry())):
        monkeypatch.setattr(reg, "dispatch",
                            lambda desc, builder, name="", _n=name:
                            seen.setdefault(_n, (desc, name)))
    call(jsg)
    call(psg)
    return seen


@pytest.mark.parametrize("strategy", ["auto", "unroll", "dense"])
@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csr_descriptor_bytes_match(rng, monkeypatch, strategy, sched,
                                    dtype):
    a = make_operator(rng, 9, 14, 0.3)
    seen = _captured_descriptors(
        monkeypatch, lambda mod: mod.create_csr_soa(
            a, 96, dtype=dtype, strategy=strategy, f64_schedule=sched))
    (dj, nj), (dp, np_) = seen["jax"], seen["port"]
    assert dp.pack() == dj.pack()
    assert np_ == nj
    assert dp.flags & 0xF == {"auto": 0, "unroll": 1, "dense": 2}[strategy]
    assert dp.flags >> 4 == SCHEDULES.index(sched)


@pytest.mark.parametrize("strategy", ["auto", "unroll", "dense"])
def test_csc_descriptor_bytes_match(rng, monkeypatch, strategy):
    b = make_operator(rng, 12, 7, 0.3)
    seen = _captured_descriptors(
        monkeypatch, lambda mod: mod.create_csc_soa(b, 40, strategy=strategy))
    assert seen["port"][0].pack() == seen["jax"][0].pack()
    assert seen["port"][1] == seen["jax"][1]


@pytest.mark.parametrize("m,k,n,f64", [
    (8, 8, 64, False), (105, 75, 65536, True), (150, 150, 65536, True),
    (4000, 3000, 5000, False), (12, 16, 3000, True)])
def test_lane_block_matches(monkeypatch, m, k, n, f64):
    a = np.eye(m, k)
    dtype = "float64" if f64 else "float32"
    kr = jsg.CsrSpgemm(jmtx.Csr.from_dense(a), n, dtype, "unroll")
    assert psg.lane_block(m, k, n, f64) == kr.bn
    monkeypatch.setenv("XSMM_SPGEMM_BN", "3000")
    kr = jsg.CsrSpgemm(jmtx.Csr.from_dense(a), n, dtype, "unroll")
    assert psg.lane_block(m, k, n, f64) == kr.bn == 2048


def test_split_const_matches(rng):
    v = np.concatenate([rng.standard_normal(64), [0.0, -0.0, 1e-30, 3e38,
                                                  np.pi, -1 / 3]])
    hi, lo = sk.split_values(v)
    for x, h, lo_ in zip(v, hi, lo):
        assert (float(h), float(lo_)) == jsg._split_const(x)


# ----------------------------------------------- the four kernel wrappers ---

def _kernel_operator(rng, kind):
    if kind == "nnz0":
        return np.zeros((5, 7))
    a = make_operator(rng, 12, 16, 0.3)
    a[4] = 0.0  # an empty row
    a[7, :] = 0.0
    a[7, 3] = 0.5  # a row of one term
    return a


def _planes(rng, k, m, n):
    b = rng.standard_normal((k, n))
    bh = b.astype(np.float32)
    bl = (b - bh.astype(np.float64)).astype(np.float32)
    ch = rng.standard_normal((m, n)).astype(np.float32)
    cl = (1e-8 * rng.standard_normal((m, n))).astype(np.float32)
    return b, bh, bl, ch, cl


@pytest.mark.parametrize("variant", ["unroll_f32", "acc_f32"]
                         + [f"unroll_f64_{s}" for s in SCHEDULES]
                         + [f"acc_f64_{s}" for s in SCHEDULES])
@pytest.mark.parametrize("n", [1, 200])
@pytest.mark.parametrize("kind", ["empty_rows", "nnz0"])
def test_kernel_wrapper_matches_jax_kernel(rng, kind, n, variant):
    """Each wrapper (its plain version on the CPU) against the JAX kernel
    on the same f32 planes; C_in passes through empty rows."""
    a = _kernel_operator(rng, kind)
    m, k = a.shape
    b, bh, bl, ch, cl = _planes(rng, k, m, n)
    f64 = "f64" in variant
    sched = variant.split("f64_")[1] if f64 else "split2"
    if not f64:
        a = a.astype(np.float32)
    kr = jsg.create_csr_soa(a, n, dtype="float64" if f64 else "float32",
                            strategy="unroll", f64_schedule=sched)
    op = sk.SparseOperator(xp.Csr.from_dense(a), torch.device("cpu"))
    assert op.nnz == np.count_nonzero(a)
    t = torch.from_numpy
    before = dict(sk.launches)
    if variant == "unroll_f32":
        ref, got = kr._fn(jnp.asarray(bh)), sk.unroll_f32(op, t(bh))
        gold = g64(a, bh)
    elif variant == "acc_f32":
        ref = kr.acc_fn(jnp.asarray(ch), jnp.asarray(bh))
        got = sk.acc_f32(op, t(ch), t(bh))
        gold = ch + g64(a, bh)
    else:
        bs = [bh, bl] if kr.b_lo else [bh]
        gold = a @ (b if kr.b_lo else bh.astype(np.float64))
        if variant.startswith("unroll"):
            ref = kr._fn(*map(jnp.asarray, bs))
            got = sk.unroll_f64(op, *map(t, bs), c_lo=kr.c_lo)
        else:
            cs = [ch, cl] if kr.c_lo else [ch]
            ref = kr.acc_fn(*map(jnp.asarray, cs + bs))
            got = sk.acc_f64(op, t(ch), t(cl) if kr.c_lo else None,
                             *map(t, bs))
            gold = gold + sum(c.astype(np.float64) for c in cs)
        if kr.c_lo:
            assert isinstance(got, tuple)
            for r_, g_ in zip(ref, got):  # each plane on its own
                xp.check(np64(r_), np64(g_), PORT_VS_JAX)
            ref, got = np64(ref[0]) + np64(ref[1]), np64(got[0]) + np64(got[1])
    assert sk.launches == before  # the CPU path launches nothing
    got = np64(got)
    assert got.shape == (m, n)
    if "acc" in variant:
        np.testing.assert_array_equal(got[4], np64(ch[4]) + (
            np64(cl[4]) if f64 and kr.c_lo else 0))
    else:
        assert not got[4].any()
    agree(ref, got, gold, TOL32 if not f64 else TOL64, what=variant)


def test_kernel_wrapper_checks_operands(rng):
    op = sk.SparseOperator(xp.Csr.from_dense(np.eye(4, 6)),
                           torch.device("cpu"))
    with pytest.raises(ValueError, match="shape"):
        sk.unroll_f32(op, torch.zeros((5, 8)))
    with pytest.raises(ValueError, match="dtype"):
        sk.unroll_f32(op, torch.zeros((6, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        sk.unroll_f32(op, torch.zeros((8, 6)).T)
    with pytest.raises(ValueError, match="C_in"):
        sk.acc_f32(op, torch.zeros((4, 9)), torch.zeros((6, 8)))
    good = xp.Csr.from_dense(np.eye(4, 6))
    for bad in (dataclasses.replace(good, col_idx=good.col_idx + 3),
                dataclasses.replace(good, col_idx=good.col_idx - 1),
                dataclasses.replace(good, row_ptr=good.row_ptr[::-1].copy()),
                dataclasses.replace(good, row_ptr=good.row_ptr[:-1]),
                dataclasses.replace(good, values=good.values[:-1])):
        with pytest.raises(ValueError, match="CSR structure"):
            sk.SparseOperator(bad, torch.device("cpu"))


# -------------------------------------------- the kernels' route rule -----

def _route_case(m, k, density, n, off=0, seed=3):
    """An operator and its B planes on the CPU, the planes ``off`` elements
    into their storage (planes of 2^31 elements or more: shapes only, on
    the meta device)."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, k)) < density, rng.standard_normal((m, k)),
                 0.0)
    op = sk.SparseOperator(xp.Csr.from_dense(a), torch.device("cpu"))
    if k * n >= 2 ** 31:
        return op, [torch.empty((k, n), device="meta") for _ in range(2)]
    planes = [torch.zeros(k * n + 4)[off:off + k * n].view(k, n)
              for _ in range(2)]
    return op, planes


# (M, K, density, N, offset, B planes, f64, the card's answer whether the
# ring fits) -> the route the rule names
ROUTE_RULE = [
    ((150, 150, 0.05, 65536, 0, 2, True, True), ("tma", "shared")),
    ((150, 150, 0.05, 65536, 0, 1, False, True), ("tma", "shared")),
    ((105, 75, 0.11, 65573, 0, 2, True, True), ("cp_async", "shared")),
    ((105, 75, 0.11, 4098, 0, 1, False, True), ("cp_async", "shared")),
    ((150, 150, 0.05, 4096, 1, 2, True, True), ("cp_async", "shared")),
    ((150, 150, 0.05, 4096, 2, 1, False, True), ("cp_async", "shared")),
    ((150, 150, 0.05, 4096, 4, 1, False, True), ("tma", "shared")),
    ((40, 300, 0.05, 4100, 0, 1, False, True), ("tma", "shared")),
    ((40, 300, 0.05, 4100, 0, 2, True, True), ("tma", "shared")),
    ((33, 600, 0.03, 2052, 0, 1, True, True), ("tma", "shared")),
    ((33, 600, 0.03, 2052, 0, 2, True, False), ("unstaged", "shared")),
    ((20, 2000, 0.01, 512, 0, 1, False, False), ("unstaged", "shared")),
    ((5, 7, 0.0, 300, 0, 2, True, True), ("unstaged", "shared")),
    ((200, 200, 0.2, 4096, 0, 2, True, True), ("tma", "global")),
    ((200, 200, 0.2, 4097, 0, 1, False, True), ("cp_async", "global")),
    ((300, 1000, 0.05, 64, 0, 2, True, False), ("unstaged", "global")),
]


# acc: the C_in planes go to the fit too
ROUTE_RULE_ACC = [
    ((150, 150, 0.05, 65536, 0, 2, True, True), 2, ("tma", "shared")),
    ((105, 75, 0.11, 65573, 0, 1, False, True), 1, ("cp_async", "shared")),
    ((33, 600, 0.03, 2052, 0, 1, True, True), 2, ("tma", "shared")),
    ((20, 870, 0.02, 512, 0, 1, False, True), 0, ("tma", "shared")),
    ((20, 870, 0.02, 512, 0, 1, False, False), 1, ("unstaged", "shared")),
]


# planes of 2^31 floats or more (shapes only): TMA needs N % 4 == 0 and
# no more
ROUTE_RULE_WIDE = [
    ((150, 150, 0.05, 2 ** 24, 0, 2, True, True), 0, ("tma", "shared")),
    ((150, 150, 0.05, 2 ** 24 + 1, 0, 1, False, True), 0,
     ("cp_async", "shared")),
    ((105, 75, 0.11, 2 ** 25 + 2, 0, 2, True, False), 0,
     ("unstaged", "shared")),
    ((75, 105, 0.08, 2 ** 25 + 3, 0, 1, False, True), 1,
     ("cp_async", "shared")),
]


@pytest.mark.parametrize("case,c_planes,want",
                         [(c, 0, w) for c, w in ROUTE_RULE] + ROUTE_RULE_ACC
                         + ROUTE_RULE_WIDE)
def test_route_rule(monkeypatch, case, c_planes, want):
    """pick_route by alignment, N % 4, nnz (the structure's bytes, and no
    staging without a term) and the kernel's own answer whether the ring
    fits (asked with the B and C_in planes, as on the card); on CPU
    tensors no fit is asked and the staging is a name."""
    m, k, density, n, off, nplanes, f64, ring_fits = case
    op, planes = _route_case(m, k, density, n, off)
    planes = planes[:nplanes]
    staged = "tma" if sk.tma_addresses(planes) else "cp_async"
    on_cpu = (staged, want[1]) if op.nnz else want
    assert sk.pick_route(op, f64, planes, c_planes) == on_cpu
    asked = []
    monkeypatch.setattr(sk, "fits", lambda *a: asked.append(a[2:]) or
                        ring_fits)
    op.on_cpu, op.routes = False, {}  # the rule as on the card
    assert sk.pick_route(op, f64, planes, c_planes) == want
    assert asked == ([(nplanes, c_planes, (staged, want[1]))] if op.nnz
                     else [])
    if want[1] == "global":
        assert sk.structure_bytes(op.m, op.nnz, f64) > sk.STRUCT_BUDGET


@pytest.mark.parametrize("case,route", [
    ((105, 75, 0.11, 4098, 0, 1, False), ("tma", "shared")),   # N % 4
    ((150, 150, 0.05, 4096, 1, 2, True), ("tma", "global")),   # 4 bytes off
    ((20, 2000, 0.01, 514, 0, 2, True), ("tma", "global")),    # N % 4
    ((400, 400, 0.2, 64, 2, 2, True), ("tma", "shared")),      # 8 bytes off
    ((5, 0, 0.0, 8, 0, 1, False), ("tma", "shared", "ring")),
    ((12, 16, 0.3, 8, 0, 1, False), ("tma", "nowhere")),
    ((12, 16, 0.3, 8, 0, 1, False), ("ldg",)),
])
def test_forced_route_that_cannot_run_raises(case, route):
    """A forced route that cannot run by its name, or "tma" on planes TMA
    cannot address, raises ValueError on the CPU too, before the plain
    version runs; nothing is counted.  (The shared-memory fit is the
    card's: tests/test_torch_gpu.py.)"""
    m, k, density, n, off, nplanes, f64 = case
    op, planes = _route_case(m, k, density, n, off)
    before = (dict(sk.launches), dict(sk.route_launches))
    with pytest.raises(ValueError, match="route"):
        if f64:
            sk.unroll_f64(op, *planes[:nplanes], c_lo=True, route=route)
        else:
            sk.unroll_f32(op, planes[0], route=route)
    assert (dict(sk.launches), dict(sk.route_launches)) == before


@pytest.mark.parametrize("k,n,f64", [(150, 2 ** 24 + 1, True),
                                     (75, 2 ** 25 + 2, False)])
def test_tma_refused_beyond_its_reach(k, n, f64):
    """"tma" forced on planes it cannot address (N % 4 != 0, here at K * N
    >= 2^31 too) raises ValueError; "cp_async" is taken."""
    op, planes = _route_case(12, k, 0.2, n)
    planes = planes[:2 if f64 else 1]
    assert not sk.tma_addresses(planes)
    with pytest.raises(ValueError, match="route"):
        sk._route(op, f64, planes, 0, ("tma", "shared"))
    assert sk._route(op, f64, planes, 0, ("cp_async", "global")) == (
        "cp_async", "global")


def test_route_kept_per_kind(monkeypatch):
    """The route is picked once a kind of launch on an operator (f64, B
    planes, C_in planes, whether TMA addresses the planes) and kept: the
    kernel's fit is asked once a kind."""
    op, planes = _route_case(150, 150, 0.05, 4096)
    wide = _route_case(150, 150, 0.05, 2 ** 24 + 1)[1]
    asked = []
    monkeypatch.setattr(sk, "fits", lambda *a: asked.append(a[2:]) or True)
    op.on_cpu = False
    for _ in range(3):
        assert sk.pick_route(op, True, planes, 2) == ("tma", "shared")
        assert sk.pick_route(op, False, planes[:1]) == ("tma", "shared")
        assert sk.pick_route(op, True, wide, 2) == ("cp_async", "shared")
    assert asked == [(2, 2, ("tma", "shared")), (1, 0, ("tma", "shared")),
                     (2, 2, ("cp_async", "shared"))]
    assert len(op.routes) == 3


def test_fits_is_the_cards():
    """The ring's fit is the kernel's own check, asked on the card only."""
    op, _ = _route_case(150, 150, 0.05, 64)
    with pytest.raises(ValueError, match="card"):
        sk.fits(op, True, 2, 2, ("tma", "shared"))


def test_profile_stamps_fit_the_kernel():
    """kernel_profile's phase stamps find each of their anchors once in
    ops/csrc/spgemm.cu, so its profile of kernels 5-8 has stamps; a copy
    without them is timed plain."""
    from xsmm_tpu_torch.ops import kernel_profile as kp

    src = kp.spgemm_sources("base")
    assert src["prof"].count("PROF_MARK(") == 6
    assert "PROF_END(0)" in src["prof"]
    assert sorted(kp.spgemm_sources("RG=20")) == ["plain", "prof"]
    with pytest.raises(ValueError, match="anchor"):
        kp.instrument(src["plain"].replace("  // -- the store\n", ""),
                      kp._SPGEMM_STAMPS)


def test_operator_device_checked():
    """An operator on a device other than cuda or cpu is refused when it is
    made."""
    a = np.eye(4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sk.SparseOperator(xp.Csr.from_dense(a), torch.device("meta"))


@pytest.mark.parametrize("route", [(s, t) for s in sk.STAGINGS
                                   for t in sk.STRUCTURES])
def test_forced_route_runs_plain_on_cpu(rng, route):
    """Every route that fits, forced on the CPU, gives the plain version's
    bits and counts no launch."""
    a = make_operator(rng, 15, 21, 0.3)
    op = sk.SparseOperator(xp.Csr.from_dense(a), torch.device("cpu"))
    _, bh, bl, ch, cl = _planes(rng, 21, 15, 96)
    bh, bl, ch, cl = map(torch.from_numpy, (bh, bl, ch, cl))
    before = dict(sk.route_launches)
    got = sk.acc_f64(op, ch, cl, bh, bl, route=route)
    want = sk.acc_f64_plain(op, ch, cl, bh, bl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(sk.unroll_f32(op, bh, route=route),
                       sk.unroll_f32_plain(op, bh))
    assert sk.route_launches == before


# ------------------------------------------------------------ fsspmdm -------

def test_fsspmdm_f64(rng):
    m, k, n = 15, 21, 96
    a = make_operator(rng, m, k, 0.3)
    b = rng.standard_normal((k, n))
    hr = jfs.dfsspmdm_create(m, n, k, a)
    hp = xp.dfsspmdm_create(m, n, k, a)
    assert (hp.strategy, hp.nnz, hp.n_chunksize) == (
        hr.strategy, hr.nnz, hr.n_chunksize)
    agree(hr.execute(b), hp.execute(b), a @ b, TOL64, what="dfsspmdm")


def test_fsspmdm_f32(rng):
    m, k, n = 10, 12, 64
    a = make_operator(rng, m, k, 0.4).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    hr = jfs.sfsspmdm_create(m, n, k, a)
    hp = pfs.sfsspmdm_create(m, n, k, a)
    assert hp.n_chunksize == hr.n_chunksize
    agree(hr(b), hp(b), g64(a, b), TOL32, what="sfsspmdm")
    with pytest.raises(ValueError):
        pfs.sfsspmdm_create(m + 1, n, k, a)


# -------------------------------------------------------------- spmdm -------

def _bf16(x):
    return np.asarray(np.asarray(x).astype(ml_dtypes.bfloat16), np.float64)


@pytest.mark.parametrize("strategy", ["dense", "ell"])
def test_spmdm_dynamic(rng, strategy):
    m, k, n = 32, 48, 64
    hr = jsp.spmdm_init(m, n, k, strategy=strategy)
    hp = xp.spmdm_init(m, n, k, strategy=strategy)
    b = rng.standard_normal((k, n)).astype(np.float32)
    for trial in range(2):  # dynamic: different structure every call
        a = make_operator(rng, m, k, 0.2 + 0.1 * trial).astype(np.float32)
        sr, sp = hr.create_sparse_slice(a), hp.create_sparse_slice(a)
        assert sp.kind == sr.kind == strategy
        assert int(sp.nnz) == np.count_nonzero(a)
        if strategy == "ell":
            np.testing.assert_array_equal(sp.values.numpy(),
                                          np.asarray(sr.values))
            np.testing.assert_array_equal(sp.cols.numpy(),
                                          np.asarray(sr.cols))
        out = hp.compute(sp, b)
        assert out.dtype == torch.float32
        agree(hr.compute(sr, b), out, g64(a, b), TOL32,
              what=f"spmdm {strategy} trial{trial}")


def test_spmdm_bf16(rng):
    m, k, n = 16, 24, 32
    a = make_operator(rng, m, k, 0.3).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ref = jsp.spmdm_init(m, n, k, in_dtype="bfloat16")(a, b)
    got = xp.spmdm_init(m, n, k, in_dtype="bfloat16")(a, b)
    agree(ref, got, _bf16(a) @ _bf16(b), 1e-2, BF16_PAIR, what="spmdm bf16")


def test_spmdm_bf16_ell(rng):
    """bf16-input ELL: A rounded to bf16 at slice time, B bf16 through the
    gather, f32 accumulation; gold is the f64 product of the bf16-rounded
    inputs."""
    m, k, n = 16, 24, 32
    a = make_operator(rng, m, k, 0.2).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    hr = jsp.spmdm_init(m, n, k, in_dtype="bfloat16", strategy="ell")
    hp = xp.spmdm_init(m, n, k, in_dtype="bfloat16", strategy="ell")
    sp = hp.create_sparse_slice(a)
    assert sp.kind == "ell"
    ab = _bf16(a)
    assert sp.nnz == np.count_nonzero(ab)
    np.testing.assert_array_equal(  # exact f32 images of the bf16 values
        sp.values.numpy(), np.asarray(hr.create_sparse_slice(a).values))
    agree(hr.compute(hr.create_sparse_slice(a), b), hp.compute(sp, b),
          ab @ _bf16(b), 1e-3, BF16_PAIR, what="spmdm bf16 ell")


@pytest.mark.parametrize("strategy", ["dense", "ell"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_spmdm_trans_beta_matrix(rng, strategy, in_dtype):
    """Full transa x transb x transc x beta matrix, each combination against
    the JAX handle and gold."""
    m, k, n = 16, 24, 32
    hr = jsp.spmdm_init(m, n, k, in_dtype=in_dtype, strategy=strategy)
    hp = xp.spmdm_init(m, n, k, in_dtype=in_dtype, strategy=strategy)
    a = make_operator(rng, m, k, 0.2).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c0 = rng.standard_normal((m, n)).astype(np.float32)
    if in_dtype == "bfloat16":
        ag, bg, tol, pair = _bf16(a), _bf16(b), 1e-2, BF16_PAIR
    else:
        ag, bg, tol, pair = g64(a), g64(b), 1e-3, PORT_VS_JAX
    for ta, tb, tc, beta in itertools.product(
            (False, True), (False, True), (False, True), (0, 1)):
        gold = ag @ bg
        if tc:
            gold = gold.T
        if beta:
            gold = gold + np.asarray(c0.T if tc else c0, np.float64)
        args = dict(transa=ta, transb=tb, transc=tc, beta=beta,
                    c=(c0.T if tc else c0) if beta else None)
        outs = [h.compute(h.create_sparse_slice(a.T if ta else a, transa=ta),
                          b.T if tb else b, **args) for h in (hr, hp)]
        assert outs[1].dtype == torch.float32
        agree(outs[0], outs[1], gold, tol, pair,
              what=f"spmdm {strategy}/{in_dtype} ta={ta} tb={tb} tc={tc} "
                   f"beta={beta}")
    with pytest.raises(ValueError):  # mismatched transa echo
        hp.compute(hp.create_sparse_slice(a, transa=False), b, transa=True)
    with pytest.raises(ValueError):  # unsupported beta
        hp.compute(hp.create_sparse_slice(a), b, beta=0.5, c=c0)
    with pytest.raises(ValueError):  # beta = 1 without C
        hp.compute(hp.create_sparse_slice(a), b, beta=1)


@pytest.mark.parametrize("density,k", [(0.2, 48), (0.001, 4096)])
def test_spmdm_auto_picks_like_jax(rng, density, k):
    m, n = 8, 16
    a = make_operator(rng, m, k, density).astype(np.float32)
    a[0, 5] = 1.0
    b = rng.standard_normal((k, n)).astype(np.float32)
    hr, hp = jsp.spmdm_init(m, n, k), xp.spmdm_init(m, n, k)
    sr, sp = hr.create_sparse_slice(a), hp.create_sparse_slice(a)
    assert sp.kind == sr.kind
    assert int(sp.nnz) == int(sr.nnz)
    agree(hr.compute(sr, b), hp.compute(sp, b), g64(a, b), TOL32)


# ------------------------------------------------- the slice as a whole -----

def test_readme_call_and_fsspmdm_pyfr_shaped():
    """The README's sparse call, ``create_dcsr_reg(op, n)(b)``, then the
    fsspmdm handle, on the 75x105 PyFR-shaped operator of
    ``samples/pyfr_driver.py`` at a small N, in both packages."""
    rng = np.random.default_rng(0)
    specs = [(105, 75, 0.11), (75, 105, 0.08)]
    ops = [np.where(rng.random((m, k)) < d, rng.standard_normal((m, k)), 0.0)
           for m, k, d in specs]
    op, n = ops[1], 96
    b = np.random.default_rng(3).standard_normal((op.shape[1], n))
    kp = xp.create_dcsr_reg(op, n)
    assert kp.strategy == "unroll"
    ref = xt.create_dcsr_reg(op, n)(b)
    agree(ref, kp(b), op @ b, TOL64, what="create_dcsr_reg pyfr 75x105")
    # the handle picks the same unroll kernel in both packages; its JAX
    # result is the one above (same kernel function), so it is not traced
    # a second time
    m, k = op.shape
    hr = xt.dfsspmdm_create(m, n, k, op)
    hp = xp.dfsspmdm_create(m, n, k, op)
    assert (hp.strategy, hp.nnz, hp.n_chunksize) == (
        hr.strategy, hr.nnz, hr.n_chunksize) == (
        "unroll", np.count_nonzero(op), 1024)
    assert (hp.kernel.b_lo, hp.kernel.c_lo) == (hr.kernel.b_lo,
                                                hr.kernel.c_lo)
    agree(ref, hp(b), op @ b, TOL64, what="dfsspmdm pyfr 75x105")


def test_reference_pyfr_operator():
    """The reference's own canonical PyFR matrix, once it is in the
    repository (the reference's samples/pyfr/test.sh runs
    mats/p3/hex/m6-sp.mtx)."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "samples",
                        "pyfr", "mats", "p3", "hex", "m6-sp.mtx")
    if not os.path.exists(path):
        pytest.skip("the reference's .mtx operators are not in the "
                    "repository")
    a = xp.read_mtx(path)
    n = 1024
    b = np.random.default_rng(3).standard_normal((a.shape[1], n))
    xp.check(a @ b, xp.create_dcsr_reg(a, n)(b), 1e-3,
             what="p3/hex/m6-sp reference operator")


def test_no_card_no_target_raises(monkeypatch):
    """Without a card and without target="cpu", the sparse entry points
    raise; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp.set_config(target="")
    a = np.diag(np.arange(1.0, 6.0))  # a structure no other test builds
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.create_dcsr_reg(a, 17)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.create_csr_soa(a, 19, strategy="dense")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.sfsspmdm_create(5, 23, 5, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.spmdm_init(5, 8, 5)
