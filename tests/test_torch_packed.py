"""xsmm_tpu_torch's packed LA (getrf, trsm, trmm, pgemm) against xsmm_tpu's
and numpy f64.

Each test of ``tests/test_packed.py`` has a counterpart here that feeds the
same numpy inputs (seeded) to both packages: the JAX package runs its Pallas
kernels in interpret mode (``tests/conftest.py``), the port runs with
``target="cpu"``, i.e. through the kernels' plain PyTorch versions.  The
port is held to the JAX test's gate against gold and, in f32, to 1e-6
rel-Frobenius against the JAX package (the two sum in other orders and XLA
may contract a multiply and a subtract; the port rounds each on its own).

Kernels 11-14 are reached as the JAX package reaches them: the unrolled
kernels at the default ``getrf_unroll`` (64), the loop kernels with
``getrf_unroll=4``, set in both packages before the first dispatch of the
shape (both registries are cleared first: the knob is not part of the key).
The route tests count both sides: the JAX package's kernel factories while
it builds, the port's kernel wrappers.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.core import descriptors as jd
from xsmm_tpu.core.registry import get_registry as jget_registry
from xsmm_tpu.ops import packed as jp
from xsmm_tpu.ops.smm import BatchedSMM as JBatchedSMM
from xsmm_tpu_torch.core import descriptors as pd
from xsmm_tpu_torch.core.registry import get_registry
from xsmm_tpu_torch.ops import cuda_build
from xsmm_tpu_torch.ops import packed as pp
from xsmm_tpu_torch.ops import packed_kernels as pk

B = 8
PARITY = 1e-6

# the six (side, uplo, transa, diag) variants of tests/test_packed.py
VARIANTS = [("L", "L", "N", "N"), ("L", "U", "N", "N"), ("L", "L", "T", "N"),
            ("L", "L", "N", "U"), ("R", "L", "N", "N"), ("R", "U", "T", "N")]
KERNELS = ("getrf_unrolled", "getrf_loop", "trsm_unrolled", "trsm_loop")


@pytest.fixture(autouse=True)
def cpu_target():
    saved_p = dataclasses.asdict(xp.get_config())
    saved_j = dataclasses.asdict(xt.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved_p)
    xt.set_config(**saved_j)


@pytest.fixture
def fresh():
    """Both registries emptied, so the next dispatch builds under the
    current knob; emptied again afterwards, so no kernel built under a test
    knob stays cached."""
    get_registry().clear()
    jget_registry().clear()
    yield
    get_registry().clear()
    jget_registry().clear()


@pytest.fixture
def loop_knob(fresh):
    xt.set_config(getrf_unroll=4)
    xp.set_config(getrf_unroll=4)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of the port's kernel wrappers and of the JAX package's kernel
    factories (on the CPU the wrappers run the plain versions and count no
    launch)."""
    counts = {"port": dict.fromkeys(KERNELS, 0),
              "jax": dict.fromkeys(KERNELS, 0)}
    for name in KERNELS:
        def counted(*a, _fn=getattr(pk, name), _name=name, **k):
            counts["port"][_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(pk, name, counted)
    for name, fac in (("getrf_unrolled", "_getrf_kernel_unrolled"),
                      ("getrf_loop", "_getrf_kernel"),
                      ("trsm_unrolled", "_trsm_kernel_unrolled"),
                      ("trsm_loop", "_trsm_kernel")):
        def counted_fac(*a, _fn=getattr(jp, fac), _name=name):
            counts["jax"][_name] += 1
            return _fn(*a)
        monkeypatch.setattr(jp, fac, counted_fac)
    return counts


def lu_gold(a):
    """Unpivoted LU, packed storage, numpy f64."""
    a = np.asarray(a, np.float64).copy()
    m, n = a.shape[-2:]
    for k in range(min(m, n)):
        a[..., k + 1:, k] /= a[..., k:k + 1, k:k + 1][..., 0, 0][..., None]
        a[..., k + 1:, k + 1:] -= (a[..., k + 1:, k:k + 1]
                                   @ a[..., k:k + 1, k + 1:])
    return a


def dd_matrix(rng, b, m, n=None):
    """Diagonally dominant (no-pivot-safe) batch."""
    n = n or m
    a = rng.standard_normal((b, m, n))
    for i in range(min(m, n)):
        a[:, i, i] += m
    return a


def host(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def rel(got, want):
    got, want = host(got), host(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def op_tri(a, uplo, transa, diag):
    """op(A) of the referenced triangle, numpy f64."""
    at = (np.tril if uplo == "L" else np.triu)(np.asarray(a, np.float64))
    if diag == "U":
        idx = np.arange(at.shape[-1])
        at[..., idx, idx] = 1.0
    return np.swapaxes(at, -1, -2) if transa == "T" else at


# ---------------------------------------------------------------------------
# The counterparts of tests/test_packed.py
# ---------------------------------------------------------------------------


def test_getrf_square(rng):
    m = 16
    a = dd_matrix(rng, B, m).astype(np.float32)
    lu = pp.getrf_dispatch(m, m, batch=B)(a)
    assert isinstance(lu, torch.Tensor) and lu.dtype == torch.float32
    xp.check(lu_gold(a), host(lu), 1e-3, what="getrf 16x16")
    assert rel(lu, np.asarray(jp.getrf_dispatch(m, m, batch=B)(a))) <= PARITY


def test_getrf_rect(rng):
    m, n = 12, 8
    a = dd_matrix(rng, B, m, n).astype(np.float32)
    lu = pp.getrf_dispatch(m, n, batch=B)(a)
    xp.check(lu_gold(a), host(lu), 1e-3)
    assert rel(lu, np.asarray(jp.getrf_dispatch(m, n, batch=B)(a))) <= PARITY


def test_getrf_reconstruct(rng):
    """L @ U must reproduce A."""
    m = 10
    a = dd_matrix(rng, B, m).astype(np.float32)
    lu = host(pp.getrf_dispatch(m, m, batch=B)(a))
    l = np.tril(lu, -1) + np.eye(m)
    u = np.triu(lu)
    xp.check(a, l @ u, 1e-3, what="L@U == A")
    assert rel(lu, np.asarray(jp.getrf_dispatch(m, m, batch=B)(a))) <= PARITY


@pytest.mark.parametrize("side,uplo,transa,diag", VARIANTS)
def test_trsm_variants(rng, side, uplo, transa, diag):
    m, n = 12, 10
    am = m if side == "L" else n
    a = dd_matrix(rng, B, am).astype(np.float32)
    b = rng.standard_normal((B, m, n)).astype(np.float32)
    kw = dict(side=side, uplo=uplo, transa=transa, diag=diag, batch=B)
    x = pp.trsm_dispatch(m, n, **kw)(a, b)
    opa = op_tri(a, uplo, transa, diag)
    x64 = host(x)
    lhs = opa @ x64 if side == "L" else x64 @ opa
    xp.check(np.asarray(b, np.float64), lhs, 1e-3,
             what=f"trsm {side}{uplo}{transa}{diag}")
    assert rel(x, np.asarray(jp.trsm_dispatch(m, n, **kw)(a, b))) <= PARITY


def test_trsm_alpha(rng):
    m, n = 8, 6
    a = dd_matrix(rng, B, m).astype(np.float32)
    b = rng.standard_normal((B, m, n)).astype(np.float32)
    kern = pp.trsm_dispatch(m, n, batch=B)
    x2 = host(kern(a, b, alpha=2.0))
    x1 = host(kern(a, b))
    xp.check(2.0 * x1, x2, 1e-3)
    ref = np.asarray(jp.trsm_dispatch(m, n, batch=B)(a, b, alpha=2.0))
    assert rel(x2, ref) <= PARITY


def test_trsm_f64_refinement(rng):
    m, n = 16, 12
    a = dd_matrix(rng, B, m)
    b = rng.standard_normal((B, m, n))
    kern = pp.trsm_dispatch(m, n, dtype="float64", batch=B)
    jkern = jp.trsm_dispatch(m, n, dtype="float64", batch=B)
    # default: device split2 residual
    x = kern(a, b)
    assert isinstance(x, np.ndarray) and x.dtype == np.float64
    info = xp.matdiff(b, np.tril(a) @ x)
    assert info.normf_rel < 1e-7, f"refined trsm too lossy: {info.normf_rel}"
    # "host": f64 residual on the host, max precision
    xh = kern(a, b, refine="host")
    info_h = xp.matdiff(b, np.tril(a) @ xh)
    assert info_h.normf_rel < 1e-8, f"host refine: {info_h.normf_rel}"
    # unrefined f32 solve is much lossier but inside the reference gate
    x0 = kern(a, b, refine=False)
    info_0 = xp.matdiff(b, np.tril(a) @ x0)
    assert info_0.normf_rel < 1e-3
    assert info.normf_rel < info_0.normf_rel
    # the JAX package lands in the same classes on the same inputs
    assert rel(x0, jkern(a, b, refine=False)) <= PARITY
    assert rel(xh, jkern(a, b, refine="host")) <= 1e-8
    assert rel(x, jkern(a, b)) <= 1e-6


@pytest.mark.parametrize("side,uplo", [("L", "L"), ("L", "U"), ("R", "U")])
def test_trmm(rng, side, uplo):
    m, n = 9, 11
    am = m if side == "L" else n
    a = rng.standard_normal((B, am, am)).astype(np.float32)
    b = rng.standard_normal((B, m, n)).astype(np.float32)
    c = pp.trmm_dispatch(m, n, side=side, uplo=uplo, batch=B)(a, b)
    at = op_tri(a, uplo, "N", "N")
    gold = at @ b if side == "L" else b @ at
    xp.check(gold, host(c), 1e-3, what=f"trmm {side}{uplo}")
    ref = jp.trmm_dispatch(m, n, side=side, uplo=uplo, batch=B)(a, b)
    assert rel(c, np.asarray(ref)) <= PARITY


def test_pgemm(rng):
    kern = pp.pgemm_dispatch(8, 8, 8, batch=B)
    assert isinstance(kern, xp.BatchedSMM)
    a = rng.standard_normal((B, 8, 8)).astype(np.float32)
    b = rng.standard_normal((B, 8, 8)).astype(np.float32)
    gold = np.einsum("bmk,bkn->bmn", a.astype(np.float64),
                     b.astype(np.float64))
    c = kern(a, b)
    xp.check(gold, host(c), 1e-3)
    assert rel(c, np.asarray(jp.pgemm_dispatch(8, 8, 8, batch=B)(a, b))) \
        <= PARITY


def test_dispatch_cached():
    k1 = pp.getrf_dispatch(8, 8)
    assert pp.getrf_dispatch(8, 8) is k1
    assert pp.trsm_dispatch(8, 8) is pp.trsm_dispatch(8, 8)


def test_trsm_f64_refined_transposed(rng):
    """Refinement masks op(A)'s triangle, not A's storage triangle: with
    transa='T' the referenced triangle flips."""
    m, n = 12, 8
    a = dd_matrix(rng, B, m)
    b = rng.standard_normal((B, m, n))
    kern = pp.trsm_dispatch(m, n, dtype="float64", transa="T", batch=B)
    for refine in (None, "host"):
        x = kern(a, b, refine=refine)
        lhs = np.swapaxes(np.tril(a), -1, -2) @ x
        info = xp.matdiff(b, lhs)
        assert info.normf_rel < 1e-7, (refine, info.normf_rel)


def test_trmm_routes_lane_packed(rng):
    """TRMM runs the batched SMM (the packed f32 kernel)."""
    kern = pp.trmm_dispatch(8, 8, batch=B)
    assert isinstance(kern._smm, xp.BatchedSMM)
    assert isinstance(jp.trmm_dispatch(8, 8, batch=B)._smm, JBatchedSMM)


@pytest.mark.parametrize("transa,diag,alpha", [("T", "N", 1.0),
                                               ("N", "U", 2.5),
                                               ("T", "U", -0.5)])
def test_trmm_variants(rng, transa, diag, alpha):
    m, n = 8, 12
    a = rng.standard_normal((B, m, m)).astype(np.float32)
    b = rng.standard_normal((B, m, n)).astype(np.float32)
    kw = dict(side="L", uplo="L", transa=transa, diag=diag, batch=B)
    c = pp.trmm_dispatch(m, n, **kw)(a, b, alpha=alpha)
    gold = alpha * (op_tri(a, "L", transa, diag) @ b)
    xp.check(gold, host(c), 1e-3, what=f"trmm {transa}{diag}a{alpha}")
    ref = jp.trmm_dispatch(m, n, **kw)(a, b, alpha=alpha)
    assert rel(c, np.asarray(ref)) <= PARITY


def test_trmm_f64(rng):
    m, n = 9, 7
    a = rng.standard_normal((B, m, m))
    b = rng.standard_normal((B, m, n))
    c = pp.trmm_dispatch(m, n, dtype="float64", batch=B)(a, b)
    assert isinstance(c, np.ndarray) and c.dtype == np.float64
    gold = np.tril(a) @ b
    err = np.linalg.norm(c - gold) / np.linalg.norm(gold)
    assert err < 1e-6, err  # split-schedule class, not f32 class


# ---------------------------------------------------------------------------
# Kernels 11-14 against the JAX package, routed alike
# ---------------------------------------------------------------------------


def _getrf_parity(rng, m, n, kernel, counts):
    a = dd_matrix(rng, B, m, n).astype(np.float32)
    jk = jp.getrf_dispatch(m, n, batch=B)
    kern = pp.getrf_dispatch(m, n, batch=B)
    assert kern.kernel_name == kernel and kern.bt == jk.bt
    ap = np.ascontiguousarray(np.transpose(a, (1, 2, 0)))
    ref = np.asarray(jk.packed(ap))
    got = kern.packed(xp.packed_from_numpy(ap))
    assert rel(got, ref) <= PARITY
    assert rel(kern(a), np.asarray(jk(a))) <= PARITY
    assert rel(got, np.transpose(lu_gold(a), (1, 2, 0))) <= 1e-5
    other = {"getrf_unrolled": "getrf_loop",
             "getrf_loop": "getrf_unrolled"}[kernel]
    for side in ("port", "jax"):
        assert counts[side][other] == 0
    assert counts["port"][kernel] == 2 and counts["jax"][kernel] == 1


@pytest.mark.parametrize("m,n", [(16, 16), (12, 8), (8, 12)])
def test_getrf_unrolled_kernel_parity(rng, fresh, kernel_calls, m, n):
    _getrf_parity(rng, m, n, "getrf_unrolled", kernel_calls)


@pytest.mark.parametrize("m,n", [(10, 10), (12, 8), (8, 12)])
def test_getrf_loop_kernel_parity(rng, loop_knob, kernel_calls, m, n):
    _getrf_parity(rng, m, n, "getrf_loop", kernel_calls)


def _trsm_parity(rng, variant, kernel, counts):
    side, uplo, transa, diag = variant
    m, n = 8, 6
    am = m if side == "L" else n
    a = dd_matrix(rng, B, am).astype(np.float32)
    b = rng.standard_normal((B, m, n)).astype(np.float32)
    kw = dict(side=side, uplo=uplo, transa=transa, diag=diag, batch=B)
    jk = jp.trsm_dispatch(m, n, **kw)
    kern = pp.trsm_dispatch(m, n, **kw)
    assert kern.kernel_name == kernel and kern.bt == jk.bt
    x = kern(a, b, alpha=-1.5)
    assert rel(x, np.asarray(jk(a, b, alpha=-1.5))) <= PARITY
    opa = op_tri(a, uplo, transa, diag)
    lhs = opa @ host(x) if side == "L" else host(x) @ opa
    assert rel(lhs, -1.5 * b.astype(np.float64)) <= 1e-5
    other = {"trsm_unrolled": "trsm_loop",
             "trsm_loop": "trsm_unrolled"}[kernel]
    for s in ("port", "jax"):
        assert counts[s][other] == 0 and counts[s][kernel] == 1


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_trsm_unrolled_kernel_parity(rng, fresh, kernel_calls, variant, unit):
    variant = variant[:3] + ("U" if unit else "N",)
    _trsm_parity(rng, variant, "trsm_unrolled", kernel_calls)


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_trsm_loop_kernel_parity(rng, loop_knob, kernel_calls, variant, unit):
    variant = variant[:3] + ("U" if unit else "N",)
    _trsm_parity(rng, variant, "trsm_loop", kernel_calls)


@pytest.mark.parametrize("unit", [False, True])
def test_trsm_loop_125_against_jax_and_gold(rng, fresh, kernel_calls, unit):
    """Kernel 14 at the element block of a p = 4 hexahedron (125^2,
    ``samples/packed_driver.py:20``), where both packages take the loop
    kernel at the default knob: the port's plain version (which the card's
    kernel equals bit for bit) against the JAX package's ``_trsm_kernel``
    in interpret mode (1e-6) and against numpy f64 (1e-5).  Unit-diagonal
    solves take A scaled by 1/m: random unit-lower matrices grow X
    exponentially in m."""
    m = 125
    diag = "U" if unit else "N"
    a = dd_matrix(rng, B, m) / (m if unit else 1)
    b = rng.standard_normal((B, m, m))
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    kern = pp.trsm_dispatch(m, m, diag=diag, batch=B)
    jk = jp.trsm_dispatch(m, m, diag=diag, batch=B)
    assert kern.kernel_name == "trsm_loop"
    x = kern(a32, b32)
    assert rel(x, np.asarray(jk(a32, b32))) <= PARITY
    gold = np.linalg.solve(op_tri(a32, "L", "N", diag), b32.astype(np.float64))
    assert rel(x, gold) <= 1e-5
    for s in ("port", "jax"):
        assert kernel_calls[s]["trsm_loop"] == 1
        assert kernel_calls[s]["trsm_unrolled"] == 0


def test_factor_then_solve(rng):
    """The slice as its users run it: factor once (getrf), then solve with
    the unit-lower and the upper factor (two trsm), in both packages."""
    m, n = 12, 5
    a = dd_matrix(rng, B, m)
    b = rng.standard_normal((B, m, n))
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    out = {}
    for name, mod in (("port", pp), ("jax", jp)):
        lu = host(mod.getrf_dispatch(m, m, batch=B)(a32)).astype(np.float32)
        y = mod.trsm_dispatch(m, n, uplo="L", diag="U", batch=B)(lu, b32)
        y = host(y).astype(np.float32)
        out[name] = host(mod.trsm_dispatch(m, n, uplo="U", batch=B)(lu, y))
    assert rel(out["port"], out["jax"]) <= PARITY
    assert rel(out["port"], np.linalg.solve(a32.astype(np.float64), b)) \
        <= 1e-5


# ---------------------------------------------------------------------------
# Keys, knob, plain versions, wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,kw", [
    ("getrf", dict(m=12, n=8)), ("getrf", dict(m=16, n=16, dtype="float64")),
    ("trsm", dict(m=12, n=10, side="R", uplo="U", transa="T", diag="U")),
    ("trmm", dict(m=9, n=11, uplo="U")), ("pgemm", dict(m=8, n=8, k=8))])
def test_descriptor_bytes_and_names_match(fresh, op, kw):
    dt = kw.pop("dtype", "float32")
    jdesc = jd.PackedDescriptor(op=op, dtype=dt, batch=B, **kw)
    pdesc = pd.PackedDescriptor(op=op, dtype=dt, batch=B, **kw)
    assert jdesc.pack() == pdesc.pack()
    if op == "pgemm":
        return
    args = {k: v for k, v in kw.items() if k not in ("m", "n")}
    getattr(pp, f"{op}_dispatch")(kw["m"], kw["n"], dtype=dt, batch=B, **args)
    getattr(jp, f"{op}_dispatch")(kw["m"], kw["n"], dtype=dt, batch=B, **args)
    pinfo = get_registry().kernel_info(pdesc)
    jinfo = jget_registry().kernel_info(jdesc)
    assert pinfo["name"] == jinfo["name"]


def test_knob_is_not_part_of_the_key(fresh):
    """As in the JAX package: a shape dispatched before the knob changes
    keeps the kernel it was built with."""
    kern = pp.getrf_dispatch(6, 6, batch=3)
    jk = jp.getrf_dispatch(6, 6, batch=3)
    xp.set_config(getrf_unroll=4)
    xt.set_config(getrf_unroll=4)
    assert pp.getrf_dispatch(6, 6, batch=3) is kern
    assert jp.getrf_dispatch(6, 6, batch=3) is jk
    assert kern.kernel_name == "getrf_unrolled"
    assert pp.trsm_dispatch(6, 6, batch=3).kernel_name == "trsm_loop"


@pytest.mark.parametrize("m,n", [(1, 1), (5, 5), (7, 3), (3, 7), (16, 16)])
def test_getrf_plain_versions_match_f64(rng, m, n):
    a = torch.from_numpy(np.ascontiguousarray(np.transpose(
        dd_matrix(rng, 11, m, n), (1, 2, 0))).astype(np.float32))
    gold = lu_gold(np.transpose(a.double().numpy(), (2, 0, 1)))
    for fn in (pk.getrf_unrolled_plain, pk.getrf_loop_plain):
        got = fn(a)
        assert got.shape == a.shape and got.dtype == torch.float32
        assert rel(np.transpose(host(got), (2, 0, 1)), gold) <= 1e-5


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("sm,sn", [(1, 1), (6, 3), (16, 1), (9, 16)])
def test_trsm_plain_versions_match_f64(rng, sm, sn, unit):
    a = dd_matrix(rng, 11, sm)
    b = rng.standard_normal((11, sm, sn))
    at = op_tri(a, "L", "N", "U" if unit else "N")
    gold = np.linalg.solve(at, b)
    ap = torch.from_numpy(np.ascontiguousarray(np.transpose(a, (1, 2, 0)))
                          .astype(np.float32))
    bp = torch.from_numpy(np.ascontiguousarray(np.transpose(b, (1, 2, 0)))
                          .astype(np.float32))
    for fn in (pk.trsm_unrolled_plain, pk.trsm_loop_plain):
        got = fn(ap, bp, unit)
        assert rel(np.transpose(host(got), (2, 0, 1)), gold) <= 1e-5


def test_wrappers_check_operands():
    a = torch.ones((4, 4, 8))
    b = torch.ones((4, 3, 8))
    for fn in (pk.getrf_unrolled, pk.getrf_loop):
        with pytest.raises(ValueError, match="dtype"):
            fn(a.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(a.transpose(0, 1))
        with pytest.raises(ValueError, match="3-D"):
            fn(a[0])
    for fn in (pk.trsm_unrolled, pk.trsm_loop):
        with pytest.raises(ValueError, match="disagree"):
            fn(a, torch.ones((3, 3, 8)), False)
        with pytest.raises(ValueError, match="dtype"):
            fn(a, b.double(), False)
        with pytest.raises(TypeError):
            fn(a, b.numpy(), False)
    before = dict(pk.launches)
    pk.getrf_unrolled(a + 4 * torch.eye(4)[..., None])
    pk.trsm_loop(a, b, True)
    assert pk.launches == before  # the CPU runs the plain versions


def test_shared_memory_limit_raises(monkeypatch):
    """packed.cu alone decides what fits a block: its -2 (nothing launched)
    reaches the caller as ValueError; a CUDA error stays RuntimeError."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    dev = torch.device("cuda", 0)

    def entry(rc):
        def xsmm_trsm_loop(*args):
            assert args[-2:] == (0, 0)  # device index, stream
            return rc
        return xsmm_trsm_loop

    with pytest.raises(ValueError, match="shared memory"):
        cuda_build.launch(entry(-2), dev, 230, 8)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_build.launch(entry(9), dev, 230, 8)
    cuda_build.launch(entry(0), dev, 125, 125)


def test_entry_point_shapes_checked(rng):
    with pytest.raises(ValueError, match="kernel built for"):
        pp.getrf_dispatch(4, 4, batch=2)(np.ones((2, 4, 5), np.float32))
    with pytest.raises(ValueError, match="kernel built for"):
        pp.trsm_dispatch(4, 3, batch=2)(np.ones((2, 3, 3), np.float32),
                                        np.ones((2, 4, 3), np.float32))


def test_getrf_f64_contract(rng):
    """f64 in, computed in f32, numpy f64 out — as the JAX package."""
    a = dd_matrix(rng, B, 7)
    lu = pp.getrf_dispatch(7, 7, dtype="float64", batch=B)(a)
    ref = jp.getrf_dispatch(7, 7, dtype="float64", batch=B)(a)
    assert isinstance(lu, np.ndarray) and lu.dtype == np.float64
    assert rel(lu, ref) <= PARITY
    xp.check(lu_gold(a), lu, 1e-5)


def test_dispatch_without_card_raises(monkeypatch):
    """With the target unset and no card, building raises; nothing runs on
    the CPU unasked."""
    xp.set_config(target="")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pp.getrf_dispatch(5, 7, batch=3),
                 lambda: pp.trsm_dispatch(5, 7, batch=3),
                 lambda: pp.trmm_dispatch(5, 7, batch=3),
                 lambda: pp.pgemm_dispatch(5, 7, 3, batch=3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# Kernel 12's "tile" route (ops/csrc/packed.cu getrf_tile): its schedule,
# emulated index for index on the CPU
# ---------------------------------------------------------------------------

GT_NW, GT_LD = 16, 128  # warps of getrf_tile; rows and columns of its tile


def _getrf_tile_emulated(a: torch.Tensor, nw: int = GT_NW) -> torch.Tensor:
    """getrf_tile's schedule on A [M, N, Bp]: the register tile (thread
    (w, x) holds rows w + nw*q and columns x + 32*c of the 128 x 128 tile)
    as a [128, 128, Bp] tensor, the shared matrix s and the two pcol
    buffers with the pad left NaN (a published value that read the pad
    would be NaN), one barrier a step.  Each step's reads see the state at
    its barrier and its writes land at the next one; a location written and
    read in the same step (a race on the card) fails the emulation."""
    m, n, bp = a.shape
    nan = float("nan")
    s = torch.full((GT_LD, GT_LD, bp), nan)
    s[:m, :n] = a
    pcol = torch.full((2, GT_LD, bp), nan)
    r = torch.zeros((GT_LD, GT_LD, bp))
    r[:m, :n] = s[:m, :n]
    kend = min(n, m - 1)
    for i in range(1, m):  # C_0 and column 1 ahead, each thread its rows
        s[i, 0] = s[i, 0] / s[0, 0]
        pcol[1, i] = s[i, 1]
    for k in range(kend):
        reads, writes = set(), {}
        # C_{k+1} from pcol, rows k + 2 .. M - 1
        if k + 1 < kend:
            pb = (k + 1) % 2
            u = s[k, k + 1]
            piv = pcol[pb, k + 1] - s[k + 1, k] * u
            reads |= {("p", pb, k + 1), ("s", k + 1, k), ("s", k, k + 1)}
            for i in range(k + 2, m):
                reads |= {("p", pb, i), ("s", i, k)}
                writes[("s", i, k + 1)] = (pcol[pb, i] - s[i, k] * u) / piv
        # the trailing update over the live groups of rows and columns
        u = s[k].clone()
        reads |= {("s", k, j) for j in range(GT_LD)}
        rows = range((k + 1) // nw, GT_LD // nw)  # groups not left behind
        cols = range((k + 1) // 32, GT_LD // 32)
        for q in rows:
            for i in range(nw * q, nw * q + nw):
                reads.add(("s", i, k))
                for c in cols:
                    js = slice(32 * c, 32 * c + 32)
                    r[i, js] = r[i, js] - s[i, k] * u[js]
        # R_{k+1} from its owner warp; column k + 2 ahead from its lanes
        if k + 1 < m:
            for j in range(k + 1, n):
                writes[("s", k + 1, j)] = r[k + 1, j].clone()
        if k + 2 < kend:
            for i in range(k + 2, m):
                writes[("p", k % 2, i)] = r[i, k + 2].clone()
        assert not reads & set(writes), f"step {k}: {reads & set(writes)}"
        for (arr, i, j), v in writes.items():
            (s if arr == "s" else pcol)[i, j] = v
    return s[:m, :n].clone()


def _well_conditioned(rng, m, n, bp):
    """[M, N, Bp] with entries of size 1/M and 1 + ... on the diagonal
    (tests/test_torch_gpu.py's packed inputs)."""
    a = rng.standard_normal((m, n, bp)).astype(np.float32) / m
    idx = np.arange(min(m, n))
    a[idx, idx] += 1.0
    return torch.from_numpy(a)


@pytest.mark.parametrize("m,n", [(65, 65), (80, 80), (100, 70), (70, 100),
                                 (125, 125), (128, 128)])
def test_getrf_tile_schedule_matches_plain(rng, m, n):
    """getrf_tile's index schedule (emulated) gives getrf_loop_plain's bits:
    every element keeps its own chain of terms in pivot order and its
    multiplier is divided once, from its value at its step."""
    a = _well_conditioned(rng, m, n, 3)
    got = _getrf_tile_emulated(a)
    want = pk.getrf_loop_plain(a)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.parametrize("m,n,route", [
    (65, 65, "tile"), (125, 125, "tile"), (128, 128, "tile"),
    (100, 70, "tile"), (70, 100, "tile"), (128, 65, "tile"),
    (64, 64, "shared"), (64, 100, "shared"), (129, 129, "shared"),
    (80, 129, "shared"), (140, 140, "shared"), (16, 16, "shared")])
def test_getrf_route(m, n, route):
    assert pk.getrf_route(m, n) == route


def test_getrf_loop_route_checked_and_counted(monkeypatch):
    """An unknown route raises before any launch; on the card each launch
    counts in launches["getrf_loop"] and in its route, and the tile route's
    refusal (-2) raises with its own message."""
    a = torch.zeros((70, 70, 2))
    with pytest.raises(ValueError, match="route 'big'"):
        pk._getrf_loop(a, "big")
    calls = []

    def entry(rc):
        def xsmm_getrf_loop(*args):
            calls.append(args)
            return rc
        return types.SimpleNamespace(xsmm_getrf_loop=xsmm_getrf_loop)

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(pk, "_lib", lambda: entry(0))
    pk.reset_launches()
    pk.getrf_loop(a)
    pk._getrf_loop(a, "shared")
    assert [c[5] for c in calls] == [1, 0]  # the route codes
    assert pk.launches["getrf_loop"] == 2
    assert pk.getrf_route_launches == {"shared": 1, "tile": 1}
    monkeypatch.setattr(pk, "_lib", lambda: entry(-2))
    with pytest.raises(ValueError, match="tile route takes"):
        pk._getrf_loop(a, "tile")
    with pytest.raises(ValueError, match="shared memory"):
        pk._getrf_loop(a, "shared")
    assert pk.launches["getrf_loop"] == 2


# ---------------------------------------------------------------------------
# The TRSM routes (ops/csrc/packed.cu): "narrow", a thread a (problem,
# column), and "chunk", a block a problem; the streamed narrow solve's walk,
# emulated element for element on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sm,sn,bp,route", [
    # up to SM 64 every width (measured to 128 columns)
    (8, 200, 131072, "narrow"), (16, 128, 4096, "narrow"),
    (64, 128, 131072, "narrow"), (64, 1, 1, "narrow"),
    # above, the sweep's edges: SN * SM^2 <= 48 * 128^2
    (65, 1, 4096, "narrow"), (65, 128, 131072, "narrow"),
    (65, 186, 4096, "narrow"), (65, 187, 4096, "chunk"),
    (96, 64, 131072, "narrow"), (96, 96, 4096, "chunk"),
    (125, 1, 131072, "narrow"), (125, 48, 4096, "narrow"),
    (125, 50, 131072, "narrow"), (125, 51, 131072, "chunk"),
    (125, 64, 131072, "chunk"), (125, 125, 4096, "chunk"),
    (128, 48, 131072, "narrow"), (128, 49, 4096, "chunk"),
    (200, 5, 300, "narrow"), (256, 12, 2, "narrow"), (256, 13, 2, "chunk")])
def test_trsm_route(sm, sn, bp, route):
    assert pk.trsm_route(sm, sn, bp) == route


def test_trsm_route_checked_and_counted(monkeypatch):
    """An unknown route raises before any launch, on either device; on the
    card each launch passes its route's code and counts in its kernel's
    launches and in ``trsm_route_launches``, and the narrow route's
    refusal (-2) raises with its own message."""
    a, b = torch.zeros((125, 125, 2)), torch.zeros((125, 1, 2))
    for route in ("big", "shared"):
        with pytest.raises(ValueError, match=f"route {route!r}"):
            pk._trsm("trsm_loop", a, b, True, False, route)
    calls = []

    def entry(rc):
        def launch(*args):
            calls.append(args)
            return rc
        return types.SimpleNamespace(**{
            f"xsmm_{k}{u}": launch for k in ("trsm_loop", "trsm_unrolled")
            for u in ("", "_upper")})

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(pk, "_lib", lambda: entry(0))
    pk.reset_launches()
    pk.trsm_loop(a, b, True)
    pk.trsm_loop(a, b, False, upper=True)
    pk._trsm("trsm_unrolled", a, b, False, False, "chunk")
    assert [c[7] for c in calls] == [1, 1, 0]  # the route codes
    assert pk.launches["trsm_loop"] == pk.launches["trsm_loop_upper"] == 1
    assert pk.launches["trsm_unrolled"] == 1
    assert pk.trsm_route_launches == {"chunk": 1, "narrow": 2}
    monkeypatch.setattr(pk, "_lib", lambda: entry(-2))
    with pytest.raises(ValueError, match="narrow route takes SM <= 256"):
        pk._trsm("trsm_loop", a, b, True, False, "narrow")
    with pytest.raises(ValueError, match="shared memory"):
        pk._trsm("trsm_loop", a, b, True, False, "chunk")
    assert sum(pk.trsm_route_launches.values()) == 3
    assert sum(pk.launches.values()) == 3


def test_reset_launches_zeroes_the_trsm_routes():
    pk.trsm_route_launches.update(chunk=3, narrow=5)
    pk.launches["trsm_loop"] = 8
    pk.reset_launches()
    assert pk.trsm_route_launches == {"chunk": 0, "narrow": 0}
    assert not any(pk.launches.values())


@pytest.mark.parametrize("route", [None, "chunk", "narrow"])
@pytest.mark.parametrize("kernel", ["trsm_unrolled", "trsm_loop"])
@pytest.mark.parametrize("upper", [False, True])
def test_cpu_trsm_ignores_the_route(rng, route, kernel, upper):
    """On the CPU a named route changes nothing: the plain version runs and
    no launch counts."""
    a = _well_conditioned(rng, 70, 70, 5)
    b = torch.from_numpy(rng.standard_normal((70, 2, 5)).astype(np.float32))
    pk.reset_launches()
    got = pk._trsm(kernel, a, b, False, upper, route)
    plain = getattr(pk, kernel + "_upper" * upper + "_plain")
    assert torch.equal(got, plain(a, b, False))
    assert not any(pk.trsm_route_launches.values())


def _narrow_stream_emulated(a, b, unit, upper, unrolled, nd=4):
    """trsm_narrow_stream's walk for each (column, problem) of B [SM, SN,
    Bp]: chunks of up to ``nd`` terms of one row (row 0's one chunk has
    none), each loaded from the pack's flat [SM*SM*Bp] view (a row's terms
    `step` apart) into one of two banks in turn, the next chunk (with a
    row's last, its diagonal) loaded before the current one is summed;
    x in place of b.  Each element is loaded at most once, and none
    outside what the solve reads."""
    sm, sn, bp = b.shape
    flat, zero = a.reshape(-1), torch.zeros((), dtype=a.dtype)
    step = -bp if upper else bp
    out = torch.empty_like(b)

    def pack_row(r):
        return sm - 1 - r if upper else r

    def nxt(i, c0):
        return (i, c0 + nd) if c0 + nd < i else (i + 1, 0)

    for j in range(sn):
        for q in range(bp):
            a0 = (sm * sm - 1 if upper else 0) * bp + q
            xs = [b[pack_row(i), j, q].clone() for i in range(sm)]
            seen = set()

            def load(e):
                assert e not in seen
                seen.add(e)
                return flat[e]

            def fetch(i, c0):
                ln = min(nd, i - c0)
                p = a0 + (i * sm + c0) * step
                bank = [load(p + u * step) if u < ln else None
                        for u in range(nd)]
                d = load(p + ln * step) if not unit and c0 + ln == i else None
                return bank, d

            s = [xs[0] if unrolled else zero]

            def take(bank, d, i, c0):
                ln = min(nd, i - c0)
                for u in range(ln):
                    t = bank[u] * xs[c0 + u]
                    s[0] = s[0] - t if unrolled else s[0] + t
                if c0 + ln == i:
                    if unrolled:
                        xi = s[0] if unit else s[0] * torch.reciprocal(d)
                    else:
                        xi = xs[i] - s[0]
                        xi = xi if unit else xi / d
                    xs[i] = xi
                    out[pack_row(i), j, q] = xi
                    s[0] = xs[i + 1] if unrolled and i + 1 < sm else zero

            banks = [fetch(0, 0), None]
            f, t, k = nxt(0, 0), (0, 0), 0
            while True:
                if f[0] < sm:
                    banks[1 - k] = fetch(*f)
                f = nxt(*f)
                take(*banks[k], *t)
                t, k = nxt(*t), 1 - k
                if t[0] >= sm:
                    break
            n = sm * (sm - 1) // 2 + (0 if unit else sm)
            assert len(seen) == n
    return out


@pytest.mark.parametrize("sm,sn,bp", [(1, 1, 2), (2, 2, 1), (9, 2, 3),
                                      (17, 1, 2)])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("kernel", ["trsm_unrolled", "trsm_loop"])
def test_narrow_stream_walk_matches_plain(rng, sm, sn, bp, unit, upper,
                                          kernel):
    """The streamed narrow solve's schedule (emulated) gives the plain
    version's bits: each row's terms in r order, x[i] from its own row's
    sum, full and partial chunks, rows shorter than a chunk included; the
    other triangle (and, with a unit diagonal, the diagonal) hold NaN, which
    the walk must not read."""
    a = _well_conditioned(rng, sm, sm, bp)
    a = a / sm if unit else a
    nan = torch.full((sm, sm), float("nan"))
    other = torch.tril(nan, -1) if upper else torch.triu(nan, 1)
    if unit:
        other = other + torch.diag(torch.diagonal(nan))
    a_nan = a + other[..., None]
    b = torch.from_numpy(rng.standard_normal((sm, sn, bp)).astype(np.float32))
    got = _narrow_stream_emulated(a_nan, b, unit, upper,
                                  kernel == "trsm_unrolled")
    want = getattr(pk, kernel + "_upper" * upper + "_plain")(a, b, unit)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got - want).abs().max()
