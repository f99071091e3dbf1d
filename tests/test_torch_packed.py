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
import re
import types
from pathlib import Path

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
# Kernel 12's "tile" route (ops/csrc/packed.cu getrf_tile): its blocked panel
# schedule, emulated index for index on the CPU
# ---------------------------------------------------------------------------

# getrf_tile's panel width, warps, and rows and columns of a thread's block of
# the trailing update (test_getrf_tile_constants_are_the_kernels)
GT_NB, GT_NW, GT_BR, GT_BC = 8, 8, 8, 4
GT_PAD = 128  # rows and columns of its shared matrix


class _Barriers:
    """The accesses of one interval between two block barriers of
    getrf_tile: who wrote and who read each location, each warp's view of the
    matrix (the state at the barrier plus its own writes; warp 0's steps
    after a __syncwarp see its earlier steps' writes) and the writes that
    land at the next barrier.  A location one thread writes and another
    reads or writes in the interval is a race on the card, unless both are
    warp 0's and a __syncwarp lies between their steps (``syncwarp(e)``:
    one lies before warp 0's step ``e``)."""

    def __init__(self, s: torch.Tensor):
        self.s = s
        self.views = {}
        self.writes = {}
        self.acc = {}  # (i, j) -> [(thread, epoch, write)]
        self.syncs = set()  # warp 0's steps that a __syncwarp precedes

    def syncwarp(self, epoch: int) -> None:
        self.syncs.add(epoch)

    def ordered(self, thread, epoch, other, oepoch) -> bool:
        lo, hi = sorted((epoch, oepoch))
        return (thread < 32 and other < 32
                and any(lo < e <= hi for e in self.syncs))

    def view(self, warp: int) -> torch.Tensor:
        if warp not in self.views:
            self.views[warp] = self.s.clone()
        return self.views[warp]

    def access(self, thread, epoch, reads, writes) -> None:
        for loc in reads:
            self.acc.setdefault(loc, []).append((thread, epoch, False))
        for loc in writes:
            self.acc.setdefault(loc, []).append((thread, epoch, True))

    def write(self, warp: int, rows, cols, value: torch.Tensor) -> None:
        self.view(warp)[rows, cols] = value
        self.writes.setdefault(warp, []).append((rows, cols, value))

    def close(self, label: str) -> torch.Tensor:
        for loc, seen in self.acc.items():
            for thread, epoch, wrote in seen:
                if not wrote:
                    continue
                for other, oepoch, _ in seen:
                    assert other == thread or self.ordered(
                        thread, epoch, other, oepoch), (
                        f"{label}: {loc} written by thread {thread} and "
                        f"touched by thread {other}")
        for w in self.writes.values():
            for rows, cols, value in w:
                self.s[rows, cols] = value
        return self.s


def _tile_diag(bar, k0, kp, m, nb, warp=0, epoch=0):
    """getrf_tile_diag: warp ``warp`` factors the panel's diagonal block in
    registers (lane x: row k0 + x), the pivot row by shuffles; each lane
    reads and writes only its own row."""
    v = bar.view(warp)
    rows, cols = slice(k0, min(k0 + nb, m)), slice(k0, k0 + nb)
    r = v[rows, cols].clone()
    for kk in range(nb):
        if k0 + kk >= kp:
            break
        u, piv = r[kk, kk + 1:].clone(), r[kk, kk].clone()
        r[kk + 1:, kk] = r[kk + 1:, kk] / piv
        r[kk + 1:, kk + 1:] = r[kk + 1:, kk + 1:] - r[kk + 1:, kk, None] * u
    for i in range(rows.start, rows.stop):
        locs = [(i, j) for j in range(k0, k0 + nb)]
        bar.access(32 * warp + i - k0, epoch, locs, locs)
    bar.write(warp, rows, cols, r)


def _tile_ucol(bar, k0, kp, j, nb, tid):
    """getrf_tile_ucol: thread ``tid`` takes column j's rows k0 + 1 ..
    k0 + nb - 1 through the panel's unit lower diagonal block."""
    v = bar.view(tid // 32)
    u = v[k0:k0 + nb, j].clone()
    reads = {(k0 + i, j) for i in range(nb)}
    for kk in range(nb):
        if k0 + kk >= kp:
            break
        u[kk + 1:] = u[kk + 1:] - v[k0 + kk + 1:k0 + nb, k0 + kk] * u[kk]
        reads |= {(k0 + i, k0 + kk) for i in range(kk + 1, nb)}
    bar.access(tid, 0, reads, [(k0 + i, j) for i in range(1, nb)])
    bar.write(tid // 32, slice(k0 + 1, k0 + nb), j, u[1:])


def _tile_lrow(bar, k0, kp, i, nb, tid):
    """getrf_tile_lrow: thread ``tid`` takes row i's panel columns through
    the diagonal block's U, dividing each multiplier in turn."""
    v = bar.view(tid // 32)
    r = v[i, k0:k0 + nb].clone()
    reads = {(i, k0 + j) for j in range(nb)}
    for kk in range(nb):
        k = k0 + kk
        if k >= kp:
            break
        r[kk] = r[kk] / v[k, k]
        r[kk + 1:] = r[kk + 1:] - r[kk] * v[k, k + 1:k0 + nb]
        reads |= {(k, j) for j in range(k, k0 + nb)}
    bar.access(tid, 0, reads, [(i, k0 + j) for j in range(nb)])
    bar.write(tid // 32, i, slice(k0, k0 + nb), r)


def _tile_diag_update(bar, k0, kp, nb, warp=0):
    """getrf_tile_diag_update: the trailing update on the next panel's
    diagonal block, nb * nb / 32 elements a lane of warp ``warp``."""
    v = bar.view(warp)
    k1, e = k0 + nb, nb * nb // 32
    for lane in range(32):
        for x in range(lane * e, lane * e + e):
            i, j = k1 + x // nb, k1 + x % nb
            t = v[i, j].clone()
            for k in range(k0, kp):
                t = t - v[i, k] * v[k, j]
            reads = {(i, j)} | {(i, k) for k in range(k0, kp)} | {
                (k, j) for k in range(k0, kp)}
            bar.access(32 * warp + lane, 0, reads, [(i, j)])
            bar.write(warp, i, j, t)


def _tile_trailing(bar, k0, kp, m, ncols, nb, br, bc, tid, nt, epoch):
    """getrf_tile_trailing for thread ``tid``, the t-th blocks for t =
    (tid - 32) mod nt, ... of rows >= k0 + nb and columns [k0 + nb, ncols)
    but the diagonal's: each takes the steps k0 <= k < kp in one pass,
    every element's terms in ascending k."""
    k1 = k0 + nb
    rows = max(0, -(-m // br) - k1 // br)
    cols = max(0, (ncols - k1) // bc)
    v = bar.view(tid // 32)
    for t in range((tid + nt - 32) % nt, rows * cols, nt):
        rb, cb = divmod(t, cols)
        if rb < nb // br and cb < nb // bc:
            continue
        i0, j0 = k1 + rb * br, k1 + cb * bc
        ri, cj = slice(i0, i0 + br), slice(j0, j0 + bc)
        blk = v[ri, cj].clone()
        reads = {(i, j) for i in range(i0, i0 + br) for j in range(j0, j0 + bc)}
        writes = set(reads)
        for k in range(k0, kp):
            blk = blk - v[ri, k][:, None] * v[k, cj][None]
            reads |= {(i, k) for i in range(i0, i0 + br)}
            reads |= {(k, j) for j in range(j0, j0 + bc)}
        bar.access(tid, epoch, reads, writes)
        bar.write(tid // 32, ri, cj, blk)


def _getrf_tile_emulated(a: torch.Tensor, nb: int = GT_NB, nw: int = GT_NW,
                         br: int = GT_BR, bc: int = GT_BC,
                         diag_warp: int = 0) -> torch.Tensor:
    """getrf_tile's schedule on A [M, N, Bp]: the shared matrix [128, 128,
    Bp] with the pad left NaN (a value that read the pad would be NaN);
    panel 0's diagonal block by warp 0, then for each panel a barrier, U's
    rows (a thread a column, threads 0 .. nt/2 - 1) and L's rows (a thread a
    row, the others), a barrier, and the trailing update (warp 0 the next
    panel's diagonal block, its factorization after a __syncwarp, then its
    share of the other blocks, the last ones; every other warp its share).
    Each interval's reads see the state at its barrier and its writes land
    at the next; a race (_Barriers) fails the emulation.  ``diag_warp``
    moves the next diagonal block's factorization to another warp (a
    schedule the card would race on)."""
    m, n, bp = a.shape
    s = torch.full((GT_PAD, GT_PAD, bp), float("nan"))
    s[:m, :n] = a
    kend = min(n, m - 1)
    npanel = -(-kend // nb)
    ncols = -(-n // bc) * bc
    nt, half = 32 * nw, 16 * nw
    bar = _Barriers(s)
    _tile_diag(bar, 0, min(nb, kend), m, nb)
    for p in range(npanel):
        k0, kp, k1 = p * nb, min(p * nb + nb, kend), p * nb + nb
        s = bar.close(f"panel {p}")
        bar = _Barriers(s)
        for tid in range(half):
            for j in range(k1 + tid, n, half):
                _tile_ucol(bar, k0, kp, j, nb, tid)
        for tid in range(half, nt):
            for i in range(k1 + tid - half, m, half):
                _tile_lrow(bar, k0, kp, i, nb, tid)
        s = bar.close(f"U and L rows {p}")
        bar = _Barriers(s)
        if k1 < m and k1 < n:
            _tile_diag_update(bar, k0, kp, nb)
            if p + 1 < npanel:
                bar.syncwarp(1)
                _tile_diag(bar, k1, min(k1 + nb, kend), m, nb, diag_warp,
                           epoch=1)
        for tid in range(nt):
            _tile_trailing(bar, k0, kp, m, ncols, nb, br, bc, tid, nt,
                           2 if tid < 32 else 0)
    s = bar.close("last trailing update")
    return s[:m, :n].clone()


def _well_conditioned(rng, m, n, bp):
    """[M, N, Bp] with entries of size 1/M and 1 + ... on the diagonal
    (tests/test_torch_gpu.py's packed inputs)."""
    a = rng.standard_normal((m, n, bp)).astype(np.float32) / m
    idx = np.arange(min(m, n))
    a[idx, idx] += 1.0
    return torch.from_numpy(a)


@pytest.mark.parametrize("name,value", [("GT_NB", GT_NB), ("GT_NW", GT_NW),
                                        ("GT_BR", GT_BR), ("GT_BC", GT_BC),
                                        ("GT_MAX", GT_PAD)])
def test_getrf_tile_constants_are_the_kernels(name, value):
    """The emulation below runs getrf_tile's own panel, warps and blocks."""
    src = (Path(cuda_build.__file__).parent / "csrc" / "packed.cu").read_text()
    assert re.findall(rf"constexpr int {name} = (\d+);", src) == [str(value)]


# the six sizes of the route's sizes, two more squares, the tall and wide
# extremes, and the panel's edges: a last panel of one column (66 x 66,
# 128 x 65), sizes no multiple of the panel, a panel of 16 columns and
# 4 warps (the other shapes the kernel's constants allow)
@pytest.mark.parametrize("m,n,nb,nw", [
    (65, 65, GT_NB, GT_NW), (80, 80, GT_NB, GT_NW), (100, 70, GT_NB, GT_NW),
    (70, 100, GT_NB, GT_NW), (125, 125, GT_NB, GT_NW),
    (128, 128, GT_NB, GT_NW), (96, 112, GT_NB, GT_NW),
    (66, 66, GT_NB, GT_NW), (128, 65, GT_NB, GT_NW), (65, 128, GT_NB, GT_NW),
    (125, 125, 16, 4), (97, 90, 16, GT_NW)])
def test_getrf_tile_schedule_matches_plain(rng, m, n, nb, nw):
    """getrf_tile's blocked schedule (emulated) gives getrf_loop_plain's
    bits: every element keeps its own chain of terms in pivot order and its
    multiplier is divided once, from its value at its step, whichever phase
    takes the term; no interval races and no pad value reaches the LU."""
    a = _well_conditioned(rng, m, n, 3)
    got = _getrf_tile_emulated(a, nb, nw)
    want = pk.getrf_loop_plain(a)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got - want).abs().max()


def test_getrf_tile_emulation_sees_a_race(rng):
    """The next diagonal block factored on warp 1, which did not update it,
    reads warp 0's writes between two barriers: the emulation refuses it."""
    a = _well_conditioned(rng, 70, 70, 2)
    with pytest.raises(AssertionError, match="written by thread"):
        _getrf_tile_emulated(a, diag_warp=1)


# (writer, its step), (reader, its step), the steps a __syncwarp precedes:
# only warp 0's threads are ordered, and only across a __syncwarp
@pytest.mark.parametrize("w,r,syncs,races", [
    ((0, 1), (1, 2), set(), True), ((0, 1), (1, 2), {1}, True),
    ((0, 1), (1, 2), {2}, False), ((1, 2), (0, 0), {1}, False),
    ((0, 1), (32, 2), {2}, True), ((0, 1), (1, 1), {1}, True)])
def test_getrf_tile_race_check_orders_only_across_syncwarp(w, r, syncs,
                                                           races):
    """Warp 0's steps that no __syncwarp separates (the next diagonal
    block's factorization and warp 0's share of the trailing update) are
    unordered: a location one writes and the other reads is a race."""
    bar = _Barriers(torch.zeros(2, 2))
    for e in syncs:
        bar.syncwarp(e)
    bar.access(w[0], w[1], [], [(0, 0)])
    bar.access(r[0], r[1], [(0, 0)], [])
    if races:
        with pytest.raises(AssertionError, match="written by thread"):
            bar.close("check")
    else:
        bar.close("check")


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
