"""xsmm_tpu_torch's blocked GEMM and mmbatch against xsmm_tpu's and gold.

Each test of ``tests/test_bgemm_mmbatch.py`` has a counterpart here that
feeds the same numpy inputs (seeded) to both packages; the port runs with
``target="cpu"``.  The interceptor tests run the same calls through
``jnp.matmul``/``jnp.einsum`` inside the JAX package's scope and through
``torch.matmul``/``torch.einsum`` inside the port's, and compare what the
two record.

Stated tolerances (rel-Frobenius): blocked GEMM f32 port vs JAX 1e-5 (both
sum in f32, in different orders); f64 1e-6 against f64 gold; ``gemm_batch``
1e-5 against the JAX package and 1e-3 (the reference's gate) against gold.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.ops import blocked_gemm as jbg
from xsmm_tpu.ops import mmbatch as jmb
from xsmm_tpu_torch.ops import mmbatch as mb
from xsmm_tpu_torch.ops.blocked_gemm import ORDERS
from xsmm_tpu_torch.ops import smm as psmm
from xsmm_tpu_torch.ops import smm_packed

PORT_VS_JAX = 1e-5


@pytest.fixture(autouse=True)
def cpu_target():
    saved_p = dataclasses.asdict(xp.get_config())
    saved_j = dataclasses.asdict(xt.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved_p)
    xt.set_config(**saved_j)


def gold(a, b):
    return np.asarray(a, np.float64) @ np.asarray(b, np.float64)


def np64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x).astype(np.float64)


def agree(ref, port, gold_c, tol_gold, tol_pair=PORT_VS_JAX):
    r, p = np64(ref), np64(port)
    assert r.shape == p.shape == gold_c.shape
    xp.check(r, p, tol_pair, what="port vs JAX")
    xp.check(gold_c, p, tol_gold, what="port vs gold")


def both_handles(*args, **kw):
    return jbg.blocked_gemm_handle(*args, **kw), xp.blocked_gemm_handle(
        *args, **kw)


def recorded(calls):
    return [dataclasses.astuple(c) for c in calls]


# ---------------------------------------------------------------------------
# The counterparts of tests/test_bgemm_mmbatch.py
# ---------------------------------------------------------------------------


def test_bgemm_exact_blocks(rng):
    hj, hp = both_handles(128, 128, 128, bm=32, bn=32, bk=32)
    a = rng.standard_normal((128, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    agree(hj(a, b), hp(a, b), gold(a, b), 1e-3)


def test_bgemm_ragged(rng):
    hj, hp = both_handles(100, 90, 75, bm=32, bn=32, bk=32)
    a = rng.standard_normal((100, 75)).astype(np.float32)
    b = rng.standard_normal((75, 90)).astype(np.float32)
    c = hp(a, b)
    assert tuple(c.shape) == (100, 90) and c.is_contiguous()
    agree(hj(a, b), c, gold(a, b), 1e-3)


def test_bgemm_beta(rng):
    hj, hp = both_handles(64, 64, 64)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    c0 = rng.standard_normal((64, 64)).astype(np.float32)
    agree(hj(a, b, c0), hp(a, b, c0), gold(a, b) + c0, 1e-3)


def test_bgemm_blocked_layout_roundtrip(rng):
    hj, hp = both_handles(64, 48, 32, bm=16, bn=16, bk=16)
    c = rng.standard_normal((64, 48)).astype(np.float32)
    blk = hp.copyin_c(c)
    assert tuple(blk.shape) == (4, 3, 16, 16)
    assert np.array_equal(blk.numpy(), np.asarray(hj.copyin_c(c)))
    assert np.array_equal(hp.copyout_c(blk).numpy(), c)


def test_bgemm_orders():
    assert ORDERS == jbg.ORDERS
    for o in ORDERS:
        xp.blocked_gemm_handle(32, 32, 32, order=o)
    with pytest.raises(AssertionError):
        jbg.blocked_gemm_handle(32, 32, 32, order="zzz")
    # the port validates with an exception that survives python -O
    with pytest.raises(ValueError, match="order"):
        xp.blocked_gemm_handle(32, 32, 32, order="zzz")


def test_gemm_batch(rng):
    a = [rng.standard_normal((12, 8)).astype(np.float32) for _ in range(6)]
    b = [rng.standard_normal((8, 10)).astype(np.float32) for _ in range(6)]
    goldc = np.stack([gold(x, y) for x, y in zip(a, b)])
    agree(jmb.gemm_batch(a, b), xp.gemm_batch(a, b), goldc, 1e-3)


def test_mmbatch_recording(rng):
    x = rng.standard_normal((4, 8, 8)).astype(np.float32)
    a, t = jnp.asarray(x), torch.from_numpy(x)
    with jmb.mmbatch_begin() as jcalls:
        _ = jnp.matmul(a, a)
        _ = jnp.matmul(a[0], a[0])
    with xp.mmbatch_begin() as calls:
        _ = torch.matmul(t, t)
        _ = torch.matmul(t[0], t[0])
    assert len(calls) == 2
    assert calls[0].batch == 4 and calls[0].m == 8
    assert calls[1].batch == 1
    assert recorded(calls) == recorded(jcalls)
    # patched function restored
    assert torch.matmul.__name__ == "matmul"
    assert torch.matmul is psmm._torch_matmul


def test_mmbatch_einsum_recording(rng):
    x = rng.standard_normal((4, 8, 8)).astype(np.float32)
    a, t = jnp.asarray(x), torch.from_numpy(x)
    with jmb.mmbatch_begin() as jcalls:
        jnp.einsum("bij,bjk->bik", a, a)
        jnp.einsum("ij,jk->ik", a[0], a[0])
        jnp.einsum("bij,bij->b", a, a)
    with xp.mmbatch_begin() as calls:
        c1 = torch.einsum("bij,bjk->bik", t, t)   # recorded (batched matmul)
        c2 = torch.einsum("ij,jk->ik", t[0], t[0])  # recorded (plain matmul)
        c3 = torch.einsum("bij,bij->b", t, t)     # passes through unrecorded
    assert len(calls) == 2
    assert calls[0].batch == 4 and calls[0].m == 8 and calls[0].k == 8
    assert calls[1].batch == 1
    assert recorded(calls) == recorded(jcalls)
    assert torch.einsum.__name__ == "einsum"  # restored
    g = np.einsum("bij,bjk->bik", x.astype(np.float64), x.astype(np.float64))
    xp.check(g, c1.numpy(), 1e-3)
    xp.check(g[0], c2.numpy(), 1e-3)
    assert torch.isfinite(c3).all()


def test_mmbatch_reroute(rng):
    x = rng.standard_normal((4, 8, 8)).astype(np.float32)
    a, t = jnp.asarray(x), torch.from_numpy(x)
    with jmb.mmbatch_begin(record_only=False) as jcalls:
        ref = jnp.matmul(a, a)
    with xp.mmbatch_begin(record_only=False) as calls:
        c = torch.matmul(t, t)
    goldc = np.einsum("bij,bjk->bik", x.astype(np.float64),
                      x.astype(np.float64))
    agree(ref, c, goldc, 1e-3)
    assert calls and recorded(calls) == recorded(jcalls)


def test_mmbatch_nested_scope_raises():
    """Nested interception scopes must raise, not deadlock."""
    with xp.mmbatch_begin():
        with pytest.raises(RuntimeError, match="nest"):
            with xp.mmbatch_begin():
                pass
    # flag cleared: a fresh scope works again
    with xp.mmbatch_begin() as calls:
        torch.matmul(torch.ones((2, 3, 4)), torch.ones((2, 4, 5)))
    assert len(calls) == 1


def test_mmbatch_einsum_output_subscripts(rng):
    """Transposed/reduced einsum outputs are NOT plain matmuls and pass
    through unrecorded, in both packages."""
    x = rng.standard_normal((4, 8, 8)).astype(np.float32)
    a, t = jnp.asarray(x), torch.from_numpy(x)
    specs = ["ij,jk->ki", "bij,bjk->ik", "bij,bjk->bik", "bij,bjk"]
    with jmb.mmbatch_begin() as jcalls:
        for s in specs:
            jnp.einsum(s, *((a[0], a[0]) if s.startswith("ij") else (a, a)))
    with xp.mmbatch_begin() as calls:
        for s in specs:
            torch.einsum(s, *((t[0], t[0]) if s.startswith("ij") else (t, t)))
    assert len(calls) == 2
    assert recorded(calls) == recorded(jcalls)


# ---------------------------------------------------------------------------
# Beyond the JAX tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_c", [False, True])
def test_bgemm_f64(rng, with_c):
    """f64 through the two-float split: three f32 einsums, hi and lo joined
    in f64, numpy f64 out."""
    hj, hp = both_handles(100, 90, 75, bm=32, bn=32, bk=32, dtype="float64")
    a, b = rng.standard_normal((100, 75)), rng.standard_normal((75, 90))
    c = rng.standard_normal((100, 90)) if with_c else None
    out = hp(a, b, c)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    g = gold(a, b) + (c if with_c else 0)
    xp.check(g, out, 1e-6)
    xp.check(np.asarray(hj(a, b, c)), out, 1e-6)


def test_bgemm_bf16(rng):
    hj, hp = both_handles(64, 96, 128, bm=32, bn=32, bk=64, dtype="bfloat16")
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, 96)).astype(np.float32)
    c = hp(a, b)
    assert c.dtype == torch.bfloat16
    ab = torch.from_numpy(a).to(torch.bfloat16).double().numpy()
    bb = torch.from_numpy(b).to(torch.bfloat16).double().numpy()
    agree(hj(a, b), c, gold(ab, bb), 1e-2, tol_pair=1e-2)


def test_bgemm_blocked_execute(rng):
    """copyin / execute / copyout by hand equals the convenience call."""
    hp = xp.blocked_gemm_handle(70, 50, 40, bm=16, bn=32, bk=8)
    a = rng.standard_normal((70, 40)).astype(np.float32)
    b = rng.standard_normal((40, 50)).astype(np.float32)
    c = rng.standard_normal((70, 50)).astype(np.float32)
    blk = hp.execute(hp.copyin_a(a), hp.copyin_b(b), hp.copyin_c(c))
    assert tuple(blk.shape) == (5, 2, 16, 32)
    assert torch.equal(hp.copyout_c(blk), hp(a, b, c))


def test_gemm_batch_beta_and_stacked(rng):
    a = rng.standard_normal((6, 12, 8)).astype(np.float32)
    b = rng.standard_normal((6, 8, 10)).astype(np.float32)
    c = rng.standard_normal((6, 12, 10)).astype(np.float32)
    goldc = np.einsum("bmk,bkn->bmn", a.astype(np.float64), b) + c
    agree(jmb.gemm_batch(list(a), list(b), list(c), beta=1.0),
          xp.gemm_batch(list(a), list(b), list(c), beta=1.0), goldc, 1e-3)
    agree(jmb.gemm_batch(a, b, c, beta=1.0), xp.gemm_batch(a, b, c, beta=1.0),
          goldc, 1e-3)


def test_gemm_batch_and_reroute_reach_the_batched_kernel(rng, monkeypatch):
    """gemm_batch and a rerouted small 3-D matmul go through BatchedSMM's
    natural f32 kernel wrapper (contiguous f32 operands; on the card the
    natural kernel, kernel 2's schedule with the pack fused in)."""
    hits = []
    real = smm_packed.natural_f32

    def counted(*a, **k):
        hits.append(1)
        return real(*a, **k)
    monkeypatch.setattr(smm_packed, "natural_f32", counted)
    t = torch.from_numpy(rng.standard_normal((5, 7, 6)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((5, 6, 9)).astype(np.float32))
    xp.gemm_batch(t, u)
    with xp.mmbatch_begin(record_only=False):
        torch.matmul(t, u)
        torch.matmul(t, u, out=torch.empty(5, 7, 9))   # keyword: passes
        torch.matmul(t[0], u[0])                        # 2-D: passes
    assert len(hits) == 2


def test_mmbatch_reroute_thresholds(rng):
    """Large calls pass through; small ones go to dispatch, and f64 comes
    back as a tensor on the caller's device."""
    xp.set_config(gemm_threshold=8 * 8 * 8)
    big = torch.from_numpy(rng.standard_normal((2, 9, 9)))
    small = torch.from_numpy(rng.standard_normal((2, 8, 8)))
    with xp.mmbatch_begin(record_only=False) as calls:
        cb = torch.matmul(big, big)
        cs = torch.matmul(small, small)
    assert [c.m for c in calls] == [9, 8]
    assert isinstance(cs, torch.Tensor) and cs.dtype == torch.float64
    assert torch.allclose(cb, big @ big)
    xp.check(np.einsum("bij,bjk->bik", small.numpy(), small.numpy()),
             cs.numpy(), 1e-6)


@pytest.mark.parametrize("strategy", ["native", "split2_fast"])
def test_package_products_are_not_recorded(rng, strategy):
    """Inside a rerouting scope only the caller's calls are recorded: the
    package's own products (xgemm's plain version, XlaGemm, native f64,
    blocked GEMM) use the original torch.matmul/einsum, so a small f64 call
    rerouted to XlaGemm cannot recurse."""
    xp.set_config(f64_strategy=strategy)
    x32 = rng.standard_normal((32, 32)).astype(np.float32)
    t64 = torch.from_numpy(rng.standard_normal((3, 5, 5)))
    i16 = torch.from_numpy(rng.integers(-9, 9, (3, 5, 5)).astype(np.int16))
    with xp.mmbatch_begin(record_only=False) as calls:
        xp.xgemm(x32, x32)
        xp.smmdispatch(100, 100, 100, beta=0.0)(
            np.ones((1, 100, 100), np.float32), np.ones((1, 100, 100),
                                                        np.float32))
        xp.blocked_gemm_handle(32, 32, 32, bm=16, bn=16, bk=16)(x32, x32)
        c64 = torch.matmul(t64, t64)    # rerouted; native: XlaGemm's product
        c16 = torch.matmul(i16, i16)    # rerouted to XlaGemm, through f64
    assert recorded(calls) == [(5, 5, 5, 3, "float64"), (5, 5, 5, 3, "int16")]
    xp.check(np.einsum("bij,bjk->bik", t64.numpy(), t64.numpy()),
             c64.numpy(), 1e-6)
    assert torch.equal(c16.long(), torch.einsum("bij,bjk->bik", i16.long(),
                                                i16.long()))
    assert torch.matmul is psmm._torch_matmul
    assert torch.einsum is psmm._torch_einsum


def test_mmbatch_end_raises():
    with pytest.raises(RuntimeError, match="mmbatch_begin"):
        mb.mmbatch_end()
    with pytest.raises(RuntimeError):
        jmb.mmbatch_end()


def test_mmbatch_executes_kernel(rng):
    kern = xp.smmdispatch(4, 5, 6, batch=3, beta=1.0)
    a = rng.standard_normal((3, 4, 6)).astype(np.float32)
    b = rng.standard_normal((3, 6, 5)).astype(np.float32)
    c = rng.standard_normal((3, 4, 5)).astype(np.float32)
    out = xp.mmbatch(kern, a, b, c)
    xp.check(np.einsum("bmk,bkn->bmn", a.astype(np.float64), b) + c,
             out.numpy(), 1e-5)


def test_no_card_raises(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp.set_config(target="")
    a = [np.ones((4, 4), np.float32)] * 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.gemm_batch(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.blocked_gemm_handle(8, 8, 8)(np.ones((8, 8), np.float32),
                                        np.ones((8, 8), np.float32))
