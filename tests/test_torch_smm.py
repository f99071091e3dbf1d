"""xsmm_tpu_torch's SMM path against xsmm_tpu's and against f64 gold.

Each test of ``tests/test_smm.py`` has a counterpart here that feeds the
same numpy inputs (seeded) to both packages: the JAX package runs its Pallas
kernels in interpret mode (``tests/conftest.py``), the port runs with
``target="cpu"``, i.e. through each CUDA kernel's plain PyTorch version.

Stated tolerances (rel-Frobenius):
* port vs JAX, f32 and bf16 -> f32: 1e-6 (same k order; the two may differ
  in the last bit where one side fuses a multiply-add);
* port vs JAX, f64 schedules: 1e-6, and each within its reference
  threshold against gold;
* port vs JAX, bf16 -> bf16: 1e-2 (the sum is rounded to bf16 at every k
  step, so one rounding difference moves an element by a bf16 ulp).
"""

import contextlib
import dataclasses
import re
import types
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu_torch.ops import smm_packed

TOL = 1e-3
B = 8
PORT_VS_JAX = 1e-6


@pytest.fixture(autouse=True)
def cpu_target():
    saved_p = dataclasses.asdict(xp.get_config())
    saved_j = dataclasses.asdict(xt.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved_p)
    xt.set_config(**saved_j)


@contextlib.contextmanager
def both_config(**kw):
    """Set the same config fields in both packages (restored by the
    autouse fixture)."""
    xt.set_config(**kw)
    xp.set_config(**kw)
    yield


def gold_bmm(a, b):
    return np.einsum("bmk,bkn->bmn", np.asarray(a, np.float64),
                     np.asarray(b, np.float64))


def np64(x):
    """Either package's result as numpy f64."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x).astype(np.float64)


def both(dispatcher, *args, **kw):
    """Dispatch the same descriptor in both packages: (ref, port) kernels."""
    return getattr(xt, dispatcher)(*args, **kw), getattr(xp, dispatcher)(
        *args, **kw)


def agree(ref_out, port_out, gold, tol_gold, tol_pair=PORT_VS_JAX, what=""):
    r, p = np64(ref_out), np64(port_out)
    assert r.shape == p.shape == gold.shape
    xp.check(r, p, tol_pair, what=f"port vs JAX {what}")
    xp.check(gold, p, tol_gold, what=f"port vs gold {what}")
    xt.check(gold, r, tol_gold, what=f"JAX vs gold {what}")


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (5, 3, 7), (13, 13, 13),
                                   (23, 23, 23), (16, 48, 8), (64, 64, 64)])
def test_batched_f32_shapes(rng, m, n, k):
    a = rng.standard_normal((B, m, k), dtype=np.float32)
    b = rng.standard_normal((B, k, n), dtype=np.float32)
    kr, kp = both("smmdispatch", m, n, k, batch=B, beta=0.0)
    assert type(kp).__name__ == type(kr).__name__
    out = kp(a, b)
    assert out.shape == (B, m, n) and out.dtype == torch.float32
    agree(kr(a, b), out, gold_bmm(a, b), TOL, what=f"f32 {m}x{n}x{k}")


def test_beta_one_accumulates(rng):
    m = n = k = 13
    a = rng.standard_normal((B, m, k), dtype=np.float32)
    b = rng.standard_normal((B, k, n), dtype=np.float32)
    c0 = rng.standard_normal((B, m, n)).astype(np.float32)
    kr, kp = both("smmdispatch", m, n, k, batch=B, beta=1.0)
    agree(kr(a, b, c0), kp(a, b, c0), gold_bmm(a, b) + c0, TOL)


def test_beta_one_requires_c(rng):
    a = rng.standard_normal((B, 4, 4), dtype=np.float32)
    for kern in both("smmdispatch", 4, 4, 4, batch=B, beta=1.0):
        with pytest.raises(ValueError):
            kern(a, a)
    with both_config(f64_strategy="split2"):
        for kern in both("dmmdispatch", 4, 4, 4, batch=B, beta=1.0):
            with pytest.raises(ValueError):
                kern(a, a)


@pytest.mark.parametrize("pkg", [xt, xp], ids=["jax", "port"])
def test_invalid_alpha_beta(pkg):
    with pytest.raises(ValueError):
        pkg.smmdispatch(4, 4, 4, alpha=2.0)
    with pytest.raises(ValueError):
        pkg.smmdispatch(4, 4, 4, beta=0.5)


@pytest.mark.parametrize("transa,transb", [("T", "N"), ("N", "T"), ("T", "T")])
def test_transposes(rng, transa, transb):
    m, n, k = 11, 7, 5
    a = rng.standard_normal((B, m, k), dtype=np.float32)
    b = rng.standard_normal((B, k, n), dtype=np.float32)
    at = np.swapaxes(a, 1, 2).copy() if transa == "T" else a
    bt = np.swapaxes(b, 1, 2).copy() if transb == "T" else b
    kr, kp = both("smmdispatch", m, n, k, batch=B, beta=0.0,
                  transa=transa, transb=transb)
    agree(kr(at, bt), kp(at, bt), gold_bmm(a, b), TOL)


def test_f64_split2_accuracy(rng):
    m = n = k = 23
    a = rng.standard_normal((B, m, k))
    b = rng.standard_normal((B, k, n))
    with both_config(f64_strategy="split2"):
        kr, kp = both("dmmdispatch", m, n, k, batch=B, beta=0.0)
        c = kp(a, b)
        assert isinstance(c, np.ndarray) and c.dtype == np.float64
        agree(kr(a, b), c, gold_bmm(a, b), 1e-5)


@pytest.mark.parametrize("strategy", ["split2", "split2_fast", "float32"])
def test_f64_strategy_accuracy(rng, strategy):
    m = n = k = 23
    a = rng.standard_normal((B, m, k))
    b = rng.standard_normal((B, k, n))
    c0 = rng.standard_normal((B, m, n))
    with both_config(f64_strategy=strategy):
        kr, kp = both("dmmdispatch", m, n, k, batch=B, beta=0.0)
        kr1, kp1 = both("dmmdispatch", m, n, k, batch=B, beta=1.0)
        assert isinstance(kp, xp.BatchedSMM) and kp.strategy == strategy
        gold = gold_bmm(a, b)
        agree(kr(a, b), kp(a, b), gold, 1e-6)
        agree(kr1(a, b, c0), kp1(a, b, c0), gold + c0, 1e-6)


def test_f64_beta_one(rng):
    m = n = k = 13
    a = rng.standard_normal((B, m, k))
    b = rng.standard_normal((B, k, n))
    c0 = rng.standard_normal((B, m, n))
    kr, kp = both("dmmdispatch", m, n, k, batch=B, beta=1.0)
    agree(kr(a, b, c0), kp(a, b, c0), gold_bmm(a, b) + c0, 1e-5)


def test_bf16(rng):
    m = n = k = 16
    a = rng.standard_normal((B, m, k), dtype=np.float32)
    b = rng.standard_normal((B, k, n), dtype=np.float32)
    ab, bb = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    kr, kp = both("bsmmdispatch", m, n, k, batch=B, beta=0.0)
    c = kp(ab, bb)
    assert c.dtype == torch.float32
    agree(kr(ab, bb), c, gold_bmm(ab.astype(np.float64),
                                  bb.astype(np.float64)), 1e-6)


def test_bf16_to_bf16_rounds_every_step(rng):
    """bmmdispatch keeps its running sum in bf16, as the TPU kernel does."""
    m = n = k = 23
    a = rng.standard_normal((B, m, k)).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal((B, k, n)).astype(ml_dtypes.bfloat16)
    kr, kp = both("bmmdispatch", m, n, k, batch=B, beta=0.0)
    c = kp(a, b)
    assert c.dtype == torch.bfloat16
    gold = gold_bmm(a.astype(np.float64), b.astype(np.float64))
    agree(kr(a, b), c, gold, 1e-2, tol_pair=1e-2)
    # a sum kept in f32 and rounded once would be ~1e-3 from gold
    assert xp.matdiff(gold, np64(c)).normf_rel > 2e-3


def test_i16_exact(rng):
    m = n = k = 9
    a = rng.integers(-100, 100, (B, m, k)).astype(np.int16)
    b = rng.integers(-100, 100, (B, k, n)).astype(np.int16)
    kr, kp = both("wimmdispatch", m, n, k, batch=B, beta=0.0)
    c = kp(a, b)
    assert c.dtype == torch.int32
    gold = np.einsum("bmk,bkn->bmn", a.astype(np.int64),
                     b.astype(np.int64)).astype(np.int32)
    assert np.array_equal(c.numpy(), gold)
    assert np.array_equal(np.asarray(kr(a, b)), gold)
    cf = xp.wsmmdispatch(m, n, k, batch=B, beta=0.0)(a, b)
    assert cf.dtype == torch.float32 and np.array_equal(cf.numpy(), gold)


def test_batch_reduce(rng):
    m, n, k = 14, 10, 6
    nb = 12
    a = rng.standard_normal((nb, m, k), dtype=np.float32)
    b = rng.standard_normal((nb, k, n), dtype=np.float32)
    kr, kp = both("smmdispatch_reducebatch", m, n, k, beta=0.0)
    assert isinstance(kp, xp.BatchReduceGemm)
    c = kp(a, b)
    assert c.shape == (m, n)
    agree(kr(a, b), c, gold_bmm(a, b).sum(axis=0), 1e-5)


def test_batch_reduce_beta1(rng):
    m = n = k = 8
    nb = 5
    a = rng.standard_normal((nb, m, k), dtype=np.float32)
    b = rng.standard_normal((nb, k, n), dtype=np.float32)
    c0 = rng.standard_normal((m, n)).astype(np.float32)
    kr, kp = both("smmdispatch_reducebatch", m, n, k, beta=1.0)
    agree(kr(a, b, c0), kp(a, b, c0), gold_bmm(a, b).sum(axis=0) + c0, 1e-5)


def test_large_routes_to_xla(rng):
    kr, kp = both("smmdispatch", 256, 256, 256, batch=4, beta=0.0)
    assert isinstance(kr, xt.XlaGemm) and isinstance(kp, xp.XlaGemm)
    a = rng.standard_normal((4, 256, 256), dtype=np.float32)
    b = rng.standard_normal((4, 256, 256), dtype=np.float32)
    agree(kr(a, b), kp(a, b), gold_bmm(a, b), TOL)


def test_single_matrix_gemm(rng):
    kr, kp = both("smmdispatch", 32, 16, 8, beta=0.0)
    a = rng.standard_normal((32, 8), dtype=np.float32)
    b = rng.standard_normal((8, 16), dtype=np.float32)
    agree(kr(a, b), kp(a, b), np.asarray(a, np.float64) @ b, TOL)


def test_packed_path_matches_full(rng):
    m = n = k = 12
    a = rng.standard_normal((B, m, k), dtype=np.float32)
    b = rng.standard_normal((B, k, n), dtype=np.float32)
    kp = xp.smmdispatch(m, n, k, batch=B, beta=0.0)
    assert isinstance(kp, xp.BatchedSMM)
    ap, bp = kp.pack_a(a), kp.pack_b(b)
    assert ap.shape == (m, k, B) and bp.shape == (k, n, B)
    c2 = kp.unpack_c(kp.packed(ap, bp), B)
    np.testing.assert_array_equal(np64(c2), np64(kp(a, b)))
    xp.check(gold_bmm(a, b), np64(c2), TOL)


@pytest.mark.parametrize("pkg", [xt, xp], ids=["jax", "port"])
def test_dispatch_cached(pkg):
    assert pkg.smmdispatch(6, 6, 6, batch=B, beta=0.0) is pkg.smmdispatch(
        6, 6, 6, batch=B, beta=0.0)


@pytest.mark.parametrize("strategy", ["split2", "split2_fast", "float32"])
def test_f64_xlagemm_strategies(rng, strategy):
    m = n = k = 96
    with both_config(f64_strategy=strategy, gemm_threshold=8):
        kr, kp = both("dmmdispatch", m, n, k, batch=4, beta=0.0)
        assert isinstance(kp, xp.XlaGemm)
        a = rng.standard_normal((4, m, k))
        b = rng.standard_normal((4, k, n))
        c = kp(a, b)
        assert c.dtype == np.float64
        agree(kr(a, b), c, gold_bmm(a, b), 1e-6)
        kr1, kp1 = both("dmmdispatch", m, n, k, batch=4, beta=1.0)
        c0 = rng.standard_normal((4, m, n))
        agree(kr1(a, b, c0), kp1(a, b, c0), gold_bmm(a, b) + c0, 1e-6)


@pytest.mark.parametrize("strategy", ["split2", "split2_fast", "float32"])
def test_f64_batch_reduce_strategies(rng, strategy):
    m, n, k = 14, 10, 6
    nb = 5
    a = rng.standard_normal((nb, m, k))
    b = rng.standard_normal((nb, k, n))
    c0 = rng.standard_normal((m, n))
    with both_config(f64_strategy=strategy):
        kr, kp = both("dmmdispatch_reducebatch", m, n, k, beta=0.0)
        c = kp(a, b)
        assert c.dtype == np.float64
        agree(kr(a, b), c, gold_bmm(a, b).sum(axis=0), 1e-6)
        kr1, kp1 = both("dmmdispatch_reducebatch", m, n, k, beta=1.0)
        agree(kr1(a, b, c0), kp1(a, b, c0),
              gold_bmm(a, b).sum(axis=0) + c0, 1e-6)


def test_f64_native_strategy(rng):
    """native is a real f64 product in the port (no x64 switch to need);
    the JAX package raises without x64 (a stated difference)."""
    m = n = k = 23
    a = rng.standard_normal((B, m, k))
    b = rng.standard_normal((B, k, n))
    with both_config(f64_strategy="native"):
        kr, kp = both("dmmdispatch", m, n, k, batch=B, beta=0.0)
        assert isinstance(kr, xt.XlaGemm) and isinstance(kp, xp.XlaGemm)
        import jax
        if not jax.config.jax_enable_x64:
            with pytest.raises(RuntimeError, match="x64"):
                kr(a, b)
        c = kp(a, b)
        gold = np.matmul(a, b)
        assert np.linalg.norm(c - gold) / np.linalg.norm(gold) < 1e-13
        c0 = rng.standard_normal((B, m, n))
        kp1 = xp.dmmdispatch(m, n, k, batch=B, beta=1.0)
        c1 = kp1(a, b, c0)
        assert np.linalg.norm(c1 - gold - c0) / np.linalg.norm(gold) < 1e-13


def test_f64_batched_beta1_keeps_c_low_half(rng):
    m = n = k = 8
    a = rng.standard_normal((B, m, k)) * 1e-8
    b = rng.standard_normal((B, k, n)) * 1e-8
    c0 = rng.standard_normal((B, m, n))  # |C| >> |A@B|: low half matters
    with both_config(f64_strategy="split2_fast"):
        kr, kp = both("dmmdispatch", m, n, k, batch=B, beta=1.0)
        assert isinstance(kp, xp.BatchedSMM)
        c, cr = kp(a, b, c0), kr(a, b, c0)
    gold = c0 + np.matmul(a, b)
    assert np.abs(c - gold).max() < 1e-12
    assert np.abs(c - cr).max() < 1e-12


# ---------------------------------------------------------------------------
# Per-kernel parity on the JAX package's own packed bytes
# ---------------------------------------------------------------------------

PACKED_CASES = [
    # (dispatcher, strategy, beta, kernel)
    ("dmmdispatch", "split2_fast", 0.0, "packed_split2_fast"),
    ("dmmdispatch", "split2_fast", 1.0, "packed_split2_fast"),
    ("smmdispatch", None, 0.0, "packed_f32"),
    ("smmdispatch", None, 1.0, "packed_f32"),
    ("bsmmdispatch", None, 0.0, "packed_f32"),
    ("bmmdispatch", None, 1.0, "packed_f32"),
    ("dmmdispatch", "float32", 1.0, "packed_f32"),
    ("dmmdispatch", "split2", 0.0, "packed_split2"),
    ("dmmdispatch", "split2", 1.0, "packed_split2"),
]


@pytest.mark.parametrize("disp,strategy,beta,kname", PACKED_CASES)
def test_packed_bytes_from_jax(rng, monkeypatch, disp, strategy, beta, kname):
    """The bytes of xsmm_tpu's kern.pack_a/pack_b/pack_c go straight into
    the port's kern.packed(...), which runs the named kernel's path."""
    m, n, k = 23, 23, 23
    called = []
    orig = getattr(smm_packed, kname)
    monkeypatch.setattr(smm_packed, kname,
                        lambda *a, **kw: called.append(1) or orig(*a, **kw))
    a = rng.standard_normal((B, m, k))
    b = rng.standard_normal((B, k, n))
    c = rng.standard_normal((B, m, n))
    with both_config(f64_strategy=strategy or "split2_fast"):
        kr, kp = both(disp, m, n, k, batch=B, beta=beta)
        if kr.is_f64:
            ah, al = xt.split_f64(a)
            bh, bl = xt.split_f64(b)
            ch, cl = xt.split_f64(c)
            ops = {"split2": [kr.pack_a(ah), kr.pack_a(al), kr.pack_b(bh),
                              kr.pack_b(bl)] + ([kr.pack_c(ch), kr.pack_c(cl)]
                                                if beta else []),
                   "split2_fast": [kr.pack_a(ah), kr.pack_b(bh),
                                   kr.pack_b(bl)] + ([kr.pack_c(ch)]
                                                     if beta else []),
                   "float32": [kr.pack_a(ah), kr.pack_b(bh)]
                   + ([kr.pack_c(ch)] if beta else [])}[strategy]
        else:
            in_dt = np.dtype(kr.desc.in_dtype if kr.desc.in_dtype != "bfloat16"
                             else ml_dtypes.bfloat16)
            out_dt = np.dtype(kr.desc.out_dtype if kr.desc.out_dtype !=
                              "bfloat16" else ml_dtypes.bfloat16)
            ops = [kr.pack_a(a.astype(in_dt)), kr.pack_b(b.astype(in_dt))]
            if beta:
                ops.append(kr.pack_c(c.astype(out_dt)))
        ops_np = [np.asarray(o) for o in ops]
        ref = kr.packed(*ops)
        port = kp.packed(*[xp.packed_from_numpy(o, torch.device("cpu"))
                           for o in ops_np])
    assert called, f"{kname} was not reached"
    ref = ref if isinstance(ref, tuple) else (ref,)
    port = port if isinstance(port, tuple) else (port,)
    assert len(ref) == len(port)
    tol = 1e-2 if kr.desc.out_dtype == "bfloat16" else PORT_VS_JAX
    for r, p in zip(ref, port):
        assert tuple(p.shape) == np.shape(r)   # JAX pads Bp to its lane tile
        xp.check(np64(r), np64(p), tol, what=f"{disp} {strategy} beta={beta}")


def test_packed_from_numpy_keeps_bf16_bits(rng):
    x = rng.standard_normal((3, 4, 5)).astype(ml_dtypes.bfloat16)
    t = xp.packed_from_numpy(x, torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))


def test_split_join_f64_match(rng):
    x = rng.standard_normal((4, 5))
    hr, lr = xt.split_f64(x)
    hp, lp = xp.split_f64(x)
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hr))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lr))
    np.testing.assert_array_equal(xp.join_f64(hp, lp), xt.join_f64(hr, lr))
    np.testing.assert_array_equal(xp.join_f64(hp), xt.join_f64(hr))


def test_batched_rejects_f64_out_of_f32_in():
    """A stated difference: the JAX package computes this in f32."""
    with pytest.raises(ValueError, match="batched SMM takes"):
        xp.mmdispatch(4, 4, 4, in_dtype="float32", out_dtype="float64",
                      batch=8, beta=0.0)


# ---------------------------------------------------------------------------
# The tile kernel of ops/csrc/smm_packed.cu (packed_tile_kernel): its
# staging, ring and register tiling, emulated index for index on the CPU
# ---------------------------------------------------------------------------

# its constants: problems a group, rows and columns of C a thread, warps
# down and across a pass, k steps a stage, stages in the ring
TP, TR, TC, RG, CG, TKC, STAGES = 32, 6, 8, 4, 3, 4, 4
TM, TN = RG * TR, CG * TC
# tests/test_torch_gpu.py's SHAPES (M, N, K, Bp)
CARD_SHAPES = [(23, 23, 23, 131), (1, 1, 1, 33), (5, 3, 7, 1000),
               (13, 13, 13, 64), (16, 48, 8, 257), (64, 64, 64, 40),
               (2, 70, 3, 77), (1, 2000, 1, 50)]


def _tile_emulated(sched, a_planes, b_planes, c_in, grid, tma):
    """packed_tile_kernel on the packed planes (A [M, K, Bp], B [K, N, Bp]):
    ``grid`` persistent blocks, each walking its items (group of TP
    problems, row pass, column pass) through a ring of STAGES slots of TKC
    k steps, left NaN where cp.async stages nothing (a stored result that
    read one would be NaN) and zero where a TMA box passes the edges.  With
    cp.async the stage for chunk t + STAGES - 1 is written after chunk t's
    barrier and before its arithmetic, into chunk t - 1's slot; with TMA
    the stage for chunk t + STAGES into chunk t's slot after its arithmetic
    and store.  Warp (rg, cg) holds a TR x TC tile of C for its 32 lanes'
    problems."""
    m, k_, bp = a_planes[0].shape
    n = b_planes[0].shape[1]
    pa, pb = len(a_planes), len(b_planes)
    npm, npn, nk = -(-m // TM), -(-n // TN), -(-k_ // TKC)
    nitems = -(-bp // TP) * npm * npn
    outs = [torch.full((m, n, bp), float("nan")) for _ in range(2)]

    def item(it):
        g, rest = divmod(it, npm * npn)
        return g, rest // npn * TM, rest % npn * TN

    for blk in range(grid):
        mine = (nitems - 1 - blk) // grid + 1 if blk < nitems else 0
        nt = mine * nk
        slots = torch.full((STAGES, pa + pb, max(TM, TN), TKC, TP),
                           float("nan"))

        def stage(t):
            g, m0, n0 = item(blk + t // nk * grid)
            k0, sl = t % nk * TKC, slots[t % STAGES]
            bs = slice(g * TP, min(g * TP + TP, bp))
            w = bs.stop - bs.start
            if tma:
                sl.zero_()
            for kk in range(TKC):
                if k0 + kk >= k_:
                    continue
                for row in range(min(TM, m - m0)):
                    for p, pl in enumerate(a_planes):
                        sl[p, row, kk, :w] = pl[m0 + row, k0 + kk, bs]
                for j in range(min(TN, n - n0)):
                    for p, pl in enumerate(b_planes):
                        sl[pa + p, j, kk, :w] = pl[k0 + kk, n0 + j, bs]

        for t in range(min(STAGES - (not tma), nt)):
            stage(t)
        acc = {}
        for t in range(nt):
            if not tma and t + STAGES - 1 < nt:
                stage(t + STAGES - 1)
            c, sl = t % nk, slots[t % STAGES]
            g, m0, n0 = item(blk + t // nk * grid)
            bs = slice(g * TP, min(g * TP + TP, bp))
            w = bs.stop - bs.start
            for rg in range(RG):
                for cg in range(CG):
                    r0, j0 = m0 + rg * TR, n0 + cg * TC
                    if r0 >= m or j0 >= n:
                        continue  # a dead warp: no arithmetic, no store
                    if c == 0:
                        acc[rg, cg] = [torch.zeros((TR, TC, TP))
                                       for _ in range(2)]
                        for i, ci in enumerate(c_in or ()):
                            blk_c = ci[r0:r0 + TR, j0:j0 + TC, bs]
                            acc[rg, cg][i][:blk_c.shape[0], :blk_c.shape[1],
                                           :w] = blk_c
                    a0, a1 = acc[rg, cg]
                    for kk in range(min(TKC, k_ - c * TKC)):
                        ah = sl[0, rg * TR:rg * TR + TR, kk, None, :]
                        bh = sl[pa, cg * TC:cg * TC + TC, kk][None]
                        if sched == "f32":
                            a0 = a0 + ah * bh
                            continue
                        bl = sl[pa + 1, cg * TC:cg * TC + TC, kk][None]
                        a0 = a0 + ah * bh
                        if sched == "split2_fast":
                            a1 = a1 + ah * bl
                        else:
                            al = sl[1, rg * TR:rg * TR + TR, kk, None, :]
                            a1 = a1 + (ah * bl + al * bh)
                    acc[rg, cg] = [a0, a1]
                    if c == nk - 1:
                        hr, hc = min(TR, m - r0), min(TC, n - j0)
                        res = ([a0 + a1] if sched == "split2_fast"
                               else [a0, a1])
                        for o, v in zip(outs, res):
                            o[r0:r0 + hr, j0:j0 + hc, bs] = v[:hr, :hc, :w]
            if tma and t + STAGES < nt:
                stage(t + STAGES)
    return outs


@pytest.mark.parametrize("m,n,k,bp", CARD_SHAPES)
@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("tma", [False, True], ids=["cp.async", "tma"])
def test_tile_kernel_split2_schedule_matches_plain(rng, m, n, k, bp, beta,
                                                   tma):
    """Kernel 3's tile schedule (emulated, three persistent blocks, either
    staging) gives packed_split2_plain's bits: every element sums its terms
    in k order from the staged A and B it should read."""
    ah, al, bh, bl, ch, cl = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((m, k, bp), (m, k, bp), (k, n, bp), (k, n, bp),
                  (m, n, bp), (m, n, bp)))
    cins = (ch, cl) if beta else None
    got = _tile_emulated("split2", (ah, al), (bh, bl), cins, grid=3, tma=tma)
    want = smm_packed.packed_split2_plain(ah, al, bh, bl,
                                          *(cins or (None, None)))
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        assert torch.equal(g_, w_), (g_ - w_).abs().max()


@pytest.mark.parametrize("m,n,k,bp", [(23, 23, 23, 131), (5, 3, 7, 1000),
                                      (16, 48, 8, 257), (2, 70, 3, 77)])
@pytest.mark.parametrize("sched", ["split2_fast", "f32"])
def test_tile_kernel_other_schedules_match_plain(rng, m, n, k, bp, sched):
    """The same tiling under kernel 1's and kernel 2's (f32 in and out)
    arithmetic, beta 0, TMA staging (the main path's)."""
    ah, bh, bl = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((m, k, bp), (k, n, bp), (k, n, bp)))
    if sched == "f32":
        got = _tile_emulated("f32", (ah,), (bh,), None, grid=2, tma=True)[0]
        want = smm_packed.packed_f32_plain(ah, bh, out_dtype=torch.float32)
    else:
        got = _tile_emulated(sched, (ah,), (bh, bl), None, grid=2,
                             tma=True)[0]
        want = smm_packed.packed_split2_fast_plain(ah, bh, bl)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got - want).abs().max()


def test_packed_staging_checked_and_counted(monkeypatch):
    """Each wrapper names the staging its planes take ("tma" for f32 planes
    on 16 bytes with Bp % 4 == 0, "cp.async" for other f32 planes, "first"
    for 16-bit inputs; for the natural kernel "bulk" where every operand is
    on 16 bytes, else "cp.async"), passes its code to the C entry and counts
    it beside ``launches``; the entry's refusal (-2) raises with nothing
    counted."""
    f32 = torch.float32
    a = torch.ones((3, 5, 8))
    b = torch.ones((5, 4, 8))
    a_off = torch.ones(3 * 5 * 8 + 1)[1:].view(3, 5, 8)
    a_ragged, b_ragged = torch.ones((3, 5, 6)), torch.ones((5, 4, 6))
    assert a.data_ptr() % 16 == 0 and a_off.data_ptr() % 16
    assert smm_packed.staging(a, b) == "tma"
    assert smm_packed.staging(a_off, b) == "cp.async"
    assert smm_packed.staging(a_ragged, b_ragged) == "cp.async"
    assert smm_packed.staging(a.bfloat16(), b.bfloat16()) == "first"
    calls = []

    def entry(rc):
        def record(*args):
            calls.append(args[-3])  # the staging code
            return rc
        return types.SimpleNamespace(xsmm_packed_f32=record,
                                     xsmm_packed_split2_fast=record,
                                     xsmm_packed_split2=record,
                                     xsmm_natural_f32=record)

    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *s, device=None, **kw: empty(*s, **kw))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(smm_packed, "_lib", lambda: entry(0))
    smm_packed.reset_launches()
    smm_packed.packed_split2(a, a, b, b)
    smm_packed.packed_split2_fast(a_off, b, b)
    smm_packed.packed_f32(a_ragged, b_ragged, out_dtype=f32)
    smm_packed.packed_f32(a.bfloat16(), b.bfloat16(), out_dtype=f32)
    # the natural kernel: "bulk" where every operand is on 16 bytes
    nat = torch.ones((8, 3, 5))
    nat_off = torch.ones(8 * 3 * 5 + 1)[1:].view(8, 3, 5)
    smm_packed.natural_f32(nat, nat.transpose(1, 2).contiguous())
    smm_packed.natural_f32(nat_off, nat, trans_b=True)
    assert calls == [0, 1, 1, 2, 3, 1]
    assert smm_packed.launches == {"packed_f32": 2, "packed_split2_fast": 1,
                                   "packed_split2": 1, "natural_f32": 2}
    assert smm_packed.staging_launches == {"tma": 1, "cp.async": 3,
                                           "first": 1, "bulk": 1}
    monkeypatch.setattr(smm_packed, "_lib", lambda: entry(-2))
    with pytest.raises(ValueError, match="staging does not fit"):
        smm_packed.packed_split2(a, a, b, b)
    with pytest.raises(ValueError, match="staging does not fit"):
        smm_packed.packed_f32(a.bfloat16(), b.bfloat16(), out_dtype=f32)
    with pytest.raises(ValueError, match="staging does not fit"):
        smm_packed.natural_f32(nat, nat, trans_b=True)
    assert sum(smm_packed.launches.values()) == 6
    assert sum(smm_packed.staging_launches.values()) == 6
    smm_packed.reset_launches()
    assert set(smm_packed.staging_launches.values()) == {0}


# ---------------------------------------------------------------------------
# The natural kernel (smm_packed.natural_f32): the route BatchedSMM.__call__
# takes, its bits against the pack route, and its staging, ring and lanes
# emulated index for index on the CPU
# ---------------------------------------------------------------------------

def _offset(x):
    """``x``'s values in a tensor one element past the start of its storage
    (off 16 bytes)."""
    base = torch.empty(x.numel() + 1, dtype=x.dtype)
    out = base[1:].view(x.shape)
    out.copy_(x)
    return out


# (id, dispatcher, (m, n, k), batch, beta, transa, transb, operands, route):
# operands "plain" (contiguous), "offset" (A off 16 bytes) or "view" (a
# non-contiguous A)
NATURAL_CASES = [
    ("b37", "smmdispatch", (23, 23, 23), 37, 0.0, "N", "N", "plain",
     "natural"),
    ("b1024", "smmdispatch", (23, 23, 23), 1024, 0.0, "N", "N", "plain",
     "natural"),
    ("b37-beta1", "smmdispatch", (23, 23, 23), 37, 1.0, "N", "N", "plain",
     "natural"),
    ("b1024-beta1", "smmdispatch", (23, 23, 23), 1024, 1.0, "N", "N",
     "plain", "natural"),
    ("trans-a", "smmdispatch", (23, 23, 23), 37, 0.0, "T", "N", "plain",
     "natural"),
    ("trans-b-beta1", "smmdispatch", (23, 23, 23), 37, 1.0, "N", "T",
     "plain", "natural"),
    ("trans-ab", "smmdispatch", (5, 30, 7), 37, 0.0, "T", "T", "plain",
     "natural"),
    ("offset", "smmdispatch", (23, 23, 23), 37, 1.0, "N", "N", "offset",
     "natural"),
    ("bf16", "bsmmdispatch", (23, 23, 23), 37, 0.0, "N", "N", "plain",
     "pack"),
    ("f64", "dmmdispatch", (23, 23, 23), 37, 0.0, "N", "N", "plain", "pack"),
    ("view", "smmdispatch", (23, 23, 23), 37, 0.0, "N", "N", "view", "pack"),
    ("too-big", "smmdispatch", (50, 50, 50), 6, 0.0, "N", "N", "plain",
     "pack"),
    # rings that fit fewer than NATURAL_ROUTE_BLOCKS blocks on an SM
    ("few-blocks", "smmdispatch", (36, 36, 36), 6, 0.0, "N", "N", "plain",
     "pack"),
    ("skinny", "smmdispatch", (1, 2000, 1), 6, 1.0, "N", "N", "plain",
     "pack"),
]


@pytest.mark.parametrize(
    "disp,mnk,batch,beta,transa,transb,operands,route",
    [c[1:] for c in NATURAL_CASES], ids=[c[0] for c in NATURAL_CASES])
def test_natural_route_matches_pack_route(rng, monkeypatch, disp, mnk, batch,
                                          beta, transa, transb, operands,
                                          route):
    """``kernel(a, b[, c])`` takes the natural kernel for f32 in and out on
    contiguous operands whose group fits its staging, bit for bit the pack
    route (``unpack_c(packed(pack_a(a), pack_b(b)[, pack_c(c)]))``), as a
    contiguous [B, M, N]; bf16 in, f64, a non-contiguous operand, a shape
    the staging cannot hold and one whose ring leaves an SM fewer than
    ``NATURAL_ROUTE_BLOCKS`` blocks pack."""
    m, n, k = mnk
    called = []
    for name in ("natural_f32", "packed_f32", "packed_split2_fast"):
        orig = getattr(smm_packed, name)
        monkeypatch.setattr(smm_packed, name,
                            lambda *a, _n=name, _o=orig, **kw:
                            called.append(_n) or _o(*a, **kw))
    dt = {"smmdispatch": torch.float32, "bsmmdispatch": torch.bfloat16,
          "dmmdispatch": torch.float64}[disp]
    a = torch.from_numpy(rng.standard_normal(
        (batch, k, m) if transa == "T" else (batch, m, k))).to(dt)
    b = torch.from_numpy(rng.standard_normal(
        (batch, n, k) if transb == "T" else (batch, k, n))).to(dt)
    c = torch.from_numpy(rng.standard_normal((batch, m, n))).float()
    if operands == "offset":
        a = _offset(a)
        assert a.data_ptr() % 16 and a.is_contiguous()
    elif operands == "view":
        a = torch.cat([a, a], dim=2)[:, :, :k]
        assert not a.is_contiguous()
    kern = getattr(xp, disp)(m, n, k, batch=batch, beta=beta, transa=transa,
                             transb=transb)
    assert isinstance(kern, xp.BatchedSMM)
    few = smm_packed.natural_blocks(m, n, k) < smm_packed.NATURAL_ROUTE_BLOCKS
    assert few == (mnk in ((50, 50, 50), (36, 36, 36), (1, 2000, 1)))
    got = kern(a, b, c) if beta else kern(a, b)
    assert called == (["natural_f32"] if route == "natural" else
                      ["packed_split2_fast" if dt == torch.float64
                       else "packed_f32"])
    if route == "pack":
        return
    ops = [kern.pack_a(a), kern.pack_b(b)] + ([kern.pack_c(c)] if beta
                                              else [])
    want = kern.unpack_c(kern.packed(*ops), batch)
    assert got.is_contiguous() and got.dtype == torch.float32
    assert tuple(got.shape) == (batch, m, n)
    assert torch.equal(got, want), (got - want).abs().max()
    assert torch.equal(got, smm_packed.natural_f32_plain(
        a, b, c if beta else None, trans_a=transa == "T",
        trans_b=transb == "T"))


# natural_kernel's constants: problems a group, lanes a problem, rows of C
# a lane holds a pass, columns a pass, slots of a block's ring
NAT_G, NAT_RT, NAT_R, NAT_NT, NAT_SLOTS = 4, 8, 3, 24, 2
NAT_TM = NAT_RT * NAT_R


@pytest.mark.parametrize("c_name,value", [
    ("NAT_G", smm_packed.NATURAL_GROUP), ("NAT_SLOTS",
                                          smm_packed.NATURAL_SLOTS),
    ("NAT_NT", smm_packed.NATURAL_COLUMNS),
    ("NAT_MAX_SMEM", smm_packed.NATURAL_MAX_SMEM),
    ("NAT_G", NAT_G), ("NAT_RT", NAT_RT), ("NAT_R", NAT_R),
    ("NAT_NT", NAT_NT), ("NAT_SLOTS", NAT_SLOTS)])
def test_natural_constants_are_the_kernels(c_name, value):
    """The natural kernel's constants that the route rule
    (``smm_packed.natural_blocks``) and the emulation below mirror are those
    of ops/csrc/smm_packed.cu."""
    src = (Path(smm_packed.__file__).parent / "csrc"
           / "smm_packed.cu").read_text()
    found = re.findall(rf"constexpr int {c_name} = (\d+);", src)
    assert found == [str(value)]


# (m, n, k) -> blocks of the natural kernel an SM holds: the route takes
# 3 and more, the wrapper launches 1 and more (the card tests check 49^3
# launches and 50^3 is refused)
@pytest.mark.parametrize("mnk,blocks", [
    ((23, 23, 23), 4), ((16, 16, 16), 9), ((28, 28, 28), 3),
    ((32, 32, 32), 2), ((1, 2000, 1), 1), ((49, 49, 49), 1),
    ((50, 50, 50), 0)])
def test_natural_blocks(mnk, blocks):
    assert smm_packed.natural_blocks(*mnk) == blocks


def _natural_emulated(a, b, c_in, grid, trans_a, trans_b, bulk):
    """natural_kernel on batch-first operands: ``grid`` one-warp blocks,
    each walking its groups of NAT_G problems through a ring of NAT_SLOTS
    slots (A | B | C parts) in one flat shared memory with the mbarriers and
    NAT_NT words of padding after them (NaN where nothing was staged); a
    whole group staged in one run per operand and a ragged one (or any
    group without ``bulk``) problem by problem; lane 8p + r computes rows
    r, r + 8, r + 16 of each NAT_TM-row pass of problem p, all NAT_NT
    columns of a pass, rows past M clamped to M - 1 and columns past N
    clamped (trans_b) or read on (every read must stay inside the shared
    memory), into the slot's C part, storing rows < M and columns < N; the
    group's C leaves as one run, and the slot takes the block's group
    NAT_SLOTS on."""
    nb = a.shape[0]
    m, k = (a.shape[2], a.shape[1]) if trans_a else a.shape[1:]
    n = b.shape[1] if trans_b else b.shape[2]
    mk, kn, mn = m * k, k * n, m * n
    slot = NAT_G * (mk + kn + mn)
    size = NAT_SLOTS * slot + NAT_SLOTS * 2 + NAT_NT   # mbarriers: 8 bytes
    af, bf = a.reshape(-1), b.reshape(-1)
    cf = None if c_in is None else c_in.reshape(-1)
    out = torch.full((nb * mn,), float("nan"))
    ngroups = -(-nb // NAT_G)
    for blk in range(grid):
        mine = (ngroups - 1 - blk) // grid + 1 if blk < ngroups else 0
        smem = torch.full((size,), float("nan"))

        def issue(t):
            if t >= mine:
                return
            p0 = (blk + t * grid) * NAT_G
            np_ = min(NAT_G, nb - p0)
            base = t % NAT_SLOTS * slot
            parts = [(0, af, mk), (NAT_G * mk, bf, kn)]
            if cf is not None:
                parts.append((NAT_G * (mk + kn), cf, mn))
            for off, src, sz in parts:
                if bulk and np_ == NAT_G:   # one run of the whole group
                    smem[base + off:base + off + NAT_G * sz] = src[
                        p0 * sz:(p0 + NAT_G) * sz]
                else:                       # word by word, np_ problems
                    for q in range(np_ * sz):
                        smem[base + off + q] = src[p0 * sz + q]

        for s in range(NAT_SLOTS):
            issue(s)
        for t in range(mine):
            p0 = (blk + t * grid) * NAT_G
            np_ = min(NAT_G, nb - p0)
            base = t % NAT_SLOTS * slot
            cs = base + NAT_G * (mk + kn)
            for lane in range(32):
                p, r = divmod(lane, NAT_RT)
                if p >= np_:
                    continue
                a_s, b_s = base + p * mk, base + NAT_G * mk + p * kn
                c_s = cs + p * mn
                for m0 in range(0, m, NAT_TM):
                    rows = [m0 + r + i * NAT_RT for i in range(NAT_R)]
                    arow = torch.tensor([min(x, m - 1) for x in rows])
                    for n0 in range(0, n, NAT_NT):
                        cols = torch.arange(n0, n0 + NAT_NT)
                        ok = ((torch.tensor(rows) < m)[:, None]
                              & (cols < n)[None, :])
                        idx = torch.tensor(rows)[:, None] * n + cols[None, :]
                        acc = torch.zeros(ok.shape)
                        if cf is not None:
                            acc[ok] = smem[c_s + idx[ok]]
                        for kk in range(k):
                            ai = a_s + (arow + kk * m if trans_a
                                        else arow * k + kk)
                            bi = b_s + (cols.clamp(max=n - 1) * k + kk
                                        if trans_b else kk * n + cols)
                            assert int(bi.max()) < size
                            acc = acc + smem[ai][:, None] * smem[bi][None, :]
                        smem[c_s + idx[ok]] = acc[ok]
            out[p0 * mn:(p0 + np_) * mn] = smem[cs:cs + np_ * mn]
            issue(t + NAT_SLOTS)
    return out.view(nb, m, n)


@pytest.mark.parametrize("m,n,k,nb,grid", [
    (23, 23, 23, 37, 3), (5, 3, 7, 61, 4), (30, 50, 9, 9, 2), (1, 1, 1, 6, 3),
    (23, 23, 23, 8, 5)])
@pytest.mark.parametrize("trans", ["NN", "TT"])
@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("bulk", [True, False], ids=["bulk", "cp.async"])
def test_natural_kernel_emulated_matches_plain(rng, m, n, k, nb, grid, trans,
                                               beta, bulk):
    """natural_kernel's groups, ring, lanes, row and column passes and its
    two stagings, emulated, give natural_f32_plain's bits: ragged last
    groups (37, 61, 9, 6 problems), more blocks than groups (8 problems on
    5 blocks), 30 rows (two passes) and 50 columns (three)."""
    ta, tb = trans[0] == "T", trans[1] == "T"
    a = torch.from_numpy(rng.standard_normal(
        (nb, k, m) if ta else (nb, m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(
        (nb, n, k) if tb else (nb, k, n)).astype(np.float32))
    c = (torch.from_numpy(rng.standard_normal((nb, m, n)).astype(np.float32))
         if beta else None)
    got = _natural_emulated(a, b, c, grid, ta, tb, bulk)
    want = smm_packed.natural_f32_plain(a, b, c, trans_a=ta, trans_b=tb)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got - want).abs().max()
