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
import types

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
    for 16-bit inputs), passes its code to the C entry and counts it beside
    ``launches``; the entry's refusal (-2) raises with nothing counted."""
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
                                     xsmm_packed_split2=record)

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
    assert calls == [0, 1, 1, 2]
    assert smm_packed.launches == {"packed_f32": 2, "packed_split2_fast": 1,
                                   "packed_split2": 1}
    assert smm_packed.staging_launches == {"tma": 1, "cp.async": 2,
                                           "first": 1}
    monkeypatch.setattr(smm_packed, "_lib", lambda: entry(-2))
    with pytest.raises(ValueError, match="staging does not fit"):
        smm_packed.packed_split2(a, a, b, b)
    with pytest.raises(ValueError, match="staging does not fit"):
        smm_packed.packed_f32(a.bfloat16(), b.bfloat16(), out_dtype=f32)
    assert sum(smm_packed.launches.values()) == 4
    assert sum(smm_packed.staging_launches.values()) == 4
    smm_packed.reset_launches()
    assert set(smm_packed.staging_launches.values()) == {0}
