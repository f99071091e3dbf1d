"""Card-only tests: each CUDA kernel (the packed batched-GEMM kernels and
the sparse x dense kernels) against its plain version.

The kernels have no CPU mode, so these tests need a CUDA card and skip
elsewhere (the check is made in the ``cuda`` fixture).  On a CUDA machine:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

The kernels round every product and every sum separately, in the plain
versions' k order, so kernel and plain version must agree exactly.
"""

import numpy as np
import pytest
import torch

import xsmm_tpu_torch as xp
from xsmm_tpu_torch.ops import smm_packed

pytestmark = pytest.mark.gpu

# (M, N, K, Bp): ragged Bp everywhere; N > 32 runs the kernels' N-tile loop
SHAPES = [(23, 23, 23, 131), (1, 1, 1, 33), (5, 3, 7, 1000),
          (13, 13, 13, 64), (16, 48, 8, 257), (64, 64, 64, 40),
          (2, 70, 3, 77), (1, 2000, 1, 50)]

F32_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.float16, torch.float16),
             (torch.float16, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    xp.set_config(target="cuda")
    yield torch.device("cuda", 0)
    xp.set_config(target="")


def _planes(dev, seed, *shapes, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype) for s in shapes]


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), (got.double() - want.double()).abs().max()


@pytest.mark.parametrize("m,n,k,bp", SHAPES)
@pytest.mark.parametrize("in_dt,out_dt", F32_TYPES)
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_f32_matches_plain(cuda, m, n, k, bp, in_dt, out_dt, beta):
    a, b = _planes(cuda, 1, (m, k, bp), (k, n, bp), dtype=in_dt)
    cin = _planes(cuda, 2, (m, n, bp), dtype=out_dt)[0] if beta else None
    before = smm_packed.launches["packed_f32"]
    got = smm_packed.packed_f32(a, b, cin, out_dtype=out_dt)
    torch.cuda.synchronize()
    assert smm_packed.launches["packed_f32"] == before + 1
    _same(got, smm_packed.packed_f32_plain(a, b, cin, out_dtype=out_dt))


@pytest.mark.parametrize("m,n,k,bp", SHAPES)
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_split2_fast_matches_plain(cuda, m, n, k, bp, beta):
    ah, bh, bl, c = _planes(cuda, 3, (m, k, bp), (k, n, bp), (k, n, bp),
                            (m, n, bp))
    cin = c if beta else None
    got = smm_packed.packed_split2_fast(ah, bh, bl, cin)
    torch.cuda.synchronize()
    _same(got, smm_packed.packed_split2_fast_plain(ah, bh, bl, cin))


@pytest.mark.parametrize("m,n,k,bp", SHAPES)
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_split2_matches_plain(cuda, m, n, k, bp, beta):
    ah, al, bh, bl, ch, cl = _planes(cuda, 4, (m, k, bp), (m, k, bp),
                                     (k, n, bp), (k, n, bp), (m, n, bp),
                                     (m, n, bp))
    cins = (ch, cl) if beta else (None, None)
    got = smm_packed.packed_split2(ah, al, bh, bl, *cins)
    torch.cuda.synchronize()
    want = smm_packed.packed_split2_plain(ah, al, bh, bl, *cins)
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.parametrize("strategy", ["split2_fast", "split2", "float32"])
@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_dmm_entry_point_card_equals_cpu(cuda, strategy, beta):
    """The f64 entry point gives the same bits on the card as on the CPU."""
    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal((1000, 23, 23)) for _ in range(3))
    args = (a, b, c) if beta else (a, b)
    out = {}
    for target in ("cuda", "cpu"):
        xp.set_config(target=target, f64_strategy=strategy)
        kern = xp.dmmdispatch(23, 23, 23, batch=1000, beta=beta)
        assert isinstance(kern, xp.BatchedSMM)
        out[target] = kern(*args)
    xp.set_config(f64_strategy="split2_fast")
    np.testing.assert_array_equal(out["cuda"], out["cpu"])


def test_cuda_tensor_never_takes_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")
    monkeypatch.setattr(smm_packed, "packed_f32_plain", boom)
    a, b = _planes(cuda, 6, (4, 4, 64), (4, 4, 64))
    smm_packed.packed_f32(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The four sparse x dense kernels (ops/csrc/spgemm.cu)
# ---------------------------------------------------------------------------

from xsmm_tpu_torch.ops import spgemm_kernels as sk  # noqa: E402

SCHEDULES = {"split2": (True, True), "split2_fast": (True, False),
             "split2_wout": (False, True), "fold": (False, False)}

# (M, K, density, N): PyFR-shaped operators at a ragged N; a row-less
# operator; N = 1; K = 300 and 600 take the kernels' unstaged path (the
# B tile would not leave room for two blocks on an SM)
SPARSE_SHAPES = [(105, 75, 0.11, 65536 + 37), (150, 150, 0.05, 4099),
                 (12, 16, 0.3, 1), (5, 7, 0.0, 300), (40, 300, 0.05, 1000),
                 (33, 600, 0.03, 129)]


def _sparse(dev, m, k, density, n, seed):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, k)) < density,
                 rng.standard_normal((m, k)), 0.0)
    if m > 4:
        a[3] = 0.0  # an empty row
    op = sk.SparseOperator(xp.Csr.from_dense(a), dev)
    bh, bl = _planes(dev, seed, (k, n), (k, n))
    ch, cl = _planes(dev, seed + 1, (m, n), (m, n))
    return op, bh, bl, ch, cl


@pytest.mark.parametrize("m,k,density,n", SPARSE_SHAPES)
def test_spgemm_f32_matches_plain(cuda, m, k, density, n):
    op, bh, _, ch, _ = _sparse(cuda, m, k, density, n, 7)
    before = dict(sk.launches)
    got = sk.unroll_f32(op, bh)
    acc = sk.acc_f32(op, ch, bh)
    torch.cuda.synchronize()
    assert sk.launches["spgemm_unroll_f32"] == before["spgemm_unroll_f32"] + 1
    assert sk.launches["spgemm_acc_f32"] == before["spgemm_acc_f32"] + 1
    _same(got, sk.unroll_f32_plain(op, bh))
    _same(acc, sk.acc_f32_plain(op, ch, bh))
    if m > 4:
        assert not got[3].any()
        assert torch.equal(acc[3], ch[3])


@pytest.mark.parametrize("m,k,density,n", SPARSE_SHAPES)
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_spgemm_f64_matches_plain(cuda, m, k, density, n, sched):
    b_lo, c_lo = SCHEDULES[sched]
    op, bh, bl, ch, cl = _sparse(cuda, m, k, density, n, 8)
    bl = bl if b_lo else None
    clin = cl if c_lo else None
    got = sk.unroll_f64(op, bh, bl, c_lo=c_lo)
    acc = sk.acc_f64(op, ch, clin, bh, bl)
    torch.cuda.synchronize()
    want = sk.unroll_f64_plain(op, bh, bl, c_lo=c_lo)
    want_acc = sk.acc_f64_plain(op, ch, clin, bh, bl)
    for g, w in zip(*(x if c_lo else (x,) for x in (got, want))):
        _same(g, w)
    for g, w in zip(*(x if c_lo else (x,) for x in (acc, want_acc))):
        _same(g, w)


@pytest.mark.parametrize("sched", sorted(SCHEDULES) + ["float32"])
def test_spgemm_entry_point_card_equals_cpu(cuda, sched):
    """create_dcsr_reg / create_csr_soa and acc_fn give the same bits on
    the card as on the CPU."""
    rng = np.random.default_rng(9)
    a = np.where(rng.random((75, 105)) < 0.08,
                 rng.standard_normal((75, 105)), 0.0)
    b = rng.standard_normal((105, 1000))
    c = rng.standard_normal((75, 1000)).astype(np.float32)
    out = {}
    for target in ("cuda", "cpu"):
        xp.set_config(target=target)
        if sched == "float32":
            kern = xp.create_csr_soa(a, 1000)
            b32 = b.astype(np.float32)
            out[target] = [kern(b32).cpu().numpy(),
                           kern.acc_fn(c, b32).cpu().numpy()]
        else:
            kern = xp.create_dcsr_reg(a, 1000, f64_schedule=sched)
            bh = b.astype(np.float32)
            bs = [bh, (b - bh).astype(np.float32)] if kern.b_lo else [bh]
            cs = [c, c * 1e-8] if kern.c_lo else [c]
            acc = kern.acc_fn(*cs, *bs)
            acc = acc if kern.c_lo else (acc,)
            out[target] = [kern(b)] + [x.cpu().numpy() for x in acc]
    for x, y in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(x, y)


def test_sparse_cuda_tensor_never_takes_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")
    for name in ("unroll_f32_plain", "unroll_f64_plain", "acc_f32_plain",
                 "acc_f64_plain"):
        monkeypatch.setattr(sk, name, boom)
    op, bh, bl, ch, cl = _sparse(cuda, 12, 16, 0.3, 100, 10)
    sk.unroll_f32(op, bh)
    sk.acc_f32(op, ch, bh)
    sk.unroll_f64(op, bh, bl, c_lo=True)
    sk.acc_f64(op, ch, cl, bh, bl)
    torch.cuda.synchronize()
