"""Card-only tests: each CUDA kernel (the packed batched-GEMM kernels, the
sparse x dense kernels, the tiled GEMM, the copy and transpose, the packed
GETRF/TRSM kernels and the RNN sequence kernels) against its plain version;
and the training framework's card paths (the CUDA-graph epoch against the
eager loop, the loaders' pinned copies to the card).

The kernels have no CPU mode, so these tests need a CUDA card and skip
elsewhere (the check is made in the ``cuda`` fixture).  On a CUDA machine:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

The batched and sparse kernels round every product and every sum
separately, in the plain versions' k order, so kernel and plain version
must agree exactly; so must the copies.  The tiled GEMM sums in f32 in
another order than its plain version: 1e-5 rel-Frobenius (1e-2 for a
16-bit output).  The RNN kernels: 1e-5 with f32 R, 1e-3 with bf16 R.
"""

import itertools

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


def _staged(want_staging, fn, *args, **kw):
    """``fn(*args, **kw)``, which must launch once on ``want_staging`` and
    count it there."""
    before = dict(smm_packed.staging_launches)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    before[want_staging] += 1
    assert smm_packed.staging_launches == before
    return out


@pytest.mark.parametrize("m,n,k,bp", SHAPES)
@pytest.mark.parametrize("in_dt,out_dt", F32_TYPES)
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_f32_matches_plain(cuda, m, n, k, bp, in_dt, out_dt, beta):
    a, b = _planes(cuda, 1, (m, k, bp), (k, n, bp), dtype=in_dt)
    cin = _planes(cuda, 2, (m, n, bp), dtype=out_dt)[0] if beta else None
    before = smm_packed.launches["packed_f32"]
    want_staging = ("first" if in_dt != torch.float32
                    else "tma" if bp % 4 == 0 else "cp.async")
    assert smm_packed.staging(a, b) == want_staging
    got = _staged(want_staging, smm_packed.packed_f32, a, b, cin,
                  out_dtype=out_dt)
    assert smm_packed.launches["packed_f32"] == before + 1
    _same(got, smm_packed.packed_f32_plain(a, b, cin, out_dtype=out_dt))


@pytest.mark.parametrize("m,n,k,bp", SHAPES)
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_split2_fast_matches_plain(cuda, m, n, k, bp, beta):
    ah, bh, bl, c = _planes(cuda, 3, (m, k, bp), (k, n, bp), (k, n, bp),
                            (m, n, bp))
    cin = c if beta else None
    got = _staged("tma" if bp % 4 == 0 else "cp.async",
                  smm_packed.packed_split2_fast, ah, bh, bl, cin)
    _same(got, smm_packed.packed_split2_fast_plain(ah, bh, bl, cin))


@pytest.mark.parametrize("m,n,k,bp", SHAPES)
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_split2_matches_plain(cuda, m, n, k, bp, beta):
    ah, al, bh, bl, ch, cl = _planes(cuda, 4, (m, k, bp), (m, k, bp),
                                     (k, n, bp), (k, n, bp), (m, n, bp),
                                     (m, n, bp))
    cins = (ch, cl) if beta else (None, None)
    got = _staged("tma" if bp % 4 == 0 else "cp.async",
                  smm_packed.packed_split2, ah, al, bh, bl, *cins)
    want = smm_packed.packed_split2_plain(ah, al, bh, bl, *cins)
    _same(got[0], want[0])
    _same(got[1], want[1])


def _offset_planes(dev, seed, *shapes, dtype=torch.float32):
    """Contiguous planes that start one element past an aligned address:
    the kernels stage them one problem at a time."""
    out = []
    for i, s in enumerate(shapes):
        base = _planes(dev, seed + i, (int(np.prod(s)) + 1,), dtype=dtype)[0]
        out.append(base[1:].view(s))
    return out


@pytest.mark.parametrize("m,n,k,bp", [(23, 23, 23, 131), (5, 3, 7, 1000),
                                      (16, 48, 8, 258), (64, 64, 64, 40)])
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_offset_planes_match_plain(cuda, m, n, k, bp, beta):
    """The three schedules on planes one element off their alignment (and
    Bp % 4 != 0 in three shapes): the element-wise staging (cp.async for
    f32 planes, counted), bit for bit."""
    ah, al, bh, bl, ch, cl = _offset_planes(
        cuda, 60, (m, k, bp), (m, k, bp), (k, n, bp), (k, n, bp), (m, n, bp),
        (m, n, bp))
    assert ah.data_ptr() % 16
    cins = (ch, cl) if beta else (None, None)
    got = _staged("cp.async", smm_packed.packed_split2, ah, al, bh, bl, *cins)
    want = smm_packed.packed_split2_plain(ah, al, bh, bl, *cins)
    _same(got[0], want[0])
    _same(got[1], want[1])
    _same(_staged("cp.async", smm_packed.packed_split2_fast, ah, bh, bl,
                  cins[0]),
          smm_packed.packed_split2_fast_plain(ah, bh, bl, cins[0]))
    for dt in (torch.float32, torch.bfloat16):
        x, y = _offset_planes(cuda, 70, (m, k, bp), (k, n, bp), dtype=dt)
        c = ch.to(dt) if beta else None
        _same(_staged("cp.async" if dt == torch.float32 else "first",
                      smm_packed.packed_f32, x, y, c, out_dtype=dt),
              smm_packed.packed_f32_plain(x, y, c, out_dtype=dt))


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
# The natural kernel (ops/csrc/smm_packed.cu natural_kernel): kernel 2's f32
# schedule on batch-first operands
# ---------------------------------------------------------------------------

def _natural_ops(dev, seed, nb, m, n, k, ta, tb, offset):
    """A, B, C_in of ``nb`` problems, batch-first (A and B transposed per
    ``ta``/``tb``); with ``offset`` each starts one element past 16 bytes."""
    shapes = ((nb, k, m) if ta else (nb, m, k), (nb, n, k) if tb
              else (nb, k, n), (nb, m, n))
    if offset:
        return _offset_planes(dev, seed, *shapes)
    return _planes(dev, seed, *shapes)


@pytest.mark.parametrize("m,n,k,nb", [s for s in SHAPES
                                      if smm_packed.natural_blocks(*s[:3])]
                         + [(30, 50, 9, 9)])
@pytest.mark.parametrize("trans", ["NN", "TN", "NT", "TT"])
@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("offset", [False, True], ids=["bulk", "cp.async"])
def test_natural_f32_matches_plain(cuda, m, n, k, nb, trans, beta, offset):
    """The natural kernel against its plain version, bit for bit, on its
    staging ("bulk" on 16 bytes, ragged tails included; "cp.async" off
    them), counted."""
    ta, tb = trans[0] == "T", trans[1] == "T"
    a, b, c = _natural_ops(cuda, 80, nb, m, n, k, ta, tb, offset)
    cin = c if beta else None
    before = smm_packed.launches["natural_f32"]
    got = _staged("cp.async" if offset else "bulk", smm_packed.natural_f32,
                  a, b, cin, trans_a=ta, trans_b=tb)
    assert smm_packed.launches["natural_f32"] == before + 1
    assert got.is_contiguous()
    _same(got, smm_packed.natural_f32_plain(a, b, cin, trans_a=ta,
                                            trans_b=tb))


@pytest.mark.parametrize("nb", [131072, 131071])
@pytest.mark.parametrize("beta", [0.0, 1.0])
@pytest.mark.parametrize("offset", [False, True], ids=["bulk", "cp.async"])
def test_natural_call_equals_pack_route(cuda, nb, beta, offset):
    """``smmdispatch(23, 23, 23)(a, b[, c])`` at the benchmark's batch (and
    one less: a ragged last group), on tensors on 16 bytes and on ``x[1:]``
    views off them: one natural launch on its staging, no kernel 2, and
    the bits of its plain version and of the pack route (kernel 2)."""
    m = n = k = 23
    a, b, c = _natural_ops(cuda, 90, nb, m, n, k, False, False, offset)
    kern = xp.smmdispatch(m, n, k, batch=nb, beta=beta)
    smm_packed.reset_launches()
    got = kern(a, b, c) if beta else kern(a, b)
    torch.cuda.synchronize()
    st = "cp.async" if offset else "bulk"
    assert smm_packed.launches == {"packed_f32": 0, "packed_split2_fast": 0,
                                   "packed_split2": 0, "natural_f32": 1}
    assert smm_packed.staging_launches == {**dict.fromkeys(
        smm_packed.STAGINGS, 0), st: 1}
    cin = c if beta else None
    _same(got, smm_packed.natural_f32_plain(a, b, cin))
    ops = [kern.pack_a(a), kern.pack_b(b)] + ([kern.pack_c(c)] if beta
                                              else [])
    _same(got, kern.unpack_c(kern.packed(*ops), nb))
    assert smm_packed.launches["packed_f32"] == 1


def test_natural_rule_keeps_the_pack_route(cuda):
    """Calls the rule sends to the pack route launch kernel 2 and never the
    natural kernel: a non-contiguous operand, bf16 in, a shape whose group
    does not fit the staging, and shapes whose ring leaves an SM fewer than
    ``NATURAL_ROUTE_BLOCKS`` blocks (32^3 and the skinny 1 x 2000 x 1)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a, b = (torch.randn((64, 23, 23), generator=g, device=cuda)
            for _ in range(2))
    big = torch.randn((8, 50, 50), generator=g, device=cuda)
    mid = torch.randn((8, 32, 32), generator=g, device=cuda)
    sa, sb = (torch.randn(s, generator=g, device=cuda)
              for s in ((8, 1, 1), (8, 1, 2000)))
    calls = [(xp.smmdispatch(23, 23, 23, batch=64, beta=0.0),
              (a.transpose(1, 2), b)),
             (xp.bsmmdispatch(23, 23, 23, batch=64, beta=0.0),
              (a.bfloat16(), b.bfloat16())),
             (xp.smmdispatch(50, 50, 50, batch=8, beta=0.0), (big, big)),
             (xp.smmdispatch(32, 32, 32, batch=8, beta=0.0), (mid, mid)),
             (xp.smmdispatch(1, 2000, 1, batch=8, beta=0.0), (sa, sb))]
    for kern, ops in calls:
        assert isinstance(kern, xp.BatchedSMM)
        smm_packed.reset_launches()
        kern(*ops)
        torch.cuda.synchronize()
        assert smm_packed.launches["packed_f32"] == 1
        assert smm_packed.launches["natural_f32"] == 0


@pytest.mark.parametrize("mnk", [49, 50])
def test_natural_launch_limit_is_the_kernels(cuda, mnk):
    """``smm_packed.natural_blocks`` and the C entry agree on the largest
    ring a block holds: 49^3 (1 block an SM) launches and gives its plain
    version's bits; 50^3 (0) is refused with nothing launched."""
    a, b, _ = _natural_ops(cuda, 95, 9, mnk, mnk, mnk, False, False, False)
    before = smm_packed.launches["natural_f32"]
    if smm_packed.natural_blocks(mnk, mnk, mnk):
        _same(smm_packed.natural_f32(a, b), smm_packed.natural_f32_plain(a, b))
        assert smm_packed.launches["natural_f32"] == before + 1
    else:
        with pytest.raises(ValueError, match="nothing was launched"):
            smm_packed.natural_f32(a, b)
        assert smm_packed.launches["natural_f32"] == before


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


# (M, K, density, N, B plane offset in elements) of the route cases, each
# walking many tiles a persistent block or fewer than one: N % 4 != 0
# (cp.async, the acc kernels' C_in staged with B, rows stored through the
# warps' row buffers); B planes 4 bytes off 16 (cp.async); K 300
# (TMA, two boxes a plane, the narrow tile) and 600 (cp.async, narrow;
# split2's two planes unstaged); a structure above the shared-memory
# budget (global, the last round cut into row slices); N below one tile
# (TMA, every column of the tile past N but 100, cut into slices); the acc
# kernels' C_in staged with B (TMA, 105x75 at N % 4 == 0)
ROUTE_CASES = [(105, 75, 0.11, 65536 + 37, 0), (150, 150, 0.05, 65536, 1),
               (40, 300, 0.05, 4100, 0), (33, 600, 0.03, 2051, 0),
               (200, 200, 0.2, 20000, 0), (150, 150, 0.05, 100, 0),
               (105, 75, 0.11, 65536 + 260, 0)]
KERNELS = ["float32"] + sorted(SCHEDULES)


def _route_operands(dev, m, k, density, n, off, seed):
    """_sparse's operands, the B planes moved ``off`` elements into their
    storage (off 1: 4 bytes past a 16-byte boundary)."""
    op, bh, bl, ch, cl = _sparse(dev, m, k, density, n, seed)
    if off:
        def shift(t):
            v = torch.empty(t.numel() + off, device=dev)[off:].view(t.shape)
            return v.copy_(t)
        bh, bl = shift(bh), shift(bl)
    return op, bh, bl, ch, cl


def _both(op, kernel, bh, bl, ch, cl, route=None):
    """(kernel outputs, plain outputs) of the unroll and acc kernels under
    ``kernel`` (f32 or an f64 schedule), as tuples of planes."""
    kw = {} if route is None else {"route": route}
    if kernel == "float32":
        got = (sk.unroll_f32(op, bh, **kw), sk.acc_f32(op, ch, bh, **kw))
        want = (sk.unroll_f32_plain(op, bh), sk.acc_f32_plain(op, ch, bh))
        return got, want
    b_lo, c_lo = SCHEDULES[kernel]
    bl, clin = (bl if b_lo else None), (cl if c_lo else None)
    got = (sk.unroll_f64(op, bh, bl, c_lo=c_lo, **kw),
           sk.acc_f64(op, ch, clin, bh, bl, **kw))
    want = (sk.unroll_f64_plain(op, bh, bl, c_lo=c_lo),
            sk.acc_f64_plain(op, ch, clin, bh, bl))
    flat = lambda xs: tuple(y for x in xs
                            for y in (x if isinstance(x, tuple) else (x,)))
    return flat(got), flat(want)


def _planes_of(kernel, bh, bl):
    return [bh, bl] if kernel != "float32" and SCHEDULES[kernel][0] else [bh]


def _cin_planes(kernel):
    """The C_in planes of the acc kernel under ``kernel``."""
    return 2 if kernel != "float32" and SCHEDULES[kernel][1] else 1


@pytest.mark.parametrize("m,k,density,n,off", ROUTE_CASES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_spgemm_routes_match_plain(cuda, m, k, density, n, off, kernel):
    """The unroll and acc kernels on the route pick_route names, bit for bit
    against their plain versions, each launch counted on that route."""
    op, bh, bl, ch, cl = _route_operands(cuda, m, k, density, n, off, 11)
    f64, planes = kernel != "float32", _planes_of(kernel, bh, bl)
    routes = (sk.pick_route(op, f64, planes),
              sk.pick_route(op, f64, planes, _cin_planes(kernel)))
    before = dict(sk.route_launches)
    got, want = _both(op, kernel, bh, bl, ch, cl)
    torch.cuda.synchronize()
    for part in sk.STAGINGS + sk.STRUCTURES:
        assert sk.route_launches[part] == before[part] + sum(
            part in rt for rt in routes)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("staging", ["tma", "cp_async", "unstaged"])
@pytest.mark.parametrize("structure", ["shared", "global"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_spgemm_forced_routes_match_plain(cuda, staging, structure, kernel):
    """Every route forced on the 150x150 PyFR-shaped operator at a ragged
    last tile, bit for bit against the plain versions, counted."""
    op, bh, bl, ch, cl = _route_operands(cuda, 150, 150, 0.05, 8196, 0, 12)
    route = (staging, structure)
    for c_planes in (0, _cin_planes(kernel)):
        assert sk.fits(op, kernel != "float32",
                       len(_planes_of(kernel, bh, bl)), c_planes, route)
    before = dict(sk.route_launches)
    got, want = _both(op, kernel, bh, bl, ch, cl, route)
    torch.cuda.synchronize()
    assert sk.route_launches[staging] == before[staging] + 2
    assert sk.route_launches[structure] == before[structure] + 2
    for g, w in zip(got, want):
        _same(g, w)


def test_spgemm_route_refused(cuda):
    """A route the kernel cannot run raises ValueError with nothing
    launched: TMA on N % 4 != 0 and on planes off 16 bytes, a staged route
    whose two narrow stages do not fit, a structure beyond shared memory."""
    op, bh, bl, ch, cl = _sparse(cuda, 150, 150, 0.05, 4099, 13)
    off = _route_operands(cuda, 150, 150, 0.05, 4096, 1, 13)
    deep = _sparse(cuda, 20, 2000, 0.01, 512, 14)
    big = _sparse(cuda, 400, 400, 0.2, 64, 15)  # 32000 terms, 512 KB in f64
    before = (dict(sk.launches), dict(sk.route_launches))
    with pytest.raises(ValueError, match="route"):
        sk.unroll_f32(op, bh, route=("tma", "shared"))
    with pytest.raises(ValueError, match="route"):
        sk.acc_f64(off[0], off[3], off[4], off[1], off[2],
                   route=("tma", "global"))
    with pytest.raises(ValueError, match="route"):
        sk.unroll_f64(deep[0], deep[1], deep[2], c_lo=True,
                      route=("cp_async", "global"))
    with pytest.raises(ValueError, match="route"):
        sk.unroll_f64(big[0], big[1], c_lo=False, route=("unstaged", "shared"))
    with pytest.raises(ValueError, match="route"):
        sk.unroll_f32(op, bh, route=("tma", "somewhere"))
    torch.cuda.synchronize()
    assert (dict(sk.launches), dict(sk.route_launches)) == before


@pytest.mark.parametrize("m,k,density,n,off", ROUTE_CASES[:5])
@pytest.mark.parametrize("kernel", KERNELS)
def test_spgemm_fits_matches_launch(cuda, m, k, density, n, off, kernel):
    """sk.fits is the launch's own check: the cp.async ring, forced (at N %
    4 != 0 and on planes 4 bytes off 16 too), runs bit for bit where fits
    says it fits and raises ValueError with nothing launched where it does
    not."""
    op, bh, bl, ch, cl = _route_operands(cuda, m, k, density, n, off, 21)
    f64, planes = kernel != "float32", _planes_of(kernel, bh, bl)
    for structure in sk.STRUCTURES:
        route = ("cp_async", structure)
        ok = [sk.fits(op, f64, len(planes), c, route)
              for c in (0, _cin_planes(kernel))]
        before = dict(sk.route_launches)
        if all(ok):
            got, want = _both(op, kernel, bh, bl, ch, cl, route)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                _same(g, w)
            assert sk.route_launches["cp_async"] == before["cp_async"] + 2
            continue
        kw = {"route": route}
        calls = ([lambda: sk.unroll_f32(op, bh, **kw),
                  lambda: sk.acc_f32(op, ch, bh, **kw)]
                 if kernel == "float32" else
                 [lambda: sk.unroll_f64(op, *planes, c_lo=True, **kw),
                  lambda: sk.acc_f64(op, ch, cl if _cin_planes(kernel) == 2
                                     else None, *planes, **kw)])
        for fits_, fn in zip(ok, calls):
            if fits_:
                fn()
            else:
                with pytest.raises(ValueError, match="route"):
                    fn()
        torch.cuda.synchronize()
        assert sk.route_launches["cp_async"] == before["cp_async"] + sum(ok)


def test_spgemm_streams_bit_identical(cuda):
    """Launches on two streams at once, each stream with its own item
    counters, give the bits of launches on one stream: no item is lost or
    taken twice."""
    op, bh, bl, ch, cl = _sparse(cuda, 150, 150, 0.05, 65536, 22)
    odd = _sparse(cuda, 105, 75, 0.11, 65536 + 37, 23)
    want = (sk.unroll_f32(op, bh).clone(),
            sk.acc_f64(odd[0], odd[3], odd[4], odd[1], odd[2])[1].clone())
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=cuda) for _ in range(2)]
    got = []
    for _ in range(20):
        for s_ in streams:
            with torch.cuda.stream(s_):
                got.append((sk.unroll_f32(op, bh),
                            sk.acc_f64(odd[0], odd[3], odd[4], odd[1],
                                       odd[2])[1]))
    torch.cuda.synchronize()
    for a, b in got:
        assert torch.equal(a, want[0]) and torch.equal(b, want[1])


def test_spgemm_ring_repeats_bit_identical(cuda):
    """The persistent kernels give the same bits on every one of 50
    launches, on the TMA ring (wide and narrow tiles, C_in staged with B)
    and the cp.async ring: the full/empty mbarriers leave no race."""
    op, bh, bl, ch, cl = _sparse(cuda, 150, 150, 0.05, 65536, 16)
    deep = _sparse(cuda, 40, 300, 0.05, 4100, 17)
    odd = _sparse(cuda, 105, 75, 0.11, 65536 + 37, 18)
    small = _sparse(cuda, 105, 75, 0.11, 65536, 19)  # acc: C_in staged
    cases = [lambda: sk.unroll_f32(op, bh),
             lambda: torch.cat(sk.acc_f64(op, ch, cl, bh, bl)),
             lambda: sk.unroll_f64(deep[0], deep[1], deep[2], c_lo=False),
             lambda: torch.cat(sk.unroll_f64(odd[0], odd[1], odd[2],
                                             c_lo=True)),
             lambda: torch.cat(sk.acc_f64(small[0], small[3], small[4],
                                          small[1], small[2])),
             lambda: sk.acc_f32(small[0], small[3], small[1])]
    for fn in cases:
        ref = fn().clone()
        for _ in range(50):
            assert torch.equal(fn(), ref)


# ---------------------------------------------------------------------------
# The tiled-GEMM kernel (ops/csrc/tiled_gemm.cu) and the copy and transpose
# kernels (ops/csrc/xcopy.cu)
# ---------------------------------------------------------------------------

from xsmm_tpu_torch.ops import tiled_gemm_kernels as tk  # noqa: E402
from xsmm_tpu_torch.ops import cuda_build  # noqa: E402
from xsmm_tpu_torch.ops import xcopy_kernels as xk  # noqa: E402

# ragged M, N and K (1, 15, 17, 127, 129, 4095), K = 1, aligned and
# misaligned row lengths; (129, 127, 4095), (129, 200, 1000) and
# (1760, 128, 1760) have too few tiles of C for the SMs and split K
# ((129, 200, 1000) with a short final split)
GEMM_SHAPES = [(1, 1, 1), (15, 17, 1), (17, 15, 129), (127, 129, 15),
               (129, 127, 4095), (4095, 17, 127), (256, 4095, 64),
               (300, 200, 100), (129, 200, 1000), (1760, 128, 1760)]
GEMM_TYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float16, torch.float32), (torch.float16, torch.float16)]


def _rel(got, want):
    d = torch.linalg.vector_norm(got.double() - want.double())
    return (d / max(torch.linalg.vector_norm(want.double()).item(),
                    1e-300)).item()


def _gemm_tol(out_dt):
    # the kernel and the plain version sum in f32 in other orders; a 16-bit
    # output holds ~3 digits
    return 1e-5 if out_dt == torch.float32 else 1e-2


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("in_dt,out_dt", GEMM_TYPES)
def test_tiled_gemm_matches_plain(cuda, m, n, k, in_dt, out_dt):
    a, b = _planes(cuda, 11, (m, k), (k, n), dtype=in_dt)
    before = tk.launches["tiled_gemm"]
    got = tk.gemm(a, b, out_dtype=out_dt)
    torch.cuda.synchronize()
    assert tk.launches["tiled_gemm"] == before + 1
    assert got.shape == (m, n) and got.dtype == out_dt
    want = tk.gemm_plain(a, b, out_dtype=out_dt, bk=512)
    assert _rel(got, want) <= _gemm_tol(out_dt)
    gold = a.double() @ b.double()
    assert _rel(got, gold) <= (1e-5 if out_dt == torch.float32 else 1e-2)


@pytest.mark.parametrize("in_dt,out_dt", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
def test_tiled_gemm_c0_card_equals_plain(cuda, in_dt, out_dt):
    """c0 is added after the cast, in the output dtype, on the card as on
    the CPU."""
    a, b = _planes(cuda, 12, (200, 70), (70, 150))
    c0 = _planes(cuda, 13, (200, 150), dtype=out_dt)[0]
    h = xp.TiledGemm(200, 150, 70, in_dtype=in_dt, out_dtype=out_dt)
    got = h(a, b, c0)
    want = tk.gemm_plain(a.to(in_dt), b.to(in_dt), out_dtype=out_dt,
                         bk=h.bk) + c0
    torch.cuda.synchronize()
    assert got.dtype == out_dt
    assert _rel(got, want) <= _gemm_tol(out_dt)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("offset,count", [(0, 1), (1, 7), (3, 4099),
                                          (5, 65536 + 3), (8, 1000), (13, 1)])
def test_copy_misaligned(cuda, dtype, offset, count):
    """Sliced sources start at any element; odd byte counts leave a tail."""
    base = torch.randint(0, 255, (count + 64,), device=cuda,
                         dtype=torch.uint8).to(dtype)
    x = base[offset:offset + count]
    before = xk.launches["xcopy_copy"]
    got = xk.copy(x)
    torch.cuda.synchronize()
    assert xk.launches["xcopy_copy"] == before + 1
    _same(got, xk.copy_plain(x))
    # a byte view at an odd start: head and tail bytes around the vectors
    raw = base.view(torch.uint8)[offset * 3 + 1:]
    _same(xk.copy(raw), raw.clone())


@pytest.mark.parametrize("count", [1, 15, 16, 17, (1 << 28) + 3])
def test_copy_every_byte_offset(cuda, count):
    """Kernel 9 on raw addresses: every source and destination byte offset
    0-15 (so also pairs that share no 16-byte alignment), bit for bit
    against ``clone`` of the same bytes, and no byte written outside the
    destination (2^28 + 3 bytes at three offset pairs)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    src = torch.randint(0, 256, (count + 16,), generator=g, device=cuda,
                        dtype=torch.uint8)
    dst = torch.empty(count + 32, dtype=torch.uint8, device=cuda)
    pairs = ([(a, b) for a in range(16) for b in range(16)]
             if count < 1 << 20 else [(0, 0), (3, 3), (5, 12)])
    lib = xk._lib()
    for a, b in pairs:
        dst.fill_(0xA5)
        before = xk.launches["xcopy_copy"]
        cuda_build.launch(lib.xsmm_copy, cuda, src.data_ptr() + a,
                          dst.data_ptr() + b, count)
        want = torch.full_like(dst, 0xA5)
        want[b:b + count] = src[a:a + count].clone()
        torch.cuda.synchronize()
        assert torch.equal(dst, want), (a, b)
        assert xk.launches["xcopy_copy"] == before   # counted by copy() only
    del src, dst, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("m,n", [(512, 512), (520, 516), (513, 1031),
                                 (4099, 512), (600, 3)])
def test_trans_matches_plain(cuda, dtype, m, n):
    x = torch.randint(0, 255, (m, n), device=cuda,
                      dtype=torch.uint8).to(dtype)
    before = xk.launches["xcopy_trans"]
    got = xk.trans(x)
    torch.cuda.synchronize()
    assert xk.launches["xcopy_trans"] == before + 1
    _same(got, xk.trans_plain(x))


def test_dense_entry_points_card_equal_cpu(cuda):
    """xgemm, matcopy and otrans on the card against the same calls with
    target="cpu": copies bit for bit, GEMMs to f32 rounding."""
    rng = np.random.default_rng(14)
    a = rng.standard_normal((300, 100)).astype(np.float32)
    b = rng.standard_normal((100, 200)).astype(np.float32)
    c0 = rng.standard_normal((300, 200)).astype(np.float32)
    x = rng.standard_normal((1024, 640)).astype(np.float32)
    out = {}
    for target in ("cuda", "cpu"):
        xp.set_config(target=target)
        before = dict(tk.launches, **xk.launches)
        out[target] = [xp.xgemm(a, b).cpu(), xp.xgemm(a, b, c0).cpu(),
                       xp.gemm_handle(300, 200, 100, in_dtype="bfloat16",
                                      out_dtype="float32")(a, b).cpu(),
                       xp.matcopy(x).cpu(), xp.otrans(x).cpu(),
                       xp.itrans(x[:512, :520]).cpu()]
        launched = {k: v - before[k] for k, v in dict(tk.launches,
                                                      **xk.launches).items()}
        if target == "cuda":
            assert launched == {"tiled_gemm": 3, "xcopy_copy": 1,
                                "xcopy_trans": 2}
    for got, want in zip(out["cuda"][:3], out["cpu"][:3]):
        assert _rel(got, want) <= 1e-5
    for got, want in zip(out["cuda"][3:], out["cpu"][3:]):
        assert torch.equal(got, want)


# kernel 4's routes: the GEMM shapes above, the DeepBench shapes of
# samples/xgemm_driver.py:16-17 (split K), and TMA-aligned ragged shapes
# (M, N and K not multiples of the 128 x 256 x 64 tile)
ROUTE_SHAPES = GEMM_SHAPES + [(2048, 64, 2048), (2560, 64, 2560),
                              (4096, 128, 4096), (136, 264, 1000),
                              (1, 8, 8), (129, 520, 72)]


def _tma_ok(a, b):
    k, n = a.shape[1], b.shape[1]
    return (k > 0 and k % 8 == 0 and n % 8 == 0
            and (a.data_ptr() | b.data_ptr()) % 16 == 0)


@pytest.mark.parametrize("m,n,k", ROUTE_SHAPES)
@pytest.mark.parametrize("route", ["tma", "mma"])
@pytest.mark.parametrize("in_dt,out_dt", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16)])
def test_tiled_gemm_routes_match_plain(cuda, m, n, k, route, in_dt, out_dt):
    """Each 16-bit route forced through the route argument: against the
    plain version and f64 gold where it runs; the TMA route refuses
    operands it cannot address, launching nothing."""
    a, b = _planes(cuda, 16, (m, k), (k, n), dtype=in_dt)
    before = (tk.launches["tiled_gemm"], tk.route_launches[route])
    if route == "tma" and not _tma_ok(a, b):
        with pytest.raises(ValueError, match="16 bytes"):
            tk.gemm(a, b, out_dtype=out_dt, route=route)
        assert (tk.launches["tiled_gemm"], tk.route_launches[route]) == before
        return
    got = tk.gemm(a, b, out_dtype=out_dt, route=route)
    torch.cuda.synchronize()
    assert (tk.launches["tiled_gemm"], tk.route_launches[route]) == (
        before[0] + 1, before[1] + 1)
    want = tk.gemm_plain(a, b, out_dtype=out_dt, bk=512)
    assert _rel(got, want) <= _gemm_tol(out_dt)
    assert _rel(got, a.double() @ b.double()) <= _gemm_tol(out_dt)


@pytest.mark.parametrize("case", ["aligned", "unaligned-K", "unaligned-N",
                                  "offset-view"])
def test_tiled_gemm_alignment_classes(cuda, case):
    """The route the wrapper picks for each alignment class, counted, and
    its result against the plain version."""
    m, n, k = 300, 264, 136
    if case == "unaligned-K":
        k = 135
    if case == "unaligned-N":
        n = 261
    a, b = _planes(cuda, 17, (m, k), (k, n), dtype=torch.bfloat16)
    if case == "offset-view":
        a = torch.cat([a.reshape(-1)[:1], a.reshape(-1)])[1:].view(m, k)
    want = "tma" if case == "aligned" else "mma"
    assert tk.pick_route(a, b) == want
    before = dict(tk.route_launches)
    got = tk.gemm(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tk.route_launches[want] == before[want] + 1
    assert _rel(got, tk.gemm_plain(a, b, out_dtype=torch.float32,
                                   bk=512)) <= 1e-5


def test_dense_cuda_tensor_never_takes_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")
    for mod, name in ((tk, "gemm_plain"), (xk, "copy_plain"),
                      (xk, "trans_plain")):
        monkeypatch.setattr(mod, name, boom)
    a, b = _planes(cuda, 15, (64, 64), (64, 64))
    tk.gemm(a, b, out_dtype=torch.float32)
    xk.copy(a)
    xk.trans(a)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The four packed-LA kernels (ops/csrc/packed.cu)
# ---------------------------------------------------------------------------

from xsmm_tpu_torch.ops import packed_kernels as pk  # noqa: E402

PACKED_BP = 1000  # not a multiple of 16 or 32: the ragged tail is masked
# (M, N): every register bucket (8, 16, 32, 64), rectangular both ways, and
# sizes above 64 (one block per problem, shared memory)
GETRF_SHAPES = [(1, 1), (5, 5), (12, 8), (8, 12), (16, 16), (23, 17),
                (32, 32), (40, 64), (64, 64), (70, 20), (80, 80), (125, 125),
                (100, 70), (70, 100), (128, 128)]
# (SM, SN): every register bucket; SN above the 16 columns of a block and
# above the shared trsm's 128-column chunk
TRSM_SHAPES = [(1, 1), (5, 3), (8, 8), (16, 16), (16, 40), (23, 7), (32, 32),
               (64, 64), (64, 130), (80, 80), (125, 125), (100, 300)]


def _lower(dev, seed, m, n=None, bp=PACKED_BP):
    """[M, N, Bp] with entries of size 1/M off the diagonal and 1 + ... on
    it: factorizable without pivoting and well conditioned, unit diagonal
    or not."""
    n = n or m
    a = _planes(dev, seed, (m, n, bp))[0] / m
    idx = torch.arange(min(m, n), device=dev)
    a[idx, idx] += 1.0
    return a


# the shapes at PACKED_BP, and the packed LU cell's 125 x 125 at a batch that
# ends inside a cluster of the tile route
GETRF_BATCHES = [(m, n, PACKED_BP) for m, n in GETRF_SHAPES] + [(125, 125, 4097)]


@pytest.mark.parametrize("m,n,bp", GETRF_BATCHES)
@pytest.mark.parametrize("kernel", ["getrf_unrolled", "getrf_loop"])
def test_getrf_matches_plain(cuda, kernel, m, n, bp):
    a = _lower(cuda, 20, m, n, bp)
    before = pk.launches[kernel]
    got = getattr(pk, kernel)(a)
    torch.cuda.synchronize()
    assert pk.launches[kernel] == before + 1
    _same(got, getattr(pk, kernel + "_plain")(a))


@pytest.mark.parametrize("sm,sn", TRSM_SHAPES)
@pytest.mark.parametrize("kernel", ["trsm_unrolled", "trsm_loop"])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_matches_plain(cuda, kernel, sm, sn, unit):
    a = _lower(cuda, 21, sm)
    b = _planes(cuda, 22, (sm, sn, PACKED_BP))[0]
    before = pk.launches[kernel]
    got = getattr(pk, kernel)(a, b, unit)
    torch.cuda.synchronize()
    assert pk.launches[kernel] == before + 1
    _same(got, getattr(pk, kernel + "_plain")(a, b, unit))


@pytest.mark.parametrize("m,n,bp", [
    (m, n, bp) for m, n, bp in GETRF_BATCHES if max(m, n) > 64]
    + [(m, n, PACKED_BP) for m, n in ((65, 65), (128, 65), (65, 128),
                                      (66, 66), (96, 96), (112, 112),
                                      (140, 140), (129, 100))])
@pytest.mark.parametrize("route", ["tile", "shared"])
def test_getrf_loop_routes_match_plain(cuda, m, n, bp, route):
    """Kernel 12 on each route that takes the size, bit for bit against the
    unchanged plain version, counted in its route; the tile route refuses
    sizes outside 65 <= min(M, N), max(M, N) <= 128 with nothing
    launched.  The tile route's panel edges: a last panel of one column
    (66 x 66, 128 x 65), sizes no multiple of the panel."""
    a = _lower(cuda, 53, m, n, bp)
    before, rbefore = dict(pk.launches), dict(pk.getrf_route_launches)
    if route == "tile" and pk.getrf_route(m, n) != "tile":
        with pytest.raises(ValueError, match="tile route takes"):
            pk._getrf_loop(a, "tile")
        assert pk.launches == before and pk.getrf_route_launches == rbefore
        return
    got = pk._getrf_loop(a, route)
    torch.cuda.synchronize()
    assert pk.launches["getrf_loop"] == before["getrf_loop"] + 1
    assert pk.getrf_route_launches[route] == rbefore[route] + 1
    assert torch.isfinite(got).all()
    _same(got, pk.getrf_loop_plain(a))


def test_packed_launch_raises(cuda):
    a = _lower(cuda, 23, 16)
    b = _planes(cuda, 24, (16, 4, 64))[0]
    with pytest.raises(ValueError, match="dtype"):
        pk.getrf_unrolled(a.double())
    with pytest.raises(ValueError, match="contiguous"):
        pk.getrf_loop(a.transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        pk.trsm_unrolled(a, b[:, :, ::2], False)
    with pytest.raises(ValueError, match="dtype"):
        pk.trsm_loop(a, b.double(), False)
    before = dict(pk.launches)
    with pytest.raises(ValueError, match="shared memory"):
        pk.getrf_loop(torch.zeros((250, 250, 2), device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        pk.getrf_unrolled(torch.zeros((250, 250, 2), device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        pk.trsm_loop(torch.zeros((340, 340, 2), device=cuda),
                     torch.zeros((340, 8, 2), device=cuda), False)
    assert pk.launches == before  # a refused size counts no launch


# kernel 14 (trsm_loop) and kernel 13 above 64 (trsm_unrolled) share the
# shared-memory template: 125 (the p = 4 hexahedron block), several 128-column
# chunks, ragged SN, 129 and 200 rows (16 warps), one row
SHARED_TRSM_SHAPES = [(125, 125), (125, 300), (125, 7), (125, 130),
                      (129, 64), (200, 5), (65, 1)]


@pytest.mark.parametrize("sm,sn", SHARED_TRSM_SHAPES)
@pytest.mark.parametrize("kernel", ["trsm_loop", "trsm_unrolled"])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_shared_template_matches_plain(cuda, sm, sn, kernel, unit):
    """The chunk route (the shared template), forced: bit for bit against
    the unchanged plain versions; the unit-diagonal solves take A scaled by
    1/sm (random unit-lower matrices grow X exponentially in sm)."""
    a = _lower(cuda, 47, sm, bp=300)
    a = a / sm if unit else a
    b = _planes(cuda, 48, (sm, sn, 300))[0]
    before = pk.launches[kernel]
    chunk = pk.trsm_route_launches["chunk"]
    got = pk._trsm(kernel, a, b, unit, False, "chunk")
    torch.cuda.synchronize()
    assert pk.launches[kernel] == before + 1
    assert pk.trsm_route_launches["chunk"] == chunk + 1
    assert torch.isfinite(got).all()
    _same(got, getattr(pk, kernel + "_plain")(a, b, unit))


# the narrow route's streamed solve: every SN up to the rule's edge at 125
# (50) at each SM, and each SM's own edge where it lies further; ragged Bp
# (a partial warp, one warp and a lane, a block past 4096)
NARROW_SM = [65, 100, 125, 128]
NARROW_CASES = [(sm, sn) for sm in NARROW_SM for sn in range(1, 51)] + [
    (65, 186), (100, 78)]
NARROW_BP = [1, 31, 33, 4097]


@pytest.mark.parametrize("sm,sn", NARROW_CASES)
def test_trsm_narrow_route_matches_plain(cuda, sm, sn):
    """Kernels 13 and 14 on the narrow route, lower and upper, unit
    diagonal and not, at each ragged Bp, bit for bit against the plain
    versions, each launch counted on its route; the triangle the solve does
    not read (and, with a unit diagonal, the diagonal) holds NaN."""
    nan = torch.full((sm, sm), float("nan"), device=cuda)
    for bp in NARROW_BP:
        a = _lower(cuda, 71, sm, bp=bp)
        b = _planes(cuda, 72, (sm, sn, bp))[0]
        for kernel, upper, unit in itertools.product(
                ("trsm_unrolled", "trsm_loop"), (False, True), (False, True)):
            aa = a / sm if unit else a
            other = torch.tril(nan, -1) if upper else torch.triu(nan, 1)
            if unit:
                other = other + torch.diag(torch.diagonal(nan))
            name = kernel + "_upper" * upper
            before = pk.launches[name]
            narrow = pk.trsm_route_launches["narrow"]
            got = pk._trsm(kernel, aa + other[..., None], b, unit, upper,
                           "narrow")
            torch.cuda.synchronize()
            assert pk.launches[name] == before + 1
            assert pk.trsm_route_launches["narrow"] == narrow + 1
            case = (bp, name, unit)
            assert torch.isfinite(got).all(), case
            want = getattr(pk, name + "_plain")(aa, b, unit)
            assert torch.equal(got, want), (case, (
                got - want).abs().max().item())


@pytest.mark.parametrize("sm,sn,bp", [(125, 1, 4096), (125, 7, 300),
                                      (70, 2, 1000), (16, 3, 100)])
def test_trsm_routes_agree(cuda, sm, sn, bp):
    """Both routes forced on the same operands give equal bits, for both
    kernels and both triangles."""
    a = _lower(cuda, 73, sm, bp=bp)
    b = _planes(cuda, 74, (sm, sn, bp))[0]
    for kernel in ("trsm_unrolled", "trsm_loop"):
        for upper in (False, True):
            got = [pk._trsm(kernel, a, b, False, upper, rt)
                   for rt in ("narrow", "chunk")]
            torch.cuda.synchronize()
            assert torch.equal(*got), (kernel, upper)


def test_trsm_narrow_refused_launches_nothing(cuda):
    """The narrow route refuses SM above 256 (-2 in packed.cu) before any
    launch: ValueError, nothing counted."""
    a = _lower(cuda, 75, 257, bp=2)
    b = _planes(cuda, 76, (257, 1, 2))[0]
    before, routes = dict(pk.launches), dict(pk.trsm_route_launches)
    with pytest.raises(ValueError, match="narrow route takes SM <= 256"):
        pk._trsm("trsm_loop", a, b, True, False, "narrow")
    torch.cuda.synchronize()
    assert pk.launches == before and pk.trsm_route_launches == routes


@pytest.mark.parametrize("sm,sn", TRSM_SHAPES + SHARED_TRSM_SHAPES
                         + [(125, 1)])
@pytest.mark.parametrize("kernel", ["trsm_unrolled", "trsm_loop"])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_upper_variant_matches_plain(cuda, kernel, sm, sn, unit):
    """The upper variant (triu(A) read in place, row i at SM-1-i) bit for
    bit against its plain version, counted under its own name; the strict
    lower triangle holds NaN, which it must not read."""
    a = _lower(cuda, 61, sm, bp=300)
    a = a / sm if unit else a
    a = a + torch.tril(torch.full((sm, sm), float("nan"), device=cuda),
                       -1)[..., None]
    b = _planes(cuda, 62, (sm, sn, 300))[0]
    before = dict(pk.launches)
    got = getattr(pk, kernel)(a, b, unit, upper=True)
    torch.cuda.synchronize()
    assert pk.launches[kernel + "_upper"] == before[kernel + "_upper"] + 1
    assert pk.launches[kernel] == before[kernel]
    assert torch.isfinite(got).all()
    _same(got, getattr(pk, kernel + "_upper_plain")(a, b, unit))


@pytest.mark.parametrize("sm", [16, 125])   # kernel 13, then kernel 14
@pytest.mark.parametrize("side,uplo,transa", [
    (s, u, t) for s in "LR" for u in "LU" for t in "NT"])
def test_call_launches_the_upper_variant_with_the_flip_routes_bits(
        cuda, sm, side, uplo, transa):
    """``__call__`` reduces a descriptor to a left solve by transposes and
    launches the upper variant where that solve is upper, once and nothing
    else: the bits of the lower kernel on flipped copies of A and B."""
    from xsmm_tpu_torch.ops.pack_util import pack_lanes

    other, bsz = 5, 300
    m, n = (sm, other) if side == "L" else (other, sm)
    a = _lower(cuda, 65, sm, bp=bsz)
    a = (a + a.transpose(0, 1)).permute(2, 0, 1)   # both triangles
    b = _planes(cuda, 66, (bsz, m, n))[0]
    kern = xp.trsm_dispatch(m, n, side=side, uplo=uplo, transa=transa,
                            batch=bsz)
    name = kern.kernel_name
    transposed = (side == "R") != (transa == "T")
    upper = (uplo == "U") != transposed
    pk.reset_launches()
    got = kern(a, b)
    torch.cuda.synchronize()
    assert {k: v for k, v in pk.launches.items() if v} == {
        name + "_upper" if upper else name: 1}
    a_eff = a.transpose(-1, -2) if transposed else a
    b_eff = b.transpose(-1, -2) if side == "R" else b
    if upper:
        a_eff, b_eff = a_eff.flip((-1, -2)), b_eff.flip(-2)
    x = getattr(pk, name)(pack_lanes(a_eff), pack_lanes(b_eff),
                          False).permute(2, 0, 1)
    if upper:
        x = x.flip(-2)
    _same(got, x.transpose(-1, -2) if side == "R" else x)


def _device_op(ev) -> bool:
    """A kernel, copy or set on the card's timeline (no annotation)."""
    if not str(ev.device_type()).endswith("CUDA"):
        return False
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind()).lower() in ("kernel", "gpu_memcpy", "gpu_memset")
    return not ev.is_user_annotation()


def test_block_jacobi_apply_on_the_card(cuda):
    """The packed LU, then the unit-lower and the upper solve on that same
    LU through ``packed``, at the p = 4 block (125) with one right-hand
    side: each launches its one kernel and nothing else runs on the card
    between them (no copy of the factors); bit for bit the plain versions;
    against the f64 reference within 2e-5 a solve (f32 rounding over ~125
    terms of well-conditioned, diagonally dominant blocks; the CPU tests'
    readings are 1e-7 to 3.2e-7, bf16 factors read 2e-3)."""
    from torch.profiler import ProfilerActivity, profile

    from reference_torch import block_jacobi as ref

    n, bsz = 125, 2000
    a = _planes(cuda, 63, (n, n, bsz))[0] / n ** 0.5
    idx = torch.arange(n, device=cuda)
    a[idx, idx] = 0.0
    a[idx, idx] = a.abs().sum(1) * 1.5
    r = _planes(cuda, 64, (n, 1, bsz))[0]
    getrf = xp.getrf_dispatch(n, n, batch=bsz)
    lower = xp.trsm_dispatch(n, 1, uplo="L", diag="U", batch=bsz)
    upper = xp.trsm_dispatch(n, 1, uplo="U", diag="N", batch=bsz)
    lu = getrf.packed(a)
    torch.cuda.synchronize()
    pk.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = lower.packed(lu, r)
        x = upper.packed(lu, y)
        torch.cuda.synchronize()
    assert {k: v for k, v in pk.launches.items() if v} == {
        "trsm_loop": 1, "trsm_loop_upper": 1}
    route = pk.trsm_route(n, 1, bsz)
    assert pk.trsm_route_launches[route] == 2
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if _device_op(e)]
    assert len(ops) == 2, ops
    kern = {"narrow": "trsm_reg", "chunk": "trsm_shared"}[route]
    assert kern + "<" in ops[0] and kern + "_upper<" in ops[1], ops
    _same(lu, pk.getrf_loop_plain(a))
    _same(y, pk.trsm_loop_plain(lu, r, True))
    _same(x, pk.trsm_loop_upper_plain(lu, y, False))
    want = ref.block_jacobi(a.permute(2, 0, 1), r.permute(2, 0, 1))
    err = torch.linalg.vector_norm(x.permute(2, 0, 1).double() - want,
                                   dim=(1, 2))
    assert float((err / torch.linalg.vector_norm(want, dim=(1, 2))).max()) \
        <= 2e-5


def test_redesigned_kernels_repeat_bit_identical(cuda):
    """Kernel 4 on the TMA route (one block's tiles, and split K) and kernel
    14 give the same bits on every one of 50 launches: the mbarrier ring and
    the trsm's one barrier a step leave no race."""
    a, b = _planes(cuda, 49, (1000, 1024), (1024, 776), dtype=torch.bfloat16)
    da, db = _planes(cuda, 50, (1760, 1760), (1760, 128), dtype=torch.bfloat16)
    ta = _lower(cuda, 51, 125, bp=264)
    tb = _planes(cuda, 52, (125, 125, 264))[0]
    cases = [lambda: tk.gemm(a, b, out_dtype=torch.float32, route="tma"),
             lambda: tk.gemm(da, db, out_dtype=torch.bfloat16, route="tma"),
             lambda: pk.trsm_loop(ta, tb, False)]
    for fn in cases:
        ref = fn().clone()
        for _ in range(50):
            assert torch.equal(fn(), ref)


def test_tile_kernels_repeat_bit_identical(cuda):
    """Kernel 12 on its tile route (one barrier a step, a column ahead in
    shared memory, clusters) and the batched SMM's tile kernel (a ring of
    cp.async stages, Bp 4099, or of TMA stages, Bp 4096, across items) give
    the same bits on every one of 50 launches."""
    a = _lower(cuda, 54, 125, bp=264)
    ah, al, bh, bl = _planes(cuda, 55, (23, 23, 4099), (23, 23, 4099),
                             (23, 23, 4099), (23, 23, 4099))
    th, tl, uh, ul = _planes(cuda, 56, (23, 23, 4096), (23, 23, 4096),
                             (23, 23, 4096), (23, 23, 4096))
    assert smm_packed.staging(ah, al, bh, bl) == "cp.async"
    assert smm_packed.staging(th, tl, uh, ul) == "tma"
    cases = [lambda: pk.getrf_loop(a),
             lambda: torch.cat(smm_packed.packed_split2(ah, al, bh, bl)),
             lambda: smm_packed.packed_split2_fast(ah, bh, bl),
             lambda: smm_packed.packed_f32(ah, bh, out_dtype=torch.float32),
             lambda: torch.cat(smm_packed.packed_split2(th, tl, uh, ul)),
             lambda: smm_packed.packed_split2_fast(th, uh, ul),
             lambda: smm_packed.packed_f32(th, uh, out_dtype=torch.float32)]
    for fn in cases:
        ref = fn().clone()
        for _ in range(50):
            assert torch.equal(fn(), ref)


@pytest.mark.parametrize("knob", [64, 4])
def test_packed_entry_points_card_equal_cpu(cuda, knob):
    """getrf_dispatch, trsm_dispatch (six variants), trmm_dispatch and
    pgemm_dispatch in f32 give the same bits on the card as on the CPU, and
    reach the kernels the knob picks: the trsm's lower kernel for the two
    variants that reduce to a lower left solve, its upper variant for the
    other four."""
    rng = np.random.default_rng(25)
    m, n, bsz = 12, 9, 300
    a = rng.standard_normal((bsz, m, m)) / m + np.eye(m)
    a = a.astype(np.float32)
    b = rng.standard_normal((bsz, m, n)).astype(np.float32)
    bs = rng.standard_normal((bsz, m, m)).astype(np.float32)
    variants = [("L", "L", "N", "N"), ("L", "U", "N", "N"),
                ("L", "L", "T", "N"), ("L", "L", "N", "U"),
                ("R", "L", "N", "N"), ("R", "U", "T", "N")]
    out = {}
    for target in ("cuda", "cpu"):
        xp.get_registry().clear()
        xp.set_config(target=target, getrf_unroll=knob)
        before = dict(pk.launches)
        res = [xp.getrf_dispatch(m, m, batch=bsz)(a),
               xp.getrf_dispatch(m, n, batch=bsz)(a[:, :, :n])]
        for side, uplo, tr, dg in variants:
            rhs = b if side == "L" else bs
            res.append(xp.trsm_dispatch(m, rhs.shape[2], side=side, uplo=uplo,
                                        transa=tr, diag=dg, batch=bsz)(
                a, rhs, alpha=1.5))
        res.append(xp.trmm_dispatch(m, n, batch=bsz, transa="T")(a, b, 2.0))
        res.append(xp.pgemm_dispatch(m, n, m, batch=bsz)(a, b))
        out[target] = [r.cpu() for r in res]
        launched = {k: v - before[k] for k, v in pk.launches.items()}
        if target == "cuda":
            kind = "unrolled" if knob >= m else "loop"
            assert launched[f"getrf_{kind}"] == 2
            assert launched[f"trsm_{kind}"] == 2
            assert launched[f"trsm_{kind}_upper"] == 4
            assert sum(launched.values()) == 8
    xp.get_registry().clear()
    xp.set_config(getrf_unroll=64)
    for got, want in zip(out["cuda"], out["cpu"]):
        _same(got, want)


def test_packed_f64_refinement_on_card(cuda):
    rng = np.random.default_rng(26)
    m, n, bsz = 16, 12, 1000
    a = rng.standard_normal((bsz, m, m))
    a[:, np.arange(m), np.arange(m)] += m
    b = rng.standard_normal((bsz, m, n))
    kern = xp.trsm_dispatch(m, n, dtype="float64", batch=bsz)
    gates = {None: 1e-7, "host": 1e-8, False: 1e-3}
    for refine, gate in gates.items():
        x = kern(a, b, refine=refine)
        assert xp.matdiff(b, np.tril(a) @ x).normf_rel < gate, refine


def test_packed_cuda_tensor_never_takes_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")
    for name in ("getrf_unrolled_plain", "getrf_loop_plain",
                 "trsm_unrolled_plain", "trsm_loop_plain"):
        monkeypatch.setattr(pk, name, boom)
    a = _lower(cuda, 27, 16, bp=100)
    b = _planes(cuda, 28, (16, 5, 100))[0]
    pk.getrf_unrolled(a)
    pk.getrf_loop(a)
    pk.trsm_unrolled(a, b, False)
    pk.trsm_loop(a, b, True)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The three RNN forward kernels (ops/csrc/rnn_seq.cu)
# ---------------------------------------------------------------------------

from xsmm_tpu_torch.dnn import CellType, RnnDesc, create_rnncell  # noqa: E402
from xsmm_tpu_torch.dnn import rnn_seq as rs  # noqa: E402
from xsmm_tpu_torch.dnn import rnncell  # noqa: E402
from xsmm_tpu_torch.dnn.fault2_stress import (  # noqa: E402
    cpu_products, cpu_state, products_report, rnn_cell_gold,
    rnn_diagnosis)

# (T, N, K): lstm_driver's N and K; ragged N and K; T = 1; K below a block's
# 16 units; N = 4100 at K = 512 needs several 32-row passes a block
RNN_SHAPES = [(4, 128, 512), (5, 100, 300), (1, 3, 7), (3, 33, 65),
              (2, 4100, 512)]
RNN_GATES = {"lstm": 4, "gru": 3, "rnn": 1}


def _rnn_call(cell, zx, r, h0, c0, train, plain=False):
    if cell == "lstm":
        fn = rs.lstm_seq_plain if plain else rs.lstm_seq
        return fn(zx, r, h0, c0, train=train)
    if cell == "gru":
        fn = rs.gru_seq_plain if plain else rs.gru_seq
        return fn(zx, r, h0, train=train)
    fn = rs.rnn_seq_plain if plain else rs.rnn_seq
    return fn(zx, r, h0, act="sigmoid" if train else "tanh")


def _rnn_operands(dev, seed, t, n, k, gates, r_dt):
    zx, r, h0, c0 = _planes(dev, seed, (t, n, gates * k), (k, gates * k),
                            (n, k), (n, k))
    return zx, (r * 0.1).to(r_dt), h0 * 0.1, c0 * 0.1


@pytest.mark.parametrize("t,n,k", RNN_SHAPES)
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
@pytest.mark.parametrize("r_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_rnn_seq_matches_plain(cuda, t, n, k, cell, r_dt, train):
    """Each kernel in both forms (the simple RNN's second form: sigmoid)
    against its plain version: f32 to 1e-5 (the product sums in another
    order than cuBLAS), bf16 to 1e-3."""
    zx, r, h0, c0 = _rnn_operands(cuda, 30, t, n, k, RNN_GATES[cell], r_dt)
    name = cell + "_seq"
    before, before_t = rs.launches[name], dict(rs.train_launches)
    got = _rnn_call(cell, zx, r, h0, c0, train)
    torch.cuda.synchronize()
    assert rs.launches[name] == before + 1
    if cell != "rnn":
        assert rs.train_launches[name] == before_t[name] + int(train)
    want = _rnn_call(cell, zx, r, h0, c0, train, plain=True)
    assert len(got) == len(want)
    tol = 1e-5 if r_dt == torch.float32 else 1e-3
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and g_.dtype == torch.float32
        assert torch.isfinite(g_).all()
        assert _rel(g_, w_) <= tol


def test_rnn_cuda_tensor_never_takes_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")
    for name in ("lstm_seq_plain", "gru_seq_plain", "rnn_seq_plain"):
        monkeypatch.setattr(rs, name, boom)
    for cell, gates in RNN_GATES.items():
        zx, r, h0, c0 = _rnn_operands(cuda, 31, 3, 16, 24, gates,
                                      torch.float32)
        _rnn_call(cell, zx, r, h0, c0, False)
    torch.cuda.synchronize()


def test_rnn_seq_beyond_envelope(cuda):
    """K = 1024 with f32 R needs a 256 KB R slice: seq_kernel_ok says no,
    the wrapper refuses before any launch, and the cell takes the scan
    route; bf16 R at the same K fits."""
    k = 1024
    assert not rs.seq_kernel_ok(8, k, 4, 4)
    assert rs.seq_kernel_ok(8, k, 4, 2)
    assert rs.seq_kernel_ok(128, 512, 4, 4)       # samples/lstm_driver.py
    zx, r, h0, c0 = _rnn_operands(cuda, 32, 2, 8, k, 4, torch.float32)
    before = dict(rs.launches)
    with pytest.raises(ValueError, match="shared memory"):
        rs.lstm_seq(zx, r, h0, c0, train=False)
    assert rs.launches == before
    rnncell.reset_scan_calls()
    rng = np.random.default_rng(33)
    cell = create_rnncell(RnnDesc(n=8, c=16, k=k, max_t=2))
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 4 * k)) * 0.1).astype(np.float32)
    rw = (rng.standard_normal((k, 4 * k)) * 0.1).astype(np.float32)
    hs, _, _ = cell.forward(x, w, rw, np.zeros(4 * k, np.float32))
    torch.cuda.synchronize()
    assert rnncell.scan_calls["lstm"] == 1 and rs.launches == before
    assert torch.isfinite(hs).all()


# (cell, K, R dtype) at the forward kernels' geometry edges: a block owns 16
# hidden units at every K and in every cell, so K 16 is one column block and
# K 17 two, the second ragged; with f32 R the split form (the k range split
# over the warps, an 8 x 8 tile a lane) takes K <= 576 for the LSTM and GRU,
# whose R slice and partial sums then fill a block, and the chain form (one
# k-order FMA chain an output) takes 640 .. 832 (LSTM) and .. 1152 (GRU);
# bf16 R always takes the chain form, up to K 1728 (LSTM); the simple RNN's
# slice is a quarter of the LSTM's
F32, BF16 = torch.float32, torch.bfloat16
RNN_EDGES = [("lstm", 16, F32), ("rnn", 17, F32), ("gru", 17, BF16),
             ("lstm", 576, F32), ("gru", 576, F32), ("lstm", 640, F32),
             ("lstm", 832, F32), ("gru", 1152, F32), ("lstm", 832, BF16),
             ("lstm", 1728, BF16), ("gru", 1216, BF16), ("rnn", 1728, F32),
             ("rnn", 1728, BF16)]
SPLIT_MAX_K = {"lstm": 576, "gru": 576, "rnn": 2112}


@pytest.mark.parametrize("cell,k,r_dt", RNN_EDGES)
def test_rnn_seq_geometry_edges_match_plain(cuda, cell, k, r_dt):
    """Each forward kernel at a geometry edge (ragged N 37, T 2), in both
    forms, against its plain version at the gates of
    test_rnn_seq_matches_plain; the launch counted by the kernel's form."""
    t, n, gates = 2, 37, RNN_GATES[cell]
    assert rs.seq_kernel_ok(n, k, gates, r_dt.itemsize)
    form = ("split" if r_dt == F32 and k <= SPLIT_MAX_K[cell] else "chain")
    assert rs.seq_form(n, k, gates, r_dt.itemsize)["form"] == form
    zx, r, h0, c0 = _rnn_operands(cuda, 35, t, n, k, gates, r_dt)
    tol = 1e-5 if r_dt == F32 else 1e-3
    for train in (False, True):
        before = dict(rs.form_launches)
        got = _rnn_call(cell, zx, r, h0, c0, train)
        torch.cuda.synchronize()
        before[form] += 1
        assert rs.form_launches == before
        want = _rnn_call(cell, zx, r, h0, c0, train, plain=True)
        for g_, w_ in zip(got, want):
            assert torch.isfinite(g_).all()
            assert _rel(g_, w_) <= tol
            if r_dt == BF16:
                assert torch.equal(g_, w_)


def test_rnn_seq_envelope_and_grid(cuda):
    """The forward envelope is no smaller than the first design's (K 832
    with f32 R, 1728 with bf16 R, in every cell); one step beyond the LSTM's
    is refused; at lstm_driver's N 128, K 512 every cell's grid holds at
    least 120 blocks (32 column blocks x 4 row blocks of 32 rows), f32 on
    the split form, bf16 on the chain form; at N 4100 f32 stays on the
    split form and bf16 takes the wide form (the first design's geometry)
    in the LSTM and the simple RNN (the simple RNN's at every larger N
    too); the GRU has no wide form."""
    for gates in (4, 3, 1):
        assert rs.seq_kernel_ok(128, 832, gates, 4)
        assert rs.seq_kernel_ok(128, 1728, gates, 2)
        for itemsize, form in ((4, "split"), (2, "chain")):
            got = rs.seq_form(128, 512, gates, itemsize)
            assert got["blocks"] >= 120, (gates, itemsize, got)
            assert (got["column_blocks"], got["rows"]) == (32, 32)
            assert got["form"] == form
        assert rs.seq_form(4100, 512, gates, 4)["form"] == "split"
        assert rs.seq_form(4100, 512, gates, 2)["form"] == (
            "chain" if gates == 3 else "wide")
    assert rs.seq_form(32768, 512, 3, 2)["form"] == "chain"
    assert rs.seq_form(32768, 512, 1, 2)["form"] == "wide"
    assert not rs.seq_kernel_ok(128, 896, 4, 4)
    assert not rs.seq_kernel_ok(128, 1792, 4, 2)
    with pytest.raises(ValueError, match="shared memory"):
        rs.seq_form(128, 896, 4, 4)


def _rnn_gold(zx, r, h0):
    """The simple RNN (tanh) in f64: h' = tanh(zx[t] + h@R)."""
    h, r64, hs = h0.double(), r.double(), []
    for x in zx.double():
        h = torch.tanh(x + h @ r64)
        hs.append(h)
    return torch.stack(hs)


@pytest.mark.parametrize("n", [128, 4100])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
@pytest.mark.parametrize("r_dt", [F32, BF16])
def test_rnn_seq_long_scan_matches_plain(cuda, n, cell, r_dt):
    """lstm_driver's T 32 and K 512 at N 128 and 4100, zx ~ N(0, 1) (as
    the other cases and seq_profile draw it), R ~ 0.1 N(0, 1), in the train
    form (the simple RNN's one form).  Every step against the plain
    version's step from the kernel's own state before it: f32 to 1e-5,
    bf16 bit for bit.  The whole scan: bf16 bit for bit; f32 LSTM and GRU
    to 1e-5; the f32 simple RNN's tanh over R of gain ~2.3 carries a step's
    f32 rounding further over 32 steps, whatever the order of the sums (the
    plain version's own order is cuBLAS's), so the whole scan is held to
    f64 gold at the 1e-3 gate and its distance from the plain version is
    printed."""
    t, k, gates = 32, 512, RNN_GATES[cell]
    zx, r, h0, c0 = _rnn_operands(cuda, 36, t, n, k, gates, r_dt)
    train = cell != "rnn"
    got = _rnn_call(cell, zx, r, h0, c0, train)
    torch.cuda.synchronize()
    tol = 1e-5 if r_dt == F32 else 0.0
    seqs = [i for i, g_ in enumerate(got) if g_.dim() == 3]
    for ti in range(t):
        h_prev = h0 if ti == 0 else got[0][ti - 1]
        c_prev = None
        if cell == "lstm":
            c_prev = c0 if ti == 0 else got[3][ti - 1]   # cs, the running c
        step = _rnn_call(cell, zx[ti:ti + 1].contiguous(), r,
                         h_prev.contiguous(), c_prev, train, plain=True)
        for i in seqs:
            assert _rel(got[i][ti], step[i][0]) <= tol, (ti, i)
    want = _rnn_call(cell, zx, r, h0, c0, train, plain=True)
    dist = max(_rel(g_, w_) for g_, w_ in zip(got, want))
    print(f"{cell} N {n} {r_dt}: whole scan {dist:.3e} from the plain "
          f"version")
    if r_dt == BF16:
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
    elif cell != "rnn":
        assert dist <= 1e-5
    else:
        assert _rel(got[0], _rnn_gold(zx, r, h0)) <= 1e-3


def _first_wide_passes(k, gates):
    """The fewest 32-row passes of N at which bf16 R takes the wide form
    for K (rnn_seq.cu plan_form), from seq_form."""
    for m in range(1, 1024):
        if rs.seq_form(32 * m, k, gates, 2)["form"] == "wide":
            return m
    raise AssertionError(f"no wide form up to N {32 * 1023} at K {k}")


@pytest.mark.parametrize("k", [65, 300])
@pytest.mark.parametrize("cell", ["lstm", "rnn"])
def test_rnn_seq_wide_switch_matches_plain(cuda, cell, k):
    """bf16 R on each side of the switch to the wide form (the fewest row
    passes at which the kernel takes it, and one pass fewer; the LSTM and
    the simple RNN, the cells that have the form), at ragged K:
    65 (not a multiple of 4; the simple RNN's wide blocks own 64 units, so
    its second holds one) and 300 (44 units in the simple RNN's last wide
    block); ragged N on the wide side.  Bit for bit against the plain
    version in both forms of the cell (the simple RNN's: tanh, sigmoid),
    each launch counted under the form seq_form reports."""
    gates = RNN_GATES[cell]
    m = _first_wide_passes(k, gates)
    assert m > 1
    for n, form in ((32 * (m - 1), "chain"), (32 * (m - 1) + 5, "wide")):
        assert rs.seq_form(n, k, gates, 2)["form"] == form
        zx, r, h0, c0 = _rnn_operands(cuda, 37, 3, n, k, gates, BF16)
        for train in (False, True):
            before = dict(rs.form_launches)
            got = _rnn_call(cell, zx, r, h0, c0, train)
            torch.cuda.synchronize()
            before[form] += 1
            assert rs.form_launches == before
            want = _rnn_call(cell, zx, r, h0, c0, train, plain=True)
            for g_, w_ in zip(got, want):
                assert torch.equal(g_, w_), (n, form, train)


@pytest.mark.parametrize("ct", list(CellType))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rnncell_card_equals_cpu(cuda, ct, dt):
    """forward and forward_train on the card (one launch each) against the
    same calls with target="cpu"; both sides also against an f64 numpy gold
    (the RNN gold gates: 1e-3 in f32, 5e-2 in bf16), so that a failure
    names the tensor, the side that is off, the worst index and the
    values."""
    g = {CellType.LSTM: 4, CellType.GRU: 3}.get(ct, 1)
    n, c, k, t = 37, 50, 70, 4
    rng = np.random.default_rng(34)
    x = rng.standard_normal((t, n, c)).astype(np.float32)
    w, r = ((rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((c, g * k), (k, g * k)))
    b = rng.standard_normal(g * k).astype(np.float32)
    h0, c0 = (rng.standard_normal((n, k)).astype(np.float32) * 0.1
              for _ in range(2))
    desc = RnnDesc(n=n, c=c, k=k, max_t=t, cell_type=ct, in_dtype=dt,
                   out_dtype=dt)
    out = {}
    for target in ("cuda", "cpu"):
        xp.set_config(target=target)
        cell = create_rnncell(desc)
        rs.reset_launches()
        # the CPU calls keep their own products for the failure message
        with rs.keep_products() as kept_fwd:
            fwd = cell.forward(x, w, r, b, h0, c0)
        with rs.keep_products() as kept_train:
            (hs, h_t, c_t), saved = cell.forward_train(x, w, r, b, h0, c0)
        if target == "cuda":
            torch.cuda.synchronize()
            assert sum(rs.launches.values()) == 2
            assert sum(rs.train_launches.values()) == int(g > 1)
        out[target] = [v.cpu() for v in fwd + (hs, h_t, c_t)]
    gold = rnn_cell_gold(ct, x, w, r, b, h0, c0) * 2  # forward, train
    names = ("forward hs", "forward h_T", "forward c_T", "forward_train hs",
             "forward_train h_t", "forward_train c_t")
    tol = 1e-5 if dt == "float32" else 1e-2
    gold_tol = 1e-3 if dt == "float32" else 5e-2
    off = []
    for name, got, want, gd in zip(names, out["cuda"], out["cpu"], gold):
        assert got.dtype == want.dtype, name
        for side, v in (("card", got), ("cpu", want)):
            assert _rel(v, torch.from_numpy(gd)) <= gold_tol, (
                f"{side} against gold: " + rnn_diagnosis(name, got, want,
                                                          gd))
        if _rel(got, want) > tol:
            off.append(f"{_rel(got, want):.3e} > {tol:g}; "
                       + rnn_diagnosis(name, got, want, gd))
    if off:  # first the failing calls' own CPU products, then the CPU
        # side again, right away, and its two products recomputed
        off.insert(0, products_report(kept_fwd, "the cpu forward") + "\n"
                   + products_report(kept_train, "the cpu forward_train"))
        xp.set_config(target="cpu")
        again = create_rnncell(desc).forward(x, w, r, b, h0, c0)[0]
        off.append(f"cpu forward hs again: {_rel(again, out['cpu'][0]):.3e} "
                   f"from the first, {_rel(again, torch.from_numpy(gold[0])):.3e}"
                   f" from gold; " + cpu_products(x, w, r, h0))
    assert not off, "\n".join(off)


# ---------------------------------------------------------------------------
# The three RNN backward kernels (ops/csrc/rnn_seq.cu), and the repeatability
# of the six RNN kernels
# ---------------------------------------------------------------------------

from xsmm_tpu_torch.ops.smm import _matmul  # noqa: E402

# (T, N, K): lstm_driver's N and K; ragged N and K; T = 1; K below a block's
# 16 units; N = 4100 needs several 32-row passes a block
# (3, 700, 256) and (2, 4100, 512) run the backward over several row chunks
RNN_BWD_SHAPES = [(4, 128, 512), (5, 100, 300), (1, 3, 7), (3, 33, 65),
                  (2, 4100, 512), (3, 700, 256)]


def _bwd_operands(dev, seed, t, n, k, gates, r_dt, act="tanh"):
    """dhs, the residuals of a forward (gates in their ranges), the states
    and R^T [G*K, K] in r_dt."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    dhs = f(t, n, k)
    if gates == 4:
        res = [torch.sigmoid(f(t, n, k)), torch.tanh(f(t, n, k)),
               torch.sigmoid(f(t, n, k)), torch.sigmoid(f(t, n, k)),
               f(t, n, k)]
    elif gates == 3:
        res = [torch.sigmoid(f(t, n, k)), torch.sigmoid(f(t, n, k)),
               torch.tanh(f(t, n, k)), f(t, n, k), torch.tanh(f(t, n, k))]
    else:
        res = [rs.ACTS[act][1](f(t, n, k))]
    states = [f(n, k) * 0.5 for _ in range(3)]
    rt = (f(gates * k, k) / k ** 0.5).to(r_dt).contiguous()
    return dhs, res, states, rt


def _bwd_call(gates, ops, dz_dt, plain=False, act="tanh"):
    dhs, res, st, rt = ops
    sfx = "_plain" if plain else ""
    if gates == 4:
        return getattr(rs, "lstm_seq_bwd" + sfx)(dhs, *res, *st, rt,
                                                 dz_dt=dz_dt)
    if gates == 3:
        return getattr(rs, "gru_seq_bwd" + sfx)(dhs, *res, *st[:2], rt,
                                                dz_dt=dz_dt)
    return getattr(rs, "rnn_seq_bwd" + sfx)(dhs, *res, st[0], rt, act=act,
                                            dz_dt=dz_dt)


@pytest.mark.parametrize("t,n,k", RNN_BWD_SHAPES)
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
@pytest.mark.parametrize("r_dt", [torch.float32, torch.bfloat16])
def test_rnn_seq_bwd_matches_plain(cuda, t, n, k, cell, r_dt):
    """Each backward kernel against its plain version, dz in R's dtype as
    the cell emits it (the simple RNN with sigmoid): f32 to 1e-5 (the
    product sums in another order than cuBLAS), bf16 bit for bit (dz, dh0,
    dc0 and db are summed in the kernel's order by the plain version)."""
    _bwd_matches_plain(cuda, t, n, k, cell, r_dt)


def _bwd_matches_plain(dev, t, n, k, cell, r_dt):
    gates = RNN_GATES[cell]
    ops = _bwd_operands(dev, 40, t, n, k, gates, r_dt, "sigmoid")
    name = cell + "_seq_bwd"
    before = rs.bwd_launches[name]
    got = _bwd_call(gates, ops, r_dt, act="sigmoid")
    torch.cuda.synchronize()
    assert rs.bwd_launches[name] == before + 1
    want = _bwd_call(gates, ops, r_dt, plain=True, act="sigmoid")
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert g_.shape == w_.shape and g_.dtype == w_.dtype
        assert torch.isfinite(g_.float()).all()
        if r_dt == torch.bfloat16:
            assert torch.equal(g_, w_), (i, (g_.double() - w_.double()).abs()
                                         .max().item())
        else:
            assert _rel(g_, w_) <= 1e-5


@pytest.mark.parametrize("cell,k,r_dt", [("lstm", 832, torch.float32),
                                         ("lstm", 1664, torch.bfloat16),
                                         ("gru", 1109, torch.float32),
                                         ("rnn", 2112, torch.float32)])
def test_rnn_seq_bwd_envelope_edge_matches_plain(cuda, cell, k, r_dt):
    """At the edge of the backward envelope: the LSTM with f32 R at K 832
    and with bf16 R at K 1664 (its R^T slice held in bf16), the GRU with f32
    R at K 1109, the simple RNN with f32 R at K 2112 (16 units a block,
    where its 32-unit slice does not fit); each inside the envelope,
    launched once, against its plain version as above."""
    assert rs.seq_bwd_kernel_ok(40, k, RNN_GATES[cell],
                                torch.tensor([], dtype=r_dt).element_size())
    _bwd_matches_plain(cuda, 2, 40, k, cell, r_dt)


@pytest.mark.parametrize("gates,k", [(4, 512), (3, 1109), (1, 2112)])
def test_rnn_seq_bwd_scratch_is_one_row_chunk(cuda, gates, k):
    """The backward's exchange buffer holds one row chunk of partials: the
    same size at every N past a chunk's rows, and at most 32 MB (PBUF_MB
    in rnn_seq.cu) or one pass of the grid, 2 x column blocks x resident
    blocks x 512 f32 (one block an SM), whichever is larger."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sizes = [rs._bwd_scratch_floats(n, k, gates, 4, cuda.index)[1]
             for n in (16384, 1 << 17, 1 << 20)]
    cb = -(-k // (16 if gates > 1 or k > 1768 else 32))
    assert sizes[0] == sizes[1] == sizes[2] <= max(
        32 << 18, 2 * cb * sms * 512)


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("dz_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r_dt", [torch.float32, torch.bfloat16])
def test_rnn_seq_bwd_dz_dtypes(cuda, act, dz_dt, r_dt):
    """dz emitted in either dtype with either R: the product's operand is
    dz rounded to R's dtype, whatever dz is emitted in."""
    for gates in (4, 3, 1):
        ops = _bwd_operands(cuda, 41, 3, 50, 40, gates, r_dt, act)
        got = _bwd_call(gates, ops, dz_dt, act=act)
        want = _bwd_call(gates, ops, dz_dt, plain=True, act=act)
        torch.cuda.synchronize()
        tol = 1e-5 if r_dt == torch.float32 else 1e-3
        for g_, w_ in zip(got, want):
            assert g_.dtype == w_.dtype
            assert _rel(g_, w_) <= (1e-2 if g_.dtype == torch.bfloat16
                                    else tol)


def test_rnn_bwd_cuda_tensor_never_takes_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")
    for name in ("lstm_seq_bwd_plain", "gru_seq_bwd_plain",
                 "rnn_seq_bwd_plain"):
        monkeypatch.setattr(rs, name, boom)
    for gates in (4, 3, 1):
        _bwd_call(gates, _bwd_operands(cuda, 42, 3, 16, 24, gates,
                                       torch.float32), torch.float32)
    torch.cuda.synchronize()


def test_rnn_seq_bwd_beyond_envelope(cuda):
    """The LSTM with f32 R at K = 1024 needs a 256 KB R^T slice: the
    backward envelope says no, the wrapper refuses before any launch, and
    the cell's backward takes its scan route (its forward, with bf16 R at
    the same K, fits)."""
    k = 1024
    assert not rs.seq_bwd_kernel_ok(8, k, 4, 4)
    assert rs.seq_bwd_kernel_ok(8, k, 4, 2)
    assert rs.seq_bwd_kernel_ok(128, 512, 4, 4)    # samples/lstm_driver.py
    ops = _bwd_operands(cuda, 43, 2, 8, k, 4, torch.float32)
    before = dict(rs.bwd_launches)
    with pytest.raises(ValueError, match="shared memory"):
        _bwd_call(4, ops, torch.float32)
    assert rs.bwd_launches == before
    rnncell.reset_scan_calls()
    rng = np.random.default_rng(44)
    cell = create_rnncell(RnnDesc(n=8, c=16, k=k, max_t=2))
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 4 * k)) * 0.1).astype(np.float32)
    rw = (rng.standard_normal((k, 4 * k)) * 0.1).astype(np.float32)
    grads = cell.backward_weight_update(x, w, rw, np.zeros(4 * k, np.float32),
                                        np.ones((2, 8, k), np.float32))
    torch.cuda.synchronize()
    assert rnncell.bwd_scan_calls["lstm"] == 1 and rs.bwd_launches == before
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("ct", list(CellType))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rnncell_bwd_card_equals_cpu(cuda, ct, dt):
    """backward_from_saved and autograd through forward on the card (one
    backward launch each, no scan route) against the same calls with
    target="cpu"."""
    g = {CellType.LSTM: 4, CellType.GRU: 3}.get(ct, 1)
    n, c, k, t = 37, 50, 70, 4
    rng = np.random.default_rng(45)
    x = rng.standard_normal((t, n, c)).astype(np.float32)
    w, r = ((rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((c, g * k), (k, g * k)))
    b = rng.standard_normal(g * k).astype(np.float32)
    h0, c0 = (rng.standard_normal((n, k)).astype(np.float32) * 0.1
              for _ in range(2))
    dhs = rng.standard_normal((t, n, k)).astype(np.float32)
    desc = RnnDesc(n=n, c=c, k=k, max_t=t, cell_type=ct, in_dtype=dt,
                   out_dtype=dt)
    out = {}
    for target in ("cuda", "cpu"):
        xp.set_config(target=target)
        dev = xp.platform.device()
        cell = create_rnncell(desc)
        rs.reset_launches()
        rnncell.reset_scan_calls()
        _, saved = cell.forward_train(x, w, r, b, h0, c0)
        grads = list(cell.backward_from_saved(saved, dhs))
        leaves = [torch.from_numpy(v).to(dev).requires_grad_()
                  for v in (x, w, r, b, h0, c0)]
        hs, h_t, _ = cell.forward(*leaves)
        loss = (hs.float() * torch.from_numpy(dhs).to(dev)).sum() + h_t.sum()
        grads += torch.autograd.grad(loss, leaves[:5])
        if target == "cuda":
            torch.cuda.synchronize()
            assert sum(rs.bwd_launches.values()) == 2
            assert not any(rnncell.bwd_scan_calls.values())
        out[target] = [v.cpu() for v in grads]
    tol = 1e-5 if dt == "float32" else 1e-2
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.dtype == want.dtype
        assert _rel(got, want) <= tol


@pytest.mark.parametrize("t,n,k", [(4, 37, 70), (32, 128, 512)])
@pytest.mark.parametrize("gates", [4, 3, 1])
def test_rnn_kernels_repeat_bit_identical(cuda, t, n, k, gates):
    """Every forward and backward kernel gives the same bits on every one
    of 50 launches: the grid barrier and the L2 exchange leave no race."""
    dhs, res, st, rt = _bwd_operands(cuda, 46, t, n, k, gates, torch.float32)
    zx = torch.randn(t, n, gates * k, device=cuda)
    r = rt.t().contiguous()

    def fwd():
        if gates == 4:
            return rs.lstm_seq(zx, r, st[0], st[1], train=True)
        if gates == 3:
            return rs.gru_seq(zx, r, st[0], train=True)
        return rs.rnn_seq(zx, r, st[0], act="tanh")

    for fn in (fwd, lambda: _bwd_call(gates, (dhs, res, st, rt),
                                      torch.float32)):
        ref = [v.clone() for v in fn()]
        for _ in range(50):
            for a, b in zip(fn(), ref):
                assert torch.equal(a, b)


def test_rnn_tanh_card_case_repeats_bit_identical(cuda):
    """The case of test_rnncell_card_equals_cpu[float32-RNN_TANH] (which
    once gave 1.44e-5 against its 1e-5), 1000 times: the hs of the whole
    forward call and the x@W product, bit for bit against the first call,
    and the card against the CPU within the test's tolerance."""
    n, c, k, t = 37, 50, 70, 4
    rng = np.random.default_rng(34)
    x = rng.standard_normal((t, n, c)).astype(np.float32)
    w, r = ((rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((c, k), (k, k)))
    b = rng.standard_normal(k).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32) * 0.1
    cell = create_rnncell(RnnDesc(n=n, c=c, k=k, max_t=t,
                                  cell_type=CellType.RNN_TANH))
    xd = torch.from_numpy(x).to(cuda).reshape(t * n, c)
    wd = torch.from_numpy(w).to(cuda)
    hs0 = cell.forward(x, w, r, b, h0)[0].clone()
    zx0 = _matmul(xd, wd).clone()
    hs_var = zx_var = 0
    for _ in range(1000):
        hs_var += not torch.equal(cell.forward(x, w, r, b, h0)[0], hs0)
        zx_var += not torch.equal(_matmul(xd, wd), zx0)
    xp.set_config(target="cpu")
    cpu = create_rnncell(RnnDesc(n=n, c=c, k=k, max_t=t,
                                 cell_type=CellType.RNN_TANH)
                         ).forward(x, w, r, b, h0)[0]
    assert (hs_var, zx_var) == (0, 0)
    assert _rel(hs0.cpu(), cpu) <= 1e-5


# ---------------------------------------------------------------------------
# The max-pool window backward kernel (ops/csrc/pooling.cu) and the DNN
# layer handles, card against CPU
# ---------------------------------------------------------------------------

from xsmm_tpu_torch import dnn as pd  # noqa: E402
from xsmm_tpu_torch.dnn import pooling as ppool  # noqa: E402

# NHWC: tied (values rounded to 0.5) and ragged (odd quad counts, one
# window, more quads than a grid holds at once)
POOL_SHAPES = [(2, 8, 8, 128), (3, 6, 10, 4), (1, 2, 2, 4), (5, 14, 22, 36),
               (64, 56, 56, 256)]


def _tied(dev, seed, *shape):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.round(torch.randn(shape, generator=g, device=dev) * 2) / 2


@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_maxpool2x2_bwd_matches_plain(cuda, shape):
    n, h, w, c = shape
    x = _tied(cuda, 1, n, h, w, c)
    dy = torch.randn((n, h // 2, w // 2, c), device=cuda)
    before = ppool.launches["maxpool2x2_bwd"]
    got = ppool.maxpool2x2_bwd(dy, x)
    torch.cuda.synchronize()
    assert ppool.launches["maxpool2x2_bwd"] == before + 1
    _same(got, ppool.maxpool2x2_bwd_plain(dy, x))
    # and the library's max-pool backward on these finite, tied inputs
    xr = x.permute(0, 3, 1, 2).detach().requires_grad_()
    (want,) = torch.autograd.grad(
        torch.nn.functional.max_pool2d(xr, 2, 2), xr, dy.permute(0, 3, 1, 2))
    _same(got, want.permute(0, 2, 3, 1).contiguous())


def test_maxpool2x2_bwd_nan_window_is_zero(cuda):
    x = torch.zeros((1, 2, 2, 4), device=cuda)
    x[0, 1, 0, 1] = float("nan")
    dy = torch.ones((1, 1, 1, 4), device=cuda)
    got = ppool.maxpool2x2_bwd(dy, x)
    _same(got, ppool.maxpool2x2_bwd_plain(dy, x))
    assert (got[..., 1] == 0).all()


@pytest.mark.parametrize("bad", ["odd", "c", "dtype", "dy", "misaligned",
                                 "strided", "devices"])
def test_maxpool2x2_bwd_refuses(cuda, bad):
    x = torch.zeros((2, 4, 4, 8), device=cuda)
    dy = torch.zeros((2, 2, 2, 8), device=cuda)
    if bad == "odd":
        x = torch.zeros((2, 5, 4, 8), device=cuda)
    elif bad == "c":
        x, dy = x[..., :6].contiguous(), dy[..., :6].contiguous()
    elif bad == "dtype":
        x, dy = x.bfloat16(), dy.bfloat16()
    elif bad == "dy":
        dy = torch.zeros((2, 2, 3, 8), device=cuda)
    elif bad == "misaligned":
        x = torch.zeros(x.numel() + 1, device=cuda)[1:].view(2, 4, 4, 8)
    elif bad == "strided":
        x = torch.zeros((2, 4, 8, 4), device=cuda).transpose(2, 3)
    else:
        dy = dy.cpu()
    before = ppool.launches["maxpool2x2_bwd"]
    with pytest.raises(ValueError):
        ppool.maxpool2x2_bwd(dy, x)
    assert ppool.launches["maxpool2x2_bwd"] == before


def _card_and_cpu(fn):
    """fn() on the card (numpy in: the entry points' device) and on the
    CPU target; both results as CPU tensors (lists for tuples)."""
    def flat(v):
        if isinstance(v, (tuple, list)):
            return [u for x in v for u in flat(x)]
        return [] if v is None else [v.cpu()]
    card = flat(fn())
    torch.cuda.synchronize()
    xp.set_config(target="cpu")
    cpu = flat(fn())
    xp.set_config(target="cuda")
    assert len(card) == len(cpu)
    return card, cpu


def _agree(card, cpu, tol):
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype in (torch.bool, torch.int16, torch.uint8):
            assert (a != b).float().mean() <= 1e-3
        else:
            assert _rel(a.float(), b.float()) <= tol


@pytest.mark.parametrize("ptype", ["MAX", "AVG"])
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_pooling_card_equals_cpu(cuda, monkeypatch, ptype, window, dt):
    if window:
        monkeypatch.setenv("XSMM_POOL_WINDOW_KERNEL", "1")
    d = pd.PoolingDesc(n=4, c=128, h=14, w=14, r=2, s=2, u=2, v=2,
                       pool_type=pd.PoolType[ptype], dtype=dt)
    rng = np.random.default_rng(5)
    x = (np.round(rng.standard_normal((4, 14, 14, 128)) * 2) / 2
         ).astype(np.float32)
    dy = rng.standard_normal((4, 7, 7, 128)).astype(np.float32)
    launched = window and ptype == "MAX"

    def run():
        layer = pd.create_pooling_layer(d)
        assert layer.bwd_kind == ("pallas_window" if launched else "vjp")
        return layer.forward(x), layer.backward(dy, x)
    ppool.reset_launches()
    card, cpu = _card_and_cpu(run)
    assert ppool.launches["maxpool2x2_bwd"] == int(launched)
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype
        if ptype == "MAX":
            assert torch.equal(a, b)
        else:
            assert _rel(a.float(), b.float()) <= 1e-6


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fc_card_equals_cpu(cuda, dt):
    d = pd.FCDesc(n=64, c=96, k=80, in_dtype=dt, out_dtype=dt,
                  fuse_ops=pd.FuseOp.BIAS | pd.FuseOp.RELU)
    rng = np.random.default_rng(6)
    x, w = (rng.standard_normal(s).astype(np.float32) for s in
            ((64, 96), (96, 80)))
    b = rng.standard_normal(80).astype(np.float32)
    dy = rng.standard_normal((64, 80)).astype(np.float32)

    def run():
        layer = pd.create_fullyconnected_layer(d)
        y, mask = layer.forward(x, w, b)
        m = mask.cpu().numpy()   # one mask for both devices
        return y, layer.backward(dy, w, m), layer.weight_update(x, dy, m)
    card, cpu = _card_and_cpu(run)
    _agree(card, cpu, 1e-5 if dt == "float32" else 1e-2)


@pytest.mark.parametrize("fuse", ["RELU", "ELTWISE_RELU"])
def test_batchnorm_card_equals_cpu(cuda, fuse):
    d = pd.BnDesc(n=8, c=64, h=7, w=7, fuse=pd.BnFuse[fuse])
    rng = np.random.default_rng(7)
    x, res, dy = (rng.standard_normal((8, 7, 7, 64)).astype(np.float32)
                  for _ in range(3))
    gamma, beta = (rng.standard_normal(64).astype(np.float32)
                   for _ in range(2))
    r = res if "ELTWISE" in fuse else None

    def run():
        bn = pd.create_fusedbatchnorm(d)
        y, st = bn.forward(x, gamma, beta, r)
        grads = bn.backward(dy, gamma, st)
        running = bn.update_running(bn.init_running(), st)
        return (y, grads, running,
                bn.forward_eval(x, gamma, beta, running, r),
                bn.forward_from_moments(x, gamma, beta, st.mean, st.var,
                                        r)[0])
    card, cpu = _card_and_cpu(run)
    _agree(card, cpu, 1e-4)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,k", [(1, 64), (2, 128), (1, 16)])
def test_conv_card_equals_cpu(cuda, dt, stride, k):
    """FWD with the forward-stats fusions, BWD with its fusions, UPD and
    autograd through forward (the direct backward), card against CPU
    (the CPU runs the space-to-depth fold where it is routed)."""
    F_ = pd.FuseOp
    kw = dict(n=4, c=32, h=14, w=14, k=k, r=3, s=3, u=stride, v=stride,
              pad_h=1, pad_w=1, in_dtype=dt, out_dtype=dt)
    df = pd.ConvDesc(**kw, fuse_ops=F_.BIAS | F_.RELU | F_.BATCH_STATS_FWD
                     | F_.BATCHNORM_STATS | F_.MAX_STATS)
    db = pd.ConvDesc(**kw, fuse_ops=F_.RELU_BWD | F_.ELTWISE_BWD
                     | F_.BATCH_STATS_BWD | F_.MAX_STATS)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 14, 14, 32)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 32, k)) * 0.1).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    oh = df.out_h
    dy = rng.standard_normal((4, oh, oh, k)).astype(np.float32)
    # one forward activation for both devices' fused backward: a y near 0
    # may take the other side of the RELU_BWD mask on the other device
    xp.set_config(target="cpu")
    y_np = pd.create_conv_layer(df).forward(x, w, b)[0].float().numpy()
    xp.set_config(target="cuda")

    def run():
        lf, lb = pd.create_conv_layer(df), pd.create_conv_layer(db)
        y, stats = lf.forward(x, w, b)
        dev = y.device
        xt_ = torch.tensor(x, device=dev, requires_grad=True)
        wt_ = torch.tensor(w, device=dev, requires_grad=True)
        plain = pd.create_conv_layer(pd.ConvDesc(**kw))
        (plain.forward(xt_, wt_).float() ** 2).sum().backward()
        return (y, stats, lb.backward(dy, w, y_np), lb.weight_update(x, dy),
                xt_.grad, wt_.grad)
    card, cpu = _card_and_cpu(run)
    _agree(card, cpu, 1e-5 if dt == "float32" else 1e-2)


def test_conv_f32_runs_without_tf32_and_restores_the_flag(cuda):
    """An f32 conv with cuDNN's TF32 switched on by the caller still runs
    in full f32 (1e-6 of f64 gold, where TF32 gives ~1e-3), and the flag
    is as the caller set it after each call."""
    d = pd.ConvDesc(n=8, c=64, h=28, w=28, k=64, r=3, s=3, pad_h=1, pad_w=1)
    layer = pd.create_conv_layer(d)
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((8, 28, 28, 64), generator=g, device=cuda)
    w = torch.randn((3, 3, 64, 64), generator=g, device=cuda) * 0.1
    gold = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    saved = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            y = layer.forward(x, w)
            assert torch.backends.cudnn.allow_tf32 is flag
            assert _rel(y.double(), gold) <= 1e-6
            layer.backward(y, w)
            layer.weight_update(x, y)
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("mode", ["NO_ROUND", "NEAREST", "BIAS", "FPHW"])
def test_quant_card_equals_cpu(cuda, mode):
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((64, 256, 7, 7)) * 3).astype(np.float32)

    def run():
        q, scf = pd.quantize(x, 1, pd.RoundMode[mode])
        return q, scf, pd.dequantize(q, scf)
    card, cpu = _card_and_cpu(run)
    for a, b in zip(card, cpu):
        assert torch.equal(a, b)


def test_quant_stoch_on_card(cuda):
    x = torch.full((1 << 16,), 0.3e-4, device=cuda)
    q, scf = pd.quantize(x, round_mode=pd.RoundMode.STOCH,
                         key=torch.Generator(device=cuda).manual_seed(0))
    back = pd.dequantize(q, scf)
    assert abs(float(back.mean()) - 0.3e-4) < 0.01e-4


# ---------------------------------------------------------------------------
# Last in the file, so that it runs after every test above in one process:
# the CPU side of test_rnncell_card_equals_cpu[float32-RNN_TANH] (which has
# failed now and then on that side, 1.44e-5 to 1.464e-5 against 1e-5),
# repeated in that process
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The runtime layer: the pinned staging pool on the three whole f64 calls,
# and the timer
# ---------------------------------------------------------------------------

from xsmm_tpu_torch.ops import packed_kernels as ppk  # noqa: E402
from xsmm_tpu_torch.ops import spgemm_kernels as psk  # noqa: E402
from xsmm_tpu_torch.ops.pack_util import pack_lanes  # noqa: E402
from xsmm_tpu_torch.utils import scratch  # noqa: E402
from xsmm_tpu_torch.utils.timer import cuda_time_ms, device_bench  # noqa: E402


def _pageable_batched(kern, a, b):
    """The parent's steps of a split2_fast call on pageable memory."""
    dev = torch.device("cuda", 0)
    a64, b64 = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    bh = b64.float()
    bl = (b64 - bh.double()).float()
    out = smm_packed.packed_split2_fast(kern.pack_a(a64.float()),
                                        kern.pack_b(bh), kern.pack_b(bl))
    return kern.unpack_c(out, a.shape[0]).double().cpu().numpy()


def _pageable_sparse(kern, b):
    dev = torch.device("cuda", 0)
    b64 = torch.from_numpy(b).to(dev)
    bh = b64.float()
    ch, cl = psk.unroll_f64(kern._operand(dev), bh, (b64 - bh.double()).float(),
                            c_lo=True)
    return (ch.double() + cl.double()).cpu().numpy()


def _pageable_getrf(a):
    dev = torch.device("cuda", 0)
    ad = torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    lu = ppk.getrf_unrolled(pack_lanes(ad))
    return lu.permute(2, 0, 1).contiguous().cpu().numpy().astype(np.float64)


def _whole_calls(seed):
    """(label, call, inputs, other inputs, pageable steps) of the three
    whole f64 calls at sizes above the staging threshold, several chunks
    for the batched call."""
    rng = np.random.default_rng(seed)
    xp.set_config(f64_strategy="split2_fast")
    bk = xp.dmmdispatch(23, 23, 23, batch=9000, beta=0.0)
    a, b = rng.standard_normal((2, 9000, 23, 23))
    op = np.where(rng.random((150, 150)) < 0.05,
                  rng.standard_normal((150, 150)), 0.0)
    sk = xp.create_dcsr_reg(op, 8192)
    bs = rng.standard_normal((150, 8192))
    gk = xp.getrf_dispatch(16, 16, dtype="float64", batch=16384)
    ga = rng.standard_normal((16384, 16, 16)) + 16 * np.eye(16)
    return [("batched", bk, (a, b), (-a, -b),
             lambda x: _pageable_batched(bk, *x)),
            ("sparse", sk, (bs,), (-bs,), lambda x: _pageable_sparse(sk, *x)),
            ("getrf", gk, (ga,), (ga * 0.5,),
             lambda x: _pageable_getrf(*x))]


@pytest.mark.parametrize("which", ["batched", "sparse", "getrf"])
def test_pool_whole_call_is_bit_identical_to_pageable(cuda, which):
    scratch.release_scratch()
    pool = scratch.get_staging_pool()
    label, call, inputs, _, pageable = next(
        c for c in _whole_calls(71) if c[0] == which)
    first = call(*inputs)
    n = pool.nmallocs
    assert n >= 1 and pool.pinned()
    again = call(*inputs)
    assert pool.nmallocs == n and pool.nreuse >= 1
    want = pageable(inputs)
    for got in (first, again):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), label


@pytest.mark.parametrize("which", ["batched", "sparse", "getrf"])
def test_pool_held_result_survives_later_calls(cuda, which):
    label, call, inputs, others, _ = next(
        c for c in _whole_calls(72) if c[0] == which)
    held = call(*inputs)
    keep = held.copy()
    for _ in range(3):
        nxt = call(*others)
        assert not np.shares_memory(nxt, held)
    assert np.array_equal(held, keep), label


@pytest.mark.parametrize("which", ["batched", "sparse", "getrf"])
def test_pool_inputs_overwritten_after_return_are_harmless(cuda, which):
    label, call, inputs, _, pageable = next(
        c for c in _whole_calls(73) if c[0] == which)
    want = pageable(inputs)
    mine = [x.copy() for x in inputs]
    got = call(*mine)
    for x in mine:
        x[...] = np.nan
    torch.cuda.synchronize()
    assert np.array_equal(got, want), label


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_to_host_leases_bounded_blocks_and_keeps_held_results(
        cuda, dtype):
    """Below the staging threshold, one chunk, a ragged tail and several
    chunks: the first two results of a key land in pinned blocks, a third
    while both are held comes back pageable through the ring, a block is
    reused once its array and every view of it are gone, and no result a
    caller holds is ever written again."""
    scratch.release_scratch()
    pool = scratch.get_staging_pool()
    step = scratch.CHUNK_BYTES // (torch.finfo(dtype).bits // 8)
    g = torch.Generator(device=cuda).manual_seed(75)
    sizes = (1000, step, 2 * step + 7, 5 * step + 1)
    for n in sizes:
        ts = [torch.randn(n, generator=g, device=cuda, dtype=dtype)
              for _ in range(5)]
        want = [t.cpu().numpy() for t in ts]
        held = [scratch.device_to_host(t) for t in ts[:3]]
        pinned = [torch.from_numpy(h).is_pinned() for h in held]
        assert pinned == ([False] * 3 if n == 1000 else [True, True, False])
        view = held[0][1:]
        del held[0]
        fourth = scratch.device_to_host(ts[3])   # the view keeps its block
        del view
        fifth = scratch.device_to_host(ts[4])    # now it is free
        assert torch.from_numpy(fifth).is_pinned() == (n != 1000)
        assert not torch.from_numpy(fourth).is_pinned()
        live = held + [fourth, fifth]
        for got, w in zip(live, want[1:]):
            assert got.dtype == w.dtype and np.array_equal(got, w)
        for x in range(len(live)):
            for y in range(x):
                assert not np.shares_memory(live[x], live[y])
        for buf in pool._bufs.values():
            assert not any(np.shares_memory(r, buf.numpy()) for r in live)
    assert pool.nresults == 2 * (len(sizes) - 1)
    assert pool.nresult_reuse == len(sizes) - 1


def test_device_bench_of_kernel1_agrees_with_cuda_events(cuda):
    g = torch.Generator(device=cuda).manual_seed(74)
    ah = torch.randn((23, 23, 131072), generator=g, device=cuda)
    bh = torch.randn((23, 23, 131072), generator=g, device=cuda)
    bl = bh * 1e-8
    dt, info = device_bench(smm_packed.packed_split2_fast, ah, bh, bl,
                            iters=40, base_iters=8, stats=True)
    ms = cuda_time_ms(smm_packed.packed_split2_fast, ah, bh, bl, warmup=3,
                      iters=20)
    assert set(info) == {"dts", "median", "spread", "iters", "repeats"}
    assert abs(dt * 1e3 / ms - 1) <= 0.10, (dt * 1e3, ms, info)


def test_device_bench_refuses_what_cannot_be_captured(cuda):
    """A function that synchronizes with the host cannot be captured:
    device_bench raises naming it.  Run in its own process, since a failed
    capture may leave the stream's allocator state behind."""
    import subprocess
    import sys
    code = ("import torch, pytest\n"
            "from xsmm_tpu_torch.utils.timer import device_bench\n"
            "def item_of_sum(t):\n    return t.sum().item()\n"
            "x = torch.ones(4, device='cuda')\n"
            "with pytest.raises(RuntimeError, match='item_of_sum.*cannot be "
            "captured'):\n    device_bench(item_of_sum, x)\n"
            "print('refused')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert res.returncode == 0 and "refused" in res.stdout, res.stderr


def test_rnn_tanh_cpu_forward_repeats_bit_identical(cuda):
    """The failing case's target="cpu" forward (RNN_TANH f32, N 37, C 50,
    K 70, T 4, seed 34), 300 times, each after the card's forward as in
    that test, against the first bit for bit; so are its two CPU products
    (x@W and h0@R).  A repeat that differs is named with the rows apart,
    its distance and the first's from the f64 gold, and the CPU state."""
    n, c, k, t = 37, 50, 70, 4
    rng = np.random.default_rng(34)
    x = rng.standard_normal((t, n, c)).astype(np.float32)
    w, r = ((rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((c, k), (k, k)))
    b = rng.standard_normal(k).astype(np.float32)
    h0, c0 = (rng.standard_normal((n, k)).astype(np.float32) * 0.1
              for _ in range(2))
    desc = RnnDesc(n=n, c=c, k=k, max_t=t, cell_type=CellType.RNN_TANH,
                   in_dtype="float32", out_dtype="float32")
    cells = {}
    for target in ("cuda", "cpu"):
        xp.set_config(target=target)
        cells[target] = create_rnncell(desc)
    gold = rnn_cell_gold(CellType.RNN_TANH, x, w, r, b, h0, c0)[0]
    xc, wc, rc, hc = (torch.from_numpy(v) for v in
                      (x.reshape(t * n, c), w, r, h0))

    def cpu_run():
        xp.set_config(target="cpu")
        return (cells["cpu"].forward(x, w, r, b, h0, c0)[0],
                _matmul(xc, wc), _matmul(hc, rc))

    first = cpu_run()
    state0 = (f"hs vs gold {_rel(first[0], torch.from_numpy(gold)):.3e}; "
              + cpu_products(x, w, r, h0))
    apart = []
    for rep in range(300):
        xp.set_config(target="cuda")
        cells["cuda"].forward(x, w, r, b, h0, c0)
        torch.cuda.synchronize()
        got = cpu_run()
        for name, v, v0 in zip(("hs", "x@W", "h0@R"), got, first):
            if torch.equal(v, v0):
                continue
            off = (v != v0).reshape(-1, v.shape[-1]).any(dim=1)
            msg = (f"repeat {rep} {name}: rows apart "
                   f"{torch.nonzero(off).flatten().tolist()[:16]} of "
                   f"{off.numel()}, max {(v - v0).abs().max().item():.3e}")
            if name == "hs":
                msg += (f"; vs gold: repeat {_rel(v, torch.from_numpy(gold)):.3e}"
                        f", first {_rel(v0, torch.from_numpy(gold)):.3e}")
            apart.append(msg + f"; {cpu_state()}")
    assert not apart, (f"{len(apart)} repeats apart (first call: {state0}):\n"
                       + "\n".join(apart[:20]))
    # and the first call itself within the card test's gates (1e-5 for hs,
    # as test_rnncell_card_equals_cpu, f32 rounding for the products)
    assert _rel(first[0], torch.from_numpy(gold)) <= 1e-5, state0
    for name, got, (a_, b_) in (("x@W", first[1], (x.reshape(t * n, c), w)),
                                ("h0@R", first[2], (h0, r))):
        want = torch.from_numpy(a_.astype(np.float64) @ b_.astype(np.float64))
        assert _rel(got, want) <= 1e-6, f"{name}: {state0}"


# ---------------------------------------------------------------------------
# The training framework (models/engine.py, utils/dataset.py): the CUDA-graph
# epoch against the eager loop, and the loaders feeding the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["lenet", "resnet18", "alexnet"])
def test_cuda_graph_epoch_equals_eager_loop(cuda, model):
    """Two epochs of ``train_epoch_scan`` (a warm-up step, the capture,
    replays) against ``train_epoch`` over the same generator's batches from
    the same state: the losses step by step, then every parameter, the
    momentum and the BN state (ResNet-18), with dropout drawn inside the
    graph (AlexNet), all bit for bit.  cuDNN runs its deterministic
    algorithms here, so that the graph and the eager loop run the same
    sums in the same order; on its default ones the weight gradients may
    differ from run to run (the smoke's step 34 measures that spread)."""
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, alexnet, lenet
    from xsmm_tpu_torch.models import resnet
    from xsmm_tpu_torch.models.engine import (template_batch_fn,
                                              tree_flatten_with_path)
    b = 16
    params, fwd, hw, ch = {
        "lenet": lambda: (*lenet(input_shape=(b, 28, 28, 1)), 28, 1),
        "resnet18": lambda: (*resnet(18, num_classes=10, width=8,
                                     input_shape=(b, 16, 16, 3)), 16, 3),
        "alexnet": lambda: (*alexnet(num_classes=10,
                                     input_shape=(b, 64, 64, 3)), 64, 3),
    }[model]()
    bf = template_batch_fn(b, hw=hw, classes=10, chans=ch)
    g_eng = MLEngine(params, fwd, SolverConfig(lr=0.002))
    e_eng = MLEngine(params, fwd, SolverConfig(lr=0.002), compiled=False)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            og = g_eng.train_epoch_scan(5, bf, b, verbose=False)
            gen = torch.Generator(device=cuda).manual_seed(
                e_eng.scan_seed(0))
            oe = e_eng.train_epoch((bf(gen) for _ in range(5)),
                                   verbose=False)
            assert og["losses"] == oe["losses"]
    finally:
        torch.backends.cudnn.deterministic = saved
    assert g_eng.step == e_eng.step == 10
    for tree in ("params", "momentum", "state"):
        if getattr(e_eng, tree) is None:
            continue
        for (k, a), (_, c) in zip(
                tree_flatten_with_path(getattr(g_eng, tree)),
                tree_flatten_with_path(getattr(e_eng, tree))):
            assert torch.equal(a, c), (tree, k)


@pytest.mark.parametrize("native", [True, False])
def test_loader_feeds_the_card(cuda, tmp_path, native):
    """Batches through pinned buffers to the card equal the host's, bit
    for bit, for both backends, over several epochs (the pinned buffers
    are reused only after their copies have landed)."""
    from xsmm_tpu_torch.utils.dataset import DataLoader, write_dataset
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (300, 12, 12, 3), dtype=np.uint8)
    path = str(tmp_path / "ds.xsd")
    write_dataset(path, imgs, rng.integers(0, 7, (300,)))
    host = list(DataLoader(path, batch=32, epochs=3, seed=5, native=native))
    card = DataLoader(path, batch=32, epochs=3, seed=5, native=native,
                      device=cuda)
    assert card.backend == ("native" if native else "python")
    got = []
    for x, y in card:
        assert x.device.type == "cuda" and y.device.type == "cuda"
        x.mul_(0)   # the consumer overwrites its batch: the host's stays
        got.append((x, y))
    assert len(got) == len(host) == 27
    for (x, y), (hx, hy) in zip(list(DataLoader(path, batch=32, epochs=3,
                                                 seed=5, native=native,
                                                 device=cuda)), host):
        assert torch.equal(x.cpu(), torch.from_numpy(hx))
        assert torch.equal(y.cpu(), torch.from_numpy(hy))



# ---------------------------------------------------------------------------
# The distributed layer: virtual ranks on cuda:0, each with its own streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,schedule", [("float32", None),
                                            ("float64", "split2"),
                                            ("float64", "fold")])
def test_ring_block_kernels_equal_plain(cuda, dtype, schedule):
    """``ring_spmm_csr`` over 2 and 4 virtual ranks, chunks 2: the result
    against f64 gold, each block kernel of the ring against its plain
    version on the ring's own panels, bit for bit, and the launches
    counted (step 0 on kernel 5 or 6, the others on 7 or 8)."""
    from xsmm_tpu_torch.ops import spgemm_kernels as sk
    from xsmm_tpu_torch.parallel import dist_spmm
    from xsmm_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(7)
    a = np.where(rng.random((70, 90)) < 0.1,
                 rng.standard_normal((70, 90)), 0.0)
    n = 4096
    for d in (2, 4):
        mesh = make_mesh((1, d), devices=[cuda] * d)
        k = -(-90 // d) * d
        b = torch.zeros((k, n), dtype=torch.float64, device=cuda)
        b[:90] = torch.randn((90, n), dtype=torch.float64, device=cuda,
                             generator=torch.Generator(cuda).manual_seed(d))
        bh = b.float()
        streams = [bh, (b - bh.double()).float()] if schedule == "split2" \
            else [bh]
        sk.reset_launches()
        fn = dist_spmm.ring_spmm_csr(
            mesh, a.astype(np.float32) if schedule is None else a, n,
            dtype=dtype, chunks=2, f64_schedule=schedule or "split2")
        out = fn(*[dist_spmm.shard_rows(mesh, s) for s in streams])
        out = out if isinstance(out, tuple) else (out,)
        c = sum(o.gather().double() for o in out)[:70]
        torch.cuda.synchronize()
        gold = torch.from_numpy(a).to(cuda) @ b[:90]
        err = ((c - gold).norm() / gold.norm()).item()
        assert err < (1e-3 if schedule is None else 1e-5), err
        kind = "f32" if schedule is None else "f64"
        assert sk.launches[f"spgemm_unroll_{kind}"] >= 1
        assert sk.launches[f"spgemm_acc_{kind}"] >= 1
        for e in range(d):
            for j in range(d):
                kern = fn.kernels[e][j]
                if kern is None:
                    continue
                o = kern._operand(cuda)
                panels = [s[j * (k // d):(j + 1) * (k // d), :kern.n]
                          .contiguous() for s in streams]
                cin = torch.randn((o.m, kern.n), device=cuda)
                if schedule is None:
                    _same(sk.unroll_f32(o, *panels),
                          sk.unroll_f32_plain(o, *panels))
                    _same(sk.acc_f32(o, cin, *panels),
                          sk.acc_f32_plain(o, cin, *panels))
                    continue
                c_lo = schedule == "split2"
                cl = cin * 1e-8 if c_lo else None
                for got, want in (
                        (sk.unroll_f64(o, *panels, c_lo=c_lo),
                         sk.unroll_f64_plain(o, *panels, c_lo=c_lo)),
                        (sk.acc_f64(o, cin, cl, *panels),
                         sk.acc_f64_plain(o, cin, cl, *panels))):
                    for g_, w_ in zip(got if c_lo else (got,),
                                      want if c_lo else (want,)):
                        _same(g_, w_)


def test_ring_stream_event_order(cuda, tmp_path):
    """The ring's hops wait on their sub-panel's compute (no hop hoisted),
    (d - 1) x chunks hops a rank, read back from a profiler trace."""
    from xsmm_tpu_torch.parallel import schedule_check
    st = schedule_check.check_ring(d=4, chunks=4, n=16384,
                                   trace_path=str(tmp_path / "ring.json"))
    assert st["hops_ok"] and st["order_ok"], st
    assert st["device_events"] > 0


def test_dp_engine_equals_single_device_on_card(cuda):
    """MLEngine over 2 virtual ranks on cuda:0 against the single-device
    engine on the card: one step of tests/test_torch_engine.py's ResNet-18
    on the same batch (the loss to 1e-5, each update to 1e-3, the BN state
    to 1e-4), the replicas equal.
    On cuDNN's deterministic algorithms: on its default ones the weight
    gradients differ from run to run (the smoke's step 38 prints both)."""
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, resnet
    from xsmm_tpu_torch.models.engine import (template_batches,
                                              tree_flatten_with_path)
    from xsmm_tpu_torch.parallel.mesh import make_mesh
    params, fwd = resnet(depth=18, num_classes=10, width=8,
                         input_shape=(8, 16, 16, 3))
    p0 = [t.detach().clone() for _, t in
          tree_flatten_with_path({"layers": params["layers"]})]
    batch = next(template_batches(1, 8, hw=16))
    engs = [MLEngine(params, fwd, SolverConfig(lr=0.05), mesh=m)
            for m in (None, make_mesh((2, 1), devices=[cuda] * 2))]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        losses = [e.train_epoch(iter([batch]), verbose=False)["loss"]
                  for e in engs]
    finally:
        torch.backends.cudnn.deterministic = saved
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for (k, a), (_, b), c in zip(tree_flatten_with_path(engs[0].params),
                                 tree_flatten_with_path(engs[1].params),
                                 p0):
        ua, ub = (a - c).double(), (b - c).double()
        assert ((ua - ub).norm() / ua.norm()).item() <= 1e-3, k
    for (k, a), (_, b) in zip(tree_flatten_with_path(engs[0].state),
                              tree_flatten_with_path(engs[1].state)):
        assert (a - b).abs().max().item() <= 1e-4, k
    for a, b in zip(engs[1]._rep_leaves[0], engs[1]._rep_leaves[1]):
        assert torch.equal(a, b)


def test_cuda_graph_epoch_over_a_mesh_equals_eager_loop(cuda):
    """``train_epoch_scan`` over 2 virtual ranks on cuda:0 (one CUDA graph
    holding both ranks' steps, the batch split inside it) against the mesh
    engine's ``train_epoch`` over the same generator's batches: the losses
    step by step and every replica bit for bit (cuDNN's deterministic
    algorithms, as test_cuda_graph_epoch_equals_eager_loop)."""
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, resnet
    from xsmm_tpu_torch.models.engine import (template_batch_fn,
                                              tree_flatten_with_path)
    from xsmm_tpu_torch.parallel.mesh import make_mesh
    b = 16
    params, fwd = resnet(18, num_classes=10, width=8,
                         input_shape=(b, 16, 16, 3))
    bf = template_batch_fn(b, hw=16, classes=10)
    engs = [MLEngine(params, fwd, SolverConfig(lr=0.002),
                     mesh=make_mesh((2, 1), devices=[cuda] * 2),
                     compiled=c) for c in (None, False)]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            og = engs[0].train_epoch_scan(4, bf, b, verbose=False)
            gen = torch.Generator(device=cuda).manual_seed(
                engs[1].scan_seed(0))
            oe = engs[1].train_epoch((bf(gen) for _ in range(4)),
                                     verbose=False)
            assert og["losses"] == oe["losses"]
    finally:
        torch.backends.cudnn.deterministic = saved
    for ra, rb in zip(engs[0]._rep_params, engs[1]._rep_params):
        for (k, a), (_, c) in zip(tree_flatten_with_path(ra),
                                  tree_flatten_with_path(rb)):
            assert torch.equal(a, c), k


# ---------------------------------------------------------------------------
# The compiled form (utils/graphs.py): the builders' callables and the
# engine's steps as CUDA graphs, against their eager forms
# ---------------------------------------------------------------------------


def _ring_streams(cuda, d, k, n, schedule, seed=0):
    """The ring's B streams over d ranks: f32, or the f64 schedule's."""
    from xsmm_tpu_torch.parallel import dist_spmm
    from xsmm_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((1, d), devices=[cuda] * d)
    kp = -(-k // d) * d
    b = torch.zeros((kp, n), dtype=torch.float64, device=cuda)
    b[:k] = torch.randn((k, n), dtype=torch.float64, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(seed))
    bh = b.float()
    streams = ([bh, (b - bh.double()).float()] if schedule == "split2"
               else [bh])
    return mesh, [dist_spmm.shard_rows(mesh, s) for s in streams]


def _gathered(out):
    out = out if isinstance(out, tuple) else (out,)
    return tuple(o.gather() for o in out)


def _same_results(got, want):
    return all(torch.equal(a, b) for a, b in zip(_gathered(got),
                                                 _gathered(want)))


@pytest.mark.parametrize("dtype,schedule", [("float32", None),
                                            ("float64", "split2"),
                                            ("float64", "fold")])
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("chunks", [1, 4])
def test_compiled_ring_equals_eager(cuda, dtype, schedule, d, chunks):
    """``ring_spmm_csr``'s default callable runs as a CUDA graph (the
    capture's warm-up, a replay copying the caller's shards in, a replay
    reading the graph's own) and each result is the ``compiled=False``
    call's, bit for bit."""
    from xsmm_tpu_torch.parallel import dist_spmm
    rng = np.random.default_rng(5)
    a = np.where(rng.random((70, 90)) < 0.1, rng.standard_normal((70, 90)),
                 0.0)
    n = 8192
    mesh, bs = _ring_streams(cuda, d, 90, n, schedule)
    op = a.astype(np.float32) if schedule is None else a
    kw = dict(dtype=dtype, chunks=chunks, f64_schedule=schedule or "split2")
    fn = dist_spmm.ring_spmm_csr(mesh, op, n, **kw)
    ref = dist_spmm.ring_spmm_csr(mesh, op, n, compiled=False, **kw)
    want = ref(*bs)
    dist_spmm.reset_counts()
    got = [fn(*bs), fn(*bs), fn(*fn.entry(*bs).args)]
    torch.cuda.synchronize()
    assert dist_spmm.forms == {"graph": 1, "graph_copy": 1, "eager": 0,
                               "captures": 1}
    for g in got:
        assert _same_results(g, want)


def _dense_builders(cuda, rng):
    """The other four builders on 4 ranks of one card: (name, build(**kw),
    args)."""
    from xsmm_tpu_torch.parallel import dist_spmm
    from xsmm_tpu_torch.parallel.mesh import (NamedSharding, P, device_put,
                                              make_mesh)
    mesh = make_mesh((4, 1), ("dp", "mp"), devices=[cuda] * 4)
    row = make_mesh((1, 4), ("dp", "mp"), devices=[cuda] * 4)
    lanes = NamedSharding(mesh, P(None, None, "dp"))
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32))
    kern = xp.smmdispatch(23, 23, 23, batch=4096, beta=0.0)
    pa, pb = (device_put(kern.pack_a(torch.from_numpy(
        rng.standard_normal((4096, 23, 23)).astype(np.float32)).to(cuda)),
        lanes), device_put(kern.pack_b(torch.from_numpy(
            rng.standard_normal((4096, 23, 23)).astype(np.float32)).to(cuda)),
            lanes))
    m = 16
    lu = xp.getrf_dispatch(m, m, batch=4096)
    tr = xp.trsm_dispatch(m, m, batch=4096)
    ap = torch.randn((m, m, 4096), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(3)) + \
        m * torch.eye(m, device=cuda)[:, :, None]
    low, rhs = torch.tril(ap.permute(2, 0, 1)).permute(1, 2, 0), \
        torch.randn((m, m, 4096), device=cuda)
    sa, sl, sr = (device_put(t.contiguous(), lanes) for t in (ap, low, rhs))
    return [
        ("ring_spmm", lambda **kw: dist_spmm.ring_spmm(row, **kw),
         (dist_spmm.shard_rows(row, a.to(cuda)),
          dist_spmm.shard_rows(row, b[:64].to(cuda)))),
        ("col_sharded_spmm", lambda **kw: dist_spmm.col_sharded_spmm(
            row, **kw), (a.to(cuda), dist_spmm.shard_cols(row, b.to(cuda)))),
        ("dp_batched_smm", lambda **kw: dist_spmm.dp_batched_smm(
            mesh, kern, **kw), (pa, pb)),
        ("dp_packed getrf", lambda **kw: dist_spmm.dp_packed(
            mesh, lu.packed, 1, **kw), (sa,)),
        ("dp_packed trsm", lambda **kw: dist_spmm.dp_packed(
            mesh, tr.packed, 2, **kw), (sl, sr)),
    ]


def test_compiled_builders_equal_eager(cuda):
    """The dense ring, the column-sharded product and the dp wrappers:
    each default callable runs as a graph, bit for bit the eager form."""
    from xsmm_tpu_torch.parallel import dist_spmm
    for name, build, args in _dense_builders(cuda, np.random.default_rng(2)):
        fn, ref = build(), build(compiled=False)
        want = ref(*args)
        dist_spmm.reset_counts()
        got = [fn(*args), fn(*args), fn(*fn.entry(*args).args)]
        torch.cuda.synchronize()
        assert dist_spmm.forms == {"graph": 1, "graph_copy": 1, "eager": 0,
                                   "captures": 1}, name
        for g in got:
            assert _same_results(g, want), name


def test_compiled_ring_inputs_results_and_keys(cuda):
    """New values written into the graph's own inputs reach the next
    replay; a fresh input tensor takes the copy path; two successive
    results both stay intact; a new shape captures anew and the 9th key
    evicts the first."""
    from xsmm_tpu_torch.parallel import dist_spmm
    rng = np.random.default_rng(6)
    a = np.where(rng.random((60, 64)) < 0.2, rng.standard_normal((60, 64)),
                 0.0).astype(np.float32)
    n = 4096
    mesh, (b1,) = _ring_streams(cuda, 4, 64, n, None, seed=1)
    _, (b2,) = _ring_streams(cuda, 4, 64, n, None, seed=2)
    fn = dist_spmm.ring_spmm_csr(mesh, a, n, chunks=4)
    ref = dist_spmm.ring_spmm_csr(mesh, a, n, chunks=4, compiled=False)
    r1 = fn(b1)
    own, = fn.entry(b1).args
    for t, src in zip(own.shards, b2.shards):
        t.copy_(src)
    dist_spmm.reset_counts()
    r2 = fn(own)                        # the new values, read in place
    r3 = fn(b1)                         # a fresh tensor: copied in
    torch.cuda.synchronize()
    assert dist_spmm.forms["graph"] == 1 and \
        dist_spmm.forms["graph_copy"] == 1
    assert _same_results(r2, ref(b2))
    assert _same_results(r3, ref(b1))
    assert _same_results(r1, ref(b1))   # earlier results stay intact
    assert not _same_results(r1, r2)
    dense = dist_spmm.ring_spmm(mesh)
    x = torch.randn((64, 64), device=cuda)
    ys = [torch.randn((64, w), device=cuda) for w in range(1, 10)]
    for y in ys:
        dense(dist_spmm.shard_rows(mesh, x), dist_spmm.shard_rows(mesh, y))
    assert len(dense.cache) == 8 and dense.cache.evictions == 1
    assert dense.entry(dist_spmm.shard_rows(mesh, x),
                       dist_spmm.shard_rows(mesh, ys[0])) is None
    assert dense.entry(dist_spmm.shard_rows(mesh, x),
                       dist_spmm.shard_rows(mesh, ys[-1])) is not None


def test_compiled_ring_counts_every_replay(cuda):
    """The hop, launch and route counters count each replay: k compiled
    calls count k times one eager call."""
    from xsmm_tpu_torch.ops import spgemm_kernels as sk
    from xsmm_tpu_torch.parallel import dist_spmm
    rng = np.random.default_rng(8)
    a = np.where(rng.random((70, 90)) < 0.1, rng.standard_normal((70, 90)),
                 0.0)
    mesh, bs = _ring_streams(cuda, 4, 90, 4096, "split2")
    kw = dict(dtype="float64", chunks=4)
    ref = dist_spmm.ring_spmm_csr(mesh, a, 4096, compiled=False, **kw)
    fn = dist_spmm.ring_spmm_csr(mesh, a, 4096, **kw)
    ref(*bs)
    sk.reset_launches()
    dist_spmm.reset_counts()
    ref(*bs)
    one = (dict(sk.launches), dict(sk.route_launches), dict(dist_spmm.hops))
    assert one[2]["device"] == 4 * 3 * 4 * 2
    sk.reset_launches()
    dist_spmm.reset_counts()
    for _ in range(3):
        fn(*bs)
    torch.cuda.synchronize()
    for got, want in zip((sk.launches, sk.route_launches, dist_spmm.hops),
                         one):
        assert got == {k: 3 * v for k, v in want.items()}


def test_compiled_capture_failure_raises(cuda, monkeypatch):
    """A capture that fails raises with the reason; nothing runs eagerly
    in its place, no graph is kept, and the next call captures."""
    from xsmm_tpu_torch.parallel import dist_spmm
    rng = np.random.default_rng(9)
    a = np.where(rng.random((32, 32)) < 0.3, rng.standard_normal((32, 32)),
                 0.0).astype(np.float32)
    mesh, (b,) = _ring_streams(cuda, 2, 32, 1024, None)
    fn = dist_spmm.ring_spmm_csr(mesh, a, 1024)
    begin = dist_spmm._begin

    def planted(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("planted capture fault")
        return begin(*args)
    monkeypatch.setattr(dist_spmm, "_begin", planted)
    dist_spmm.reset_counts()
    with pytest.raises(RuntimeError, match="could not be captured.*planted"):
        fn(b)
    assert len(fn.cache) == 0 and dist_spmm.forms["captures"] == 0
    monkeypatch.setattr(dist_spmm, "_begin", begin)
    want = dist_spmm.ring_spmm_csr(mesh, a, 1024, compiled=False)(b)
    fn(b)
    assert _same_results(fn(b), want)
    assert dist_spmm.forms["captures"] == 1 and \
        dist_spmm.forms["graph_copy"] == 1


def _engine_case(model, dp, cuda, compiled):
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, lenet, resnet
    from xsmm_tpu_torch.parallel.mesh import make_mesh
    b = 16
    params, fwd, hw, ch = {
        "lenet": lambda: (*lenet(input_shape=(b, 28, 28, 1)), 28, 1),
        "resnet18": lambda: (*resnet(18, num_classes=10, width=8,
                                     input_shape=(b, 16, 16, 3)), 16, 3),
    }[model]()
    mesh = None if dp == 1 else make_mesh((dp, 1), devices=[cuda] * dp)
    return (MLEngine(params, fwd, SolverConfig(lr=0.01), mesh=mesh,
                     compiled=compiled), b, hw, ch)


@pytest.mark.parametrize("model", ["lenet", "resnet18"])
@pytest.mark.parametrize("dp", [1, 2])
def test_compiled_train_epoch_and_validate_equal_eager(cuda, model, dp):
    """``train_epoch`` and ``validate`` as CUDA graphs (the default on the
    card) against their eager forms over 3 steps from one state on host
    batches: on cuDNN's deterministic algorithms the losses, parameters,
    momentum, BN state and metrics bit for bit; on its default ones the
    losses within 1e-3 relative (chip_smoke's step-34 limit for LeNet, 10x
    the eager loop's own spread)."""
    from xsmm_tpu_torch.models.engine import (template_batches,
                                              tree_flatten_with_path)
    saved = torch.backends.cudnn.deterministic
    for deterministic in (True, False):
        engs = [_engine_case(model, dp, cuda, c) for c in (None, False)]
        b, hw, ch = engs[0][1:]
        engs = [e[0] for e in engs]
        assert engs[0].compiled and not engs[1].compiled
        data = list(template_batches(5, b, hw=hw, classes=10, chans=ch))
        torch.backends.cudnn.deterministic = deterministic
        try:
            outs = [e.train_epoch(iter(data[:3]), verbose=False)
                    for e in engs]
            vals = [e.validate(iter(data[3:])) for e in engs]
        finally:
            torch.backends.cudnn.deterministic = saved
        assert engs[0].forms == {"graph": 0, "graph_copy": 3, "eager": 0,
                                 "captures": 2}
        if not deterministic:
            for g, w in zip(outs[0]["losses"], outs[1]["losses"]):
                assert abs(g - w) <= 1e-3 * abs(w)
            continue
        assert outs[0]["losses"] == outs[1]["losses"]
        assert vals[0] == vals[1]
        for tree in ("params", "momentum", "state"):
            if getattr(engs[1], tree) is None:
                continue
            for (k, x), (_, y) in zip(
                    tree_flatten_with_path(getattr(engs[0], tree)),
                    tree_flatten_with_path(getattr(engs[1], tree))):
                assert torch.equal(x, y), (tree, k)


def test_resnet50_compiled_bf16_step_meets_the_cells_limits(cuda):
    """ResNet-50 v1.5 at its published width in bf16 through
    ``MLEngine.train_step`` in the card's default form (the step's CUDA
    graph) as the benchmark cell runs it: batch 256 at 224 x 224, the
    traffic's set-up steps and the harness's three warm-up steps (the
    first the eager warm-up and capture), then three replays, each
    against the plain reference's f32 step from the state
    before it (``reference_torch/resnet50.py``, run once the engine is
    freed), by the cell's own numbers (``step_numbers`` of its driver: the
    loss, and the step's own term of the update over every leaf and over
    the classifier's) under its limits
    (``portbench/limits/resnet50_train.bf16_b256.json``)."""
    import gc
    import json
    from pathlib import Path

    from portbench.drivers.resnet_train import step_numbers
    from reference_torch import resnet50 as ref
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, resnet
    from xsmm_tpu_torch.models.engine import tree_map

    bench = Path(__file__).resolve().parents[1] / "portbench"
    limits = {k: v["limit"] for k, v in json.loads(
        (bench / "limits" / "resnet50_train.bf16_b256.json").read_text()
    )["numbers"].items()}
    pretrain = json.loads((bench / "traffic" / "bf16_b256.json").read_text()
                          )["pretrain_steps"]
    n, hw = 256, 224
    gc.collect()
    torch.cuda.empty_cache()
    params, fwd = resnet(depth=50, num_classes=1000, width=64, seed=11,
                         input_shape=(n, hw, hw, 3), dtype="bfloat16")
    eng = MLEngine(params, fwd, SolverConfig(lr=0.1, momentum=0.9,
                                             weight_decay=1e-4))
    del params
    assert eng.compiled
    g = torch.Generator(device=cuda).manual_seed(12)

    def named(tree):
        return ref.from_engine(tree_map(lambda t: t.detach().clone(),
                                        tree)["layers"])

    sets = [(torch.randn((n, hw, hw, 3), generator=g, device=cuda),
             torch.randint(0, 1000, (n,), generator=g, device=cuda))
            for _ in range(3)]      # cycled, as the cell's operand sets
    warm, steps = pretrain + 3, []  # set-up's and run.py's warm-up steps
    for i in range(warm + 3):
        x, y = sets[i % 3]
        p0, m0 = named(eng.params), named(eng.momentum)
        loss = eng.train_step(x, y)
        assert loss.device.type == "cuda" and loss.dim() == 0
        if i >= warm:
            steps.append((x, y, p0, m0, named(eng.params),
                          named(eng.momentum), loss))
    assert eng.forms == {"graph": 0, "graph_copy": warm + 2, "eager": 0,
                         "captures": 1}
    del eng, fwd
    gc.collect()
    torch.cuda.empty_cache()

    for x, y, p0, m0, p1, m1, loss in steps:
        st = ref.train_step(p0, m0, x, y)
        got = step_numbers(loss, p0, m0, p1, m1, st, 0.1, 0.9)
        del st
        assert set(got) == set(limits)
        for k, v in got.items():
            assert v <= limits[k], (k, v, limits[k])
