"""Element block-Jacobi on the port's packed f32 path, on the CPU: getrf's
packed LU, then the unit-lower solve and the upper solve on that same LU
(``TrsmKernel.packed`` with uplo "L" and "U"), against the plain f64
reference ``reference_torch/block_jacobi.py``; and the upper variant of
kernels 13 and 14 (``packed_kernels``, ``upper=True``) against the plain
versions, bit for bit.

On the CPU the kernel wrappers run their plain versions, which the card's
kernels equal bit for bit (``tests/test_torch_gpu.py``).  The port solves
in f32 from f32 blocks and the reference in f64 from the same blocks
widened exactly; the blocks are strictly row diagonally dominant (the
benchmark's recipe), so the solves are well conditioned and the port's
error is f32 rounding grown over ~n terms: 2e-5 relative a solve (the
readings lie at 1e-7 to 3.2e-7), where factors rounded to bf16 read 2e-3.
"""

import ast
import math
from pathlib import Path

import pytest
import torch

import xsmm_tpu_torch as xp
from reference_torch import block_jacobi as ref
from xsmm_tpu_torch.ops import packed_kernels as pk
from xsmm_tpu_torch.ops.pack_util import pack_lanes

REPO = Path(__file__).resolve().parents[1]
TOL = 2e-5
F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _cpu():
    xp.set_config(target="cpu")
    yield
    xp.set_config(target="")


def _blocks(n, b, seed):
    """[n, n, b] f32, packed: N(0, 1)/sqrt(n) off the diagonal, each row's
    off-diagonal absolute sum times 1 + U(0.1, 1) on it."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((n, n, b), generator=g) / math.sqrt(n)
    idx = torch.arange(n)
    a[idx, idx] = 0.0
    a[idx, idx] = a.abs().sum(1) * (1.1 + 0.9 * torch.rand((n, b),
                                                            generator=g))
    return a


def _rhs(n, cols, b, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, cols, b), generator=g)


def _natural(p):
    """Packed [n, c, b] -> batch first [b, n, c]."""
    return p.permute(2, 0, 1)


def _rel_max(got, want):
    """The worst problem's relative error (got packed, want batch first)."""
    err = torch.linalg.vector_norm(_natural(got).to(F64) - want, dim=(1, 2))
    return float((err / torch.linalg.vector_norm(want, dim=(1, 2))).max())


SIZES = [12, 65, 125]   # kernels 11 and 13 (<= 64), then 12 and 14


@pytest.mark.parametrize("cols", [1, 3])
@pytest.mark.parametrize("b", [32, 160])
@pytest.mark.parametrize("n", SIZES)
def test_packed_lu_then_l_then_u_against_the_reference(n, b, cols):
    a, r = _blocks(n, b, 7 * n + b), _rhs(n, cols, b, 11 * n + cols)
    getrf = xp.getrf_dispatch(n, n, batch=b)
    lower = xp.trsm_dispatch(n, cols, uplo="L", diag="U", batch=b)
    upper = xp.trsm_dispatch(n, cols, uplo="U", diag="N", batch=b)
    want_kernels = ("unrolled" if n <= 64 else "loop")
    assert lower.kernel_name == upper.kernel_name == "trsm_" + want_kernels
    lu = getrf.packed(a)
    y = lower.packed(lu, r)
    x = upper.packed(lu, y)
    f = ref.lu(_natural(a))
    # the factors, each solve on the port's own input, the whole apply
    assert _rel_max(lu, f) <= TOL
    assert _rel_max(y, ref.forward_unit(_natural(lu), _natural(r))) <= TOL
    assert _rel_max(x, ref.backward(_natural(lu), _natural(y))) <= TOL
    assert _rel_max(x, ref.block_jacobi(_natural(a), _natural(r))) <= TOL


def test_bf16_factors_read_above_the_tolerance():
    """The tolerance is tight enough to catch factors kept in bf16, the
    precision below the configuration's f32."""
    n, b = 125, 32
    a, r = _blocks(n, b, 3), _rhs(n, 1, b, 4)
    lu = xp.getrf_dispatch(n, n, batch=b).packed(a)
    lu = lu.to(torch.bfloat16).to(F32)
    y = xp.trsm_dispatch(n, 1, uplo="L", diag="U", batch=b).packed(lu, r)
    x = xp.trsm_dispatch(n, 1, uplo="U", batch=b).packed(lu, y)
    assert _rel_max(x, ref.block_jacobi(_natural(a), _natural(r))) > 20 * TOL


UPPER_SHAPES = [(1, 1), (5, 3), (16, 1), (40, 7), (65, 1), (125, 2)]


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("sm,sn", UPPER_SHAPES)
@pytest.mark.parametrize("kernel", ["trsm_unrolled", "trsm_loop"])
def test_upper_variant_is_the_flipped_lower_solve_bit_for_bit(kernel, sm, sn,
                                                              unit):
    """The upper variant's plain version (and so its kernel) gives the bits
    of the lower one on flipped copies: the arithmetic of ``__call__``'s
    flip route, read in place; the wrapper on the CPU is the plain version
    and counts no launch."""
    a = _blocks(sm, 33, sm + sn) / (sm if unit else 1)
    b = _rhs(sm, sn, 33, sn)
    flipped = getattr(pk, kernel + "_plain")(a.flip((0, 1)), b.flip(0),
                                             unit).flip(0)
    plain = getattr(pk, kernel + "_upper_plain")(a, b, unit)
    assert torch.equal(plain, flipped)
    before = dict(pk.launches)
    assert torch.equal(getattr(pk, kernel)(a, b, unit, upper=True), plain)
    assert pk.launches == before
    # only triu(A) is read: the strict lower triangle may hold anything
    noisy = a + torch.tril(torch.full((sm, sm), float("nan")), -1)[..., None]
    assert torch.equal(getattr(pk, kernel + "_upper_plain")(noisy, b, unit),
                       plain)


@pytest.mark.parametrize("n,cols", [(12, 3), (125, 1)])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_packed_upper_is_call_upper_bit_for_bit(n, cols, diag):
    """``packed`` on an upper descriptor gives the bits of ``__call__`` on
    the same data in the batch-first layout, with no copy made by the
    frontend."""
    a = _blocks(n, 24, n) / (n if diag == "U" else 1)
    b = _rhs(n, cols, 24, n + 1)
    kern = xp.trsm_dispatch(n, cols, uplo="U", diag=diag, batch=24)
    got = kern.packed(a, b)
    assert torch.equal(_natural(got), kern(_natural(a), _natural(b)))


@pytest.mark.parametrize("diag", ["N", "U"])
@pytest.mark.parametrize("side,uplo,transa", [
    (s, u, t) for s in "LR" for u in "LU" for t in "NT"])
@pytest.mark.parametrize("sm", [9, 70])   # kernel 13, then kernel 14
def test_call_runs_the_upper_variant_with_the_flip_routes_bits(
        monkeypatch, sm, side, uplo, transa, diag):
    """``__call__`` reduces every descriptor to a left solve by transposes
    alone and runs the kernel's upper variant where that solve is upper:
    one kernel call, with the bits of the lower kernel on flipped copies of
    A and B (the route that copied them before the upper variant)."""
    b, other = 12, 4
    m, n = (sm, other) if side == "L" else (other, sm)
    unit = diag == "U"
    a = _natural(_blocks(sm, b, sm + 3)) / (sm if unit else 1)
    rhs = _natural(_rhs(m, n, b, 7))
    kern = xp.trsm_dispatch(m, n, side=side, uplo=uplo, transa=transa,
                            diag=diag, batch=b)
    real, seen = getattr(pk, kern.kernel_name), []

    def spy(*args, upper=False):
        seen.append(upper)
        return real(*args, upper=upper)

    monkeypatch.setattr(pk, kern.kernel_name, spy)
    got = kern(a, rhs)
    transposed = (side == "R") != (transa == "T")
    upper = (uplo == "U") != transposed
    a_eff = a.transpose(-1, -2) if transposed else a
    b_eff = rhs.transpose(-1, -2) if side == "R" else rhs
    if upper:
        a_eff, b_eff = a_eff.flip((-1, -2)), b_eff.flip(-2)
    x = getattr(pk, kern.kernel_name + "_plain")(
        pack_lanes(a_eff), pack_lanes(b_eff), unit).permute(2, 0, 1)
    if upper:
        x = x.flip(-2)
    if side == "R":
        x = x.transpose(-1, -2)
    assert seen == [upper]
    assert torch.equal(got, x)


@pytest.mark.parametrize("side,uplo,transa", [
    ("R", "L", "N"), ("R", "U", "N"), ("L", "L", "T"), ("L", "U", "T"),
    ("R", "U", "T")])
def test_packed_refuses_right_and_transposed_descriptors(side, uplo, transa):
    kern = xp.trsm_dispatch(8, 8, side=side, uplo=uplo, transa=transa,
                            batch=4)
    with pytest.raises(ValueError, match="left untransposed"):
        kern.packed(_blocks(8, 4, 1), _rhs(8, 8, 4, 2))


def test_reference_against_a_library_solve():
    g = torch.Generator().manual_seed(5)
    a = _natural(_blocks(20, 9, 6)).to(F64)
    r = torch.randn((9, 20, 4), generator=g, dtype=F64)
    f = ref.lu(a)
    low = torch.tril(f, -1) + torch.eye(20, dtype=F64)
    assert torch.allclose(low @ torch.triu(f), a, rtol=0, atol=1e-13)
    want = torch.linalg.solve(a, r)
    assert torch.allclose(ref.block_jacobi(a, r), want, rtol=0, atol=1e-12)
    assert ref.block_jacobi(a.float(), r.float()).dtype == F64


def test_references_import_torch_alone_and_the_benchmark_keeps_a_copy():
    ours = REPO / "reference_torch" / "block_jacobi.py"
    copy = REPO / "portbench" / "reference" / "lu.py"
    assert ours.read_bytes() == copy.read_bytes()
    tree = ast.parse(ours.read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in (node.names if isinstance(node, ast.Import)
                       else [ast.alias(node.module or "")])}
    assert names == {"__future__", "contextlib", "torch"}


def test_profile_stamps_fit_the_packed_kernels():
    """kernel_profile's phase stamps find each of their anchors once in
    ops/csrc/packed.cu: the shared trsm's (in the solve that both variants
    run) and the tile getrf's."""
    from xsmm_tpu_torch.ops import kernel_profile as kp

    src = (REPO / "xsmm_tpu_torch" / "ops" / "csrc" / "packed.cu").read_text()
    for stamps in (kp._TRSM_STAMPS, kp._GETRF_STAMPS):
        prof = kp.instrument(src, stamps)
        assert prof.count("PROF_BEGIN") >= 1 and "PROF_END(0)" in prof
