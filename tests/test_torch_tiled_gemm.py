"""xsmm_tpu_torch's tiled GEMM against xsmm_tpu's and against f64 gold.

Each test of ``tests/test_tiled_gemm.py`` has a counterpart here that feeds
the same numpy inputs (seeded) to both packages: the JAX package runs its
Pallas kernel in interpret mode (``tests/conftest.py``), the port runs with
``target="cpu"``, i.e. through the kernel's plain PyTorch version.

Stated tolerances (rel-Frobenius):
* port vs JAX, f32 and bf16 -> f32: 1e-5 (XLA's CPU dot and torch's sum
  the K panels in different orders);
* port vs JAX, bf16 -> bf16: 1e-2 (one output rounding apart);
* c0 accumulate: 1e-5;
* against gold: the JAX tests' own gates (1e-3, bf16 inputs 1e-2).
"""

import dataclasses
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.core import descriptors as jd
from xsmm_tpu.core.registry import get_registry as jget_registry
from xsmm_tpu.ops import tiled_gemm as jtg
from xsmm_tpu_torch.core import descriptors as pd
from xsmm_tpu_torch.core.registry import get_registry
from xsmm_tpu_torch.ops import tiled_gemm as ptg
from xsmm_tpu_torch.ops import tiled_gemm_kernels as tk

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


def agree(ref, port, gold_c, tol_gold, tol_pair=PORT_VS_JAX, what=""):
    r, p = np64(ref), np64(port)
    assert r.shape == p.shape == gold_c.shape
    xp.check(r, p, tol_pair, what=f"port vs JAX {what}")
    xp.check(gold_c, p, tol_gold, what=f"port vs gold {what}")


def _pair(rng, m, n, k):
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# The counterparts of tests/test_tiled_gemm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k", [(256, 256, 256), (384, 128, 256),
                                   (200, 100, 50), (1, 1, 1), (129, 257, 65)])
def test_shapes(rng, m, n, k):
    a, b = _pair(rng, m, n, k)
    h = xp.TiledGemm(m, n, k)
    c = h(a, b)
    assert tuple(c.shape) == (m, n) and c.dtype == torch.float32
    agree(jtg.TiledGemm(m, n, k)(a, b), c, gold(a, b), 1e-3,
          what=f"tiled {m}x{n}x{k}")


def test_c0_accumulate(rng):
    m = n = k = 128
    a, b = _pair(rng, m, n, k)
    c0 = rng.standard_normal((m, n)).astype(np.float32)
    agree(jtg.TiledGemm(m, n, k)(a, b, c0), xp.TiledGemm(m, n, k)(a, b, c0),
          gold(a, b) + c0, 1e-3, what="c0")


def test_bf16(rng):
    m = n = k = 256
    a, b = _pair(rng, m, n, k)
    h = xp.TiledGemm(m, n, k, in_dtype="bfloat16", out_dtype="float32")
    c = h(a, b)
    assert c.dtype == torch.float32
    ab = a.astype(ml_dtypes.bfloat16).astype(np.float64)
    bb = b.astype(ml_dtypes.bfloat16).astype(np.float64)
    ref = jtg.TiledGemm(m, n, k, in_dtype=jnp.bfloat16,
                        out_dtype=jnp.float32)(a, b)
    agree(ref, c, gold(ab, bb), 1e-2, what="bf16 tiled")


def test_tile_plan_env_override():
    for pkg in (xt, xp):
        pkg.set_config(tgemm_m=128, tgemm_n=256, tgemm_k=128)
    h = xp.TiledGemm(512, 512, 512)
    assert (h.bm, h.bn, h.bk) == (128, 256, 128)
    r = jtg.TiledGemm(512, 512, 512)
    assert (r.bm, r.bn, r.bk) == (h.bm, h.bn, h.bk)


def test_handle_cached():
    h1 = xp.gemm_handle(64, 64, 64)
    h2 = xp.gemm_handle(64, 64, 64)
    assert h1 is h2


def test_xgemm_convenience(rng):
    a, b = _pair(rng, 96, 80, 64)
    agree(jtg.xgemm(a, b), xp.xgemm(a, b), gold(a, b), 1e-3, what="xgemm")


# ---------------------------------------------------------------------------
# Beyond the JAX tests: dtypes, plan, registry key, plain version, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k", [(256, 256, 256), (129, 257, 65)])
def test_bf16_out(rng, m, n, k):
    a, b = _pair(rng, m, n, k)
    c = xp.TiledGemm(m, n, k, in_dtype="bfloat16")(a, b)
    assert c.dtype == torch.bfloat16
    ref = jtg.TiledGemm(m, n, k, in_dtype=jnp.bfloat16)(a, b)
    ab = a.astype(ml_dtypes.bfloat16).astype(np.float64)
    bb = b.astype(ml_dtypes.bfloat16).astype(np.float64)
    agree(ref, c, gold(ab, bb), 1e-2, tol_pair=1e-2, what="bf16 -> bf16")


def test_bf16_out_c0_added_after_the_cast(rng):
    """c0 is added in bf16, after the product is rounded to bf16."""
    a, b = _pair(rng, 128, 64, 96)
    c0 = rng.standard_normal((128, 64)).astype(np.float32)
    c = xp.TiledGemm(128, 64, 96, in_dtype="bfloat16")(a, b, c0)
    ref = jtg.TiledGemm(128, 64, 96, in_dtype=jnp.bfloat16)(a, b, c0)
    xp.check(np64(ref), np64(c), 1e-2)
    prod = xp.TiledGemm(128, 64, 96, in_dtype="bfloat16")(a, b)
    assert torch.equal(c, prod + torch.from_numpy(c0).to(torch.bfloat16))


def test_f16_in_f32_out(rng):
    a, b = _pair(rng, 64, 48, 200)
    c = xp.TiledGemm(64, 48, 200, in_dtype="float16",
                     out_dtype="float32")(a, b)
    ref = jtg.TiledGemm(64, 48, 200, in_dtype=jnp.float16,
                        out_dtype=jnp.float32)(a, b)
    agree(ref, c, gold(a.astype(np.float16), b.astype(np.float16)), 1e-5,
          what="f16 -> f32")


def test_mixed_xgemm_casts_b_to_a(rng):
    a, b = _pair(rng, 40, 30, 20)
    b64 = b.astype(np.float64)
    c = xp.xgemm(a, b64)
    assert c.dtype == torch.float32
    agree(jtg.xgemm(a, b64), c, gold(a, b), 1e-3, what="f32 @ f64")


PLAN_SHAPES = [(1, 1, 1), (128, 128, 128), (129, 257, 65), (2560, 64, 2560),
               (1760, 128, 1760), (4096, 4096, 4096), (4095, 4097, 1000),
               (8192, 8192, 8192), (3000, 100, 700)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("override", [(0, 0, 0), (128, 256, 128),
                                      (2048, 2048, 2048)])
def test_plan_tiles_matches(itemsize, override):
    tm, tn, tkk = override
    for pkg in (xt, xp):
        pkg.set_config(tgemm_m=tm, tgemm_n=tn, tgemm_k=tkk)
    for shape in PLAN_SHAPES:
        assert (ptg._plan_tiles(*shape, itemsize)
                == jtg._plan_tiles(*shape, itemsize)), shape


def _key_of(reg, kernel):
    return next(k for k, e in reg._table.items() if e.kernel is kernel)


@pytest.mark.parametrize("in_dt,out_dt,beta", [
    ("float32", None, 0.0), ("bfloat16", "float32", 0.0),
    ("bfloat16", None, 1.0), ("float16", "bfloat16", 1.0)])
def test_handle_descriptor_bytes_match(in_dt, out_dt, beta):
    hp = xp.gemm_handle(33, 44, 55, in_dtype=in_dt, out_dtype=out_dt,
                        beta=beta)
    hj = jtg.gemm_handle(33, 44, 55, in_dtype=in_dt, out_dtype=out_dt,
                         beta=beta)
    key = _key_of(get_registry(), hp)
    assert key == _key_of(jget_registry(), hj)
    assert key == pd.GemmDescriptor(
        m=33, n=44, k=55, in_dtype=in_dt, out_dtype=out_dt or in_dt,
        flags=pd.gemm_flags(beta=beta), batch=0).pack()
    assert xp.get_kernel_info(pd.GemmDescriptor(
        m=33, n=44, k=55, in_dtype=in_dt, out_dtype=out_dt or in_dt,
        flags=jd.gemm_flags(beta=beta), batch=0))["name"] == "tgemm_33x44x55"


def test_xgemm_keys_beta_by_c0(rng):
    a, b = _pair(rng, 20, 20, 20)
    c0 = np.zeros((20, 20), np.float32)
    assert xp.xgemm(a, b).shape == xp.xgemm(a, b, c0).shape
    for beta in (0.0, 1.0):
        assert xp.get_kernel_info(pd.GemmDescriptor(
            m=20, n=20, k=20, flags=pd.gemm_flags(beta=beta), batch=0))


@pytest.mark.parametrize("bk", [1, 7, 64, 1000])
def test_plain_version_panels(rng, bk):
    """The plain version's K panels change only the order of the f32
    sum."""
    a, b = _pair(rng, 30, 40, 150)
    got = tk.gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                        out_dtype=torch.float32, bk=bk)
    xp.check(gold(a, b), got.numpy(), 1e-6)


def test_plain_version_zero_k():
    a, b = torch.ones((3, 0)), torch.ones((0, 4))
    assert torch.equal(tk.gemm(a, b, out_dtype=torch.float32),
                       torch.zeros((3, 4)))


def test_cpu_wrapper_counts_no_launch(rng):
    tk.reset_launches()
    a, b = _pair(rng, 8, 8, 8)
    xp.xgemm(a, b)
    assert tk.launches == {"tiled_gemm": 0}


def test_wrapper_checks_operands():
    a = torch.ones((4, 5))
    with pytest.raises(ValueError, match="inner dims"):
        tk.gemm(a, torch.ones((4, 5)), out_dtype=torch.float32)
    with pytest.raises(ValueError, match="takes"):
        tk.gemm(a, torch.ones((5, 3), dtype=torch.bfloat16),
                out_dtype=torch.float32)
    with pytest.raises(ValueError, match="takes"):
        tk.gemm(a.double(), torch.ones((5, 3), dtype=torch.float64),
                out_dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        tk.gemm(torch.ones((5, 4)).t(), torch.ones((5, 3)),
                out_dtype=torch.float32)
    with pytest.raises(ValueError, match="2-D"):
        tk.gemm(torch.ones((2, 4, 5)), torch.ones((5, 3)),
                out_dtype=torch.float32)
    with pytest.raises(TypeError):
        tk.gemm(np.ones((4, 5), np.float32), torch.ones((5, 3)),
                out_dtype=torch.float32)


def test_handle_checks_shapes(rng):
    a, b = _pair(rng, 8, 8, 8)
    with pytest.raises(ValueError, match="8x8x8"):
        xp.TiledGemm(8, 8, 8)(a[:, :4], b[:4])
    with pytest.raises(ValueError, match="mismatch"):
        xp.xgemm(a, b[:4])


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8", "float64"])
def test_unsupported_dtypes_raise(dtype):
    """The kernel takes f32, bf16 and f16.  The JAX package computes the
    integer types in their own dtype (uint8 wraps) and raises for f64
    without x64; the port raises ValueError for all of them (ROADMAP
    Queue 3)."""
    with pytest.raises(ValueError, match="tiled GEMM takes"):
        xp.TiledGemm(8, 8, 8, in_dtype=dtype)
    with pytest.raises(ValueError, match="tiled GEMM takes"):
        xp.TiledGemm(8, 8, 8, in_dtype="float32", out_dtype=dtype)


def test_no_card_raises(monkeypatch, rng):
    """With the target unset and no card, xgemm raises; it never runs the
    plain version on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp.set_config(target="")
    a, b = _pair(rng, 8, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.xgemm(a, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.gemm_handle(8, 8, 8)(a, b)


# ---------------------------------------------------------------------------
# Kernel 4's routes: which kernel a CUDA call takes, and the refusal of the
# TMA route (the kernels run on the card only; these check the choice)
# ---------------------------------------------------------------------------


def _operands(case):
    """(A, B) of one alignment class."""
    bf16 = torch.bfloat16
    if case == "aligned":
        return torch.ones((64, 40), dtype=bf16), torch.ones((40, 24),
                                                            dtype=bf16)
    if case == "unaligned-K":    # A's rows are 42 bytes
        return torch.ones((64, 21), dtype=bf16), torch.ones((21, 24),
                                                            dtype=bf16)
    if case == "unaligned-N":    # B's rows are 34 bytes
        return torch.ones((64, 40), dtype=bf16), torch.ones((40, 17),
                                                            dtype=bf16)
    if case == "offset-view":    # A starts 2 bytes past a 16-byte boundary
        base = torch.ones(64 * 40 + 1, dtype=bf16)
        return base[1:].view(64, 40), torch.ones((40, 24), dtype=bf16)
    if case == "zero-K":
        return torch.ones((64, 0), dtype=bf16), torch.ones((0, 24), dtype=bf16)
    if case == "f16":
        return (torch.ones((64, 40), dtype=torch.float16),
                torch.ones((40, 24), dtype=torch.float16))
    return torch.ones((64, 40)), torch.ones((40, 24))   # f32


@pytest.mark.parametrize("case,want", [
    ("aligned", "tma"), ("f16", "tma"), ("unaligned-K", "mma"),
    ("unaligned-N", "mma"), ("offset-view", "mma"), ("zero-K", "mma"),
    ("f32", "simt")])
def test_pick_route(case, want):
    a, b = _operands(case)
    assert a.is_contiguous() and b.is_contiguous()
    assert tk.pick_route(a, b) == want


def test_unknown_route_raises():
    a, b = _operands("aligned")
    with pytest.raises(ValueError, match="route 'wgmma'"):
        tk.gemm(a, b, out_dtype=torch.float32, route="wgmma")


class _FakeLib:
    """The C entry points of ops/csrc/tiled_gemm.cu, recording calls; the
    kernel refuses the TMA route for unaligned operands with -2."""

    def __init__(self):
        self.calls = []

    def xsmm_tiled_gemm_splits(self, m, n, k, route, device):
        return 1

    def xsmm_tiled_gemm(self, *args):
        self.calls.append(args)
        a, b, m, n, k, route = args[0], args[1], args[4], args[5], args[6], \
            args[10]
        aligned = not ((a | b) % 16 or k % 8 or n % 8) and k > 0
        return -2 if route == tk.ROUTES["tma"] and not aligned else 0


@pytest.mark.parametrize("case", ["unaligned-K", "unaligned-N",
                                  "offset-view"])
def test_tma_route_refusal_raises(monkeypatch, case):
    """A TMA route asked for operands TMA cannot address: the kernel's -2
    (nothing launched) reaches the caller as ValueError and counts no
    launch; the route the wrapper picks for them launches."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    lib = _FakeLib()
    monkeypatch.setattr(tk, "_lib", lambda: lib)
    dev = torch.device("cuda", 0)
    a, b = _operands(case)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=torch.bfloat16)
    tk.reset_launches()
    with pytest.raises(ValueError, match="16 bytes"):
        tk._launch(a, b, c, "tma", dev)
    assert tk.launches == {"tiled_gemm": 0}
    assert tk.route_launches == {"simt": 0, "mma": 0, "tma": 0}
    tk._launch(a, b, c, tk.pick_route(a, b), dev)
    assert lib.calls[-1][10] == tk.ROUTES["mma"]
    assert lib.calls[-1][-2:] == (0, 0)  # device index, stream
    assert tk.launches == {"tiled_gemm": 1}
    assert tk.route_launches == {"simt": 0, "mma": 1, "tma": 0}
