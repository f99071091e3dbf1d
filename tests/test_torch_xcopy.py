"""xsmm_tpu_torch's matcopy/otrans/itrans against xsmm_tpu's and numpy.

Each test of ``tests/test_xcopy.py`` has a counterpart here that feeds the
same numpy inputs (seeded) to both packages: the JAX package runs its
Pallas kernels in interpret mode (``tests/conftest.py``), the port runs with
``target="cpu"``, i.e. through the kernels' plain PyTorch versions.  Copies
and transposes move bits, so every comparison is exact.

Both packages route alike: the copy (transpose) kernel runs for exactly the
calls on which the JAX package takes its Pallas copy (transpose).  The route
tests count both sides: the JAX package's ``pallas_call`` while tracing, the
port's kernel wrappers.
"""

import dataclasses
import functools
import math

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.core import descriptors as jd
from xsmm_tpu.core.registry import get_registry as jget_registry
from xsmm_tpu.ops import xcopy as jx
from xsmm_tpu_torch.core import descriptors as pd
from xsmm_tpu_torch.core.registry import get_registry
from xsmm_tpu_torch.ops import xcopy as px
from xsmm_tpu_torch.ops import xcopy_kernels as xk


@pytest.fixture(autouse=True)
def cpu_target():
    saved_p = dataclasses.asdict(xp.get_config())
    saved_j = dataclasses.asdict(xt.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved_p)
    xt.set_config(**saved_j)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the port's kernel wrappers called by the frontends (on the
    CPU they run the plain versions and count no launch)."""
    counts = {"copy": 0, "trans": 0}
    for name in counts:
        fn = getattr(xk, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(xk, name, counted)
    return counts


def both_equal(x, op, want):
    """``op`` of both packages on the same numpy ``x``: each equals
    ``want`` bit for bit; the port's result is a new contiguous tensor."""
    ref = np.asarray(getattr(jx, op)(x))
    port = getattr(xp, op)(x)
    assert isinstance(port, torch.Tensor) and port.is_contiguous()
    assert np.array_equal(ref, want)
    assert np.array_equal(port.numpy(), want)
    return port


# ---------------------------------------------------------------------------
# The counterparts of tests/test_xcopy.py
# ---------------------------------------------------------------------------


def test_matcopy_2d(rng, kernel_calls):
    x = rng.standard_normal((64, 128)).astype(np.float32)
    both_equal(x, "matcopy", x)
    assert kernel_calls["copy"] == 0  # rows < 512: the clone route


def test_matcopy_large_aligned(rng, kernel_calls):
    x = rng.standard_normal((1024, 256)).astype(np.float32)
    both_equal(x, "matcopy", x)
    assert kernel_calls["copy"] == 1


def test_matcopy_odd_shape(rng, kernel_calls):
    x = rng.standard_normal((23, 37)).astype(np.float32)
    both_equal(x, "matcopy", x)
    assert kernel_calls["copy"] == 0


def test_matcopy_batched(rng):
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    both_equal(x, "matcopy", x)


def test_matcopy_zero(rng):
    x = rng.standard_normal((8, 16)).astype(np.float32)
    z = xp.matcopy(x, zero=True)
    ref = np.asarray(jx.matcopy(x, zero=True))
    assert tuple(z.shape) == ref.shape == (8, 16)
    assert not z.any() and z.dtype == torch.float32


def test_otrans_2d(rng, kernel_calls):
    x = rng.standard_normal((48, 96)).astype(np.float32)
    both_equal(x, "otrans", x.T)
    assert kernel_calls["trans"] == 0


def test_otrans_tiled_path(rng, kernel_calls):
    # below the 512x512 kernel gate -> the transpose-and-copy route
    x = rng.standard_normal((512, 256)).astype(np.float32)
    both_equal(x, "otrans", x.T)
    assert kernel_calls["trans"] == 0


def test_otrans_pallas_divisible(rng, kernel_calls):
    # both dims >= 512, exact multiples -> the transpose kernel
    x = rng.standard_normal((1024, 512)).astype(np.float32)
    both_equal(x, "otrans", x.T)
    assert kernel_calls["trans"] == 1


def test_otrans_pallas_ragged(rng, kernel_calls):
    # both dims >= 512 and NON-divisible -> the kernel, edges masked
    x = rng.standard_normal((520, 516)).astype(np.float32)
    both_equal(x, "otrans", x.T)
    assert kernel_calls["trans"] == 1


def test_otrans_batched(rng, kernel_calls):
    x = rng.standard_normal((3, 17, 29)).astype(np.float32)
    both_equal(x, "otrans", np.swapaxes(x, -1, -2))
    assert kernel_calls["trans"] == 0


def test_itrans(rng):
    x = rng.standard_normal((31, 15)).astype(np.float32)
    both_equal(x, "itrans", x.T)


def test_dispatch_cached():
    k1 = xp.trans_dispatch(8, 8)
    k2 = xp.trans_dispatch(8, 8)
    assert k1 is k2


def test_matcopy_wide_rows_fallback(rng, kernel_calls):
    """Rows too wide to tile under the JAX package's block cap take the
    clone route in both packages."""
    x = rng.standard_normal((8, 1 << 17)).astype(np.float32)  # 512KB rows
    both_equal(x, "matcopy", x)
    assert kernel_calls["copy"] == 0


# ---------------------------------------------------------------------------
# Routing: the kernels run exactly where the JAX package's Pallas kernels do
# ---------------------------------------------------------------------------


def _jax_uses_pallas(monkeypatch, kernel, shape, dtype):
    """Trace the JAX kernel on an abstract input; True if it reached
    pallas_call."""
    hits = []
    real = jx.pallas_call

    def counted(*a, **k):
        hits.append(1)
        return real(*a, **k)
    monkeypatch.setattr(jx, "pallas_call", counted)
    jax.eval_shape(kernel, jax.ShapeDtypeStruct(shape, dtype))
    monkeypatch.setattr(jx, "pallas_call", real)
    return bool(hits)


COPY_ROUTES = [((512, 128), "float32"), ((520, 128), "float32"),
               ((1024, 256), "float32"), ((8192, 8192), "float32"),
               ((8192, 8192), "bfloat16"), ((16, 1024, 4096), "float32"),
               ((8, 1 << 17), "float32"), ((4096, 1 << 15), "float32"),
               ((4096, 1 << 14), "float32"), ((4096, 1 << 14), "int8"),
               ((600, 256), "float32"), ((511, 128), "float32"),
               ((512, 100), "float32"), ((4, 16, 32), "float32"),
               ((4, 256, 128), "float32"), ((3, 176, 128), "float32"),
               ((1000, 128), "int32"), ((2048, 1 << 13), "float32")]


@pytest.mark.parametrize("shape,dtype", COPY_ROUTES)
def test_copy_route_matches(monkeypatch, shape, dtype):
    m, n = shape[-2:]
    desc = jd.MatcopyDescriptor(m=m, n=n, dtype=dtype)
    ref = _jax_uses_pallas(monkeypatch, jx.MatcopyKernel(desc)._fn, shape,
                           jax.numpy.dtype(dtype))
    rows = m * math.prod(shape[:-2])
    assert px._kernel_route(rows, n, pd.ITEMSIZE[dtype]) == ref


TRANS_ROUTES = [(512, 512), (511, 4096), (4096, 511), (8448, 8320),
                (3, 600, 600), (512, 256), (1, 1)]


@pytest.mark.parametrize("shape", TRANS_ROUTES)
def test_trans_route_matches(monkeypatch, kernel_calls, shape):
    m, n = shape[-2:]
    desc = jd.TransDescriptor(m=m, n=n)
    ref = _jax_uses_pallas(monkeypatch, jx.TransKernel(desc)._fn, shape,
                           np.float32)
    xp.otrans(np.zeros(shape, np.float32))
    assert kernel_calls["trans"] == int(ref)


@pytest.mark.parametrize("shape", [(1024, 256), (64, 128), (4, 256, 128)])
def test_copy_route_calls_match(rng, kernel_calls, monkeypatch, shape):
    m, n = shape[-2:]
    x = rng.standard_normal(shape).astype(np.float32)
    ref = _jax_uses_pallas(monkeypatch, jx.MatcopyKernel(
        jd.MatcopyDescriptor(m=m, n=n))._fn, shape, np.float32)
    both_equal(x, "matcopy", x)
    assert kernel_calls["copy"] == int(ref)


# ---------------------------------------------------------------------------
# Beyond the JAX tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["matcopy", "otrans"])
@pytest.mark.parametrize("m,n,zero", [(8, 9, False), (512, 600, False),
                                      (8, 9, True)])
def test_descriptor_bytes_match(op, m, n, zero):
    x = np.zeros((2, m, n), np.float32)
    if op == "matcopy":
        kp = xp.matcopy_dispatch(m, n, zero_source=zero, batch=2)
        kj = jx.matcopy_dispatch(m, n, zero_source=zero, batch=2)
        name = f"mcopy_{m}x{n}"
    else:
        kp, kj = xp.trans_dispatch(m, n, batch=2), jx.trans_dispatch(m, n,
                                                                     batch=2)
        name = f"trans_{m}x{n}"
    key = next(k for k, e in get_registry()._table.items() if e.kernel is kp)
    assert key == next(k for k, e in jget_registry()._table.items()
                       if e.kernel is kj)
    assert get_registry()._table[key].name == name
    assert getattr(xp, op)(x).shape[-2:] == ((m, n) if op == "matcopy"
                                             else (n, m))


@pytest.mark.parametrize("dtype", [np.int8, np.int32, ml_dtypes.bfloat16,
                                   np.float16])
def test_other_dtypes_bit_exact(rng, dtype):
    x = (rng.standard_normal((520, 640)) * 50).astype(dtype)
    for op, want in (("matcopy", x), ("otrans", x.T)):
        port = getattr(xp, op)(x)
        assert port.dtype == pd.TORCH_DTYPES[np.dtype(dtype).name]
        got = port.view(torch.uint16).numpy().view(dtype) \
            if dtype is ml_dtypes.bfloat16 else port.numpy()
        want = np.ascontiguousarray(want)
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        assert np.array_equal(np.asarray(getattr(jx, op)(x)), want)


def test_f64_stays_f64(rng):
    """f64 is copied and transposed as f64 (the JAX package, without x64,
    returns f32; ROADMAP Queue 3)."""
    x = rng.standard_normal((600, 512))
    assert np.array_equal(xp.matcopy(x).numpy(), x)
    assert np.array_equal(xp.otrans(x).numpy(), x.T)


def test_tensor_inputs_give_new_tensors():
    x = torch.arange(600 * 520, dtype=torch.float32).reshape(600, 520)
    for op in ("matcopy", "otrans", "itrans"):
        y = getattr(xp, op)(x)
        assert y.data_ptr() != x.data_ptr() and y.is_contiguous()
    view = x.t()  # a non-contiguous input
    assert torch.equal(xp.matcopy(view), view)
    assert torch.equal(xp.otrans(view), x)


def test_kernels_check_shape():
    k = xp.trans_dispatch(8, 8)
    with pytest.raises(ValueError, match="8, 8"):
        k(np.zeros((8, 9), np.float32))
    with pytest.raises(ValueError, match="8, 8"):
        xp.matcopy_dispatch(8, 8)(np.zeros((9, 8), np.float32))


def test_wrappers_check_operands():
    with pytest.raises(ValueError, match="contiguous"):
        xk.copy(torch.ones((4, 6)).t())
    with pytest.raises(ValueError, match="2-D"):
        xk.trans(torch.ones((2, 4, 6)))
    with pytest.raises(ValueError, match="byte elements"):
        xk.trans(torch.ones((4, 6), dtype=torch.complex128))
    with pytest.raises(TypeError):
        xk.copy(np.ones(4))
    xk.reset_launches()
    xk.copy(torch.ones(4))
    xk.trans(torch.ones((4, 6)))
    assert xk.launches == {"xcopy_copy": 0, "xcopy_trans": 0}


def test_no_card_raises(monkeypatch):
    """With the target unset and no card, matcopy and otrans raise; they
    never run the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp.set_config(target="")
    x = np.ones((600, 600), np.float32)
    for call in (functools.partial(xp.matcopy, x), functools.partial(
            xp.otrans, x), functools.partial(xp.itrans, x),
            functools.partial(xp.matcopy, x, zero=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
