"""Card-only tests: each packed CUDA kernel against its plain version.

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
