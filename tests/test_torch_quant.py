"""xsmm_tpu_torch's DFP16 quantization (dnn/quant) against xsmm_tpu's and
numpy gold: the cases of ``tests/test_quant.py``, on the CPU target.

Tolerances: q and scf bit-exact against the JAX package in NO_ROUND,
NEAREST, BIAS and FPHW (every step is exact: a power-of-two scale, floor,
comparisons); dequantize bit-exact.  STOCH draws from a torch.Generator,
whose bits are not JAX's, so it is held to its distribution: the mean of
the round trip within 0.02e-4 of x (``tests/test_quant.py:60``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import xsmm_tpu_torch as xp
from xsmm_tpu.dnn import quant as jq
from xsmm_tpu_torch.dnn import (RoundMode, dequantize, quantize, quantize_act,
                                quantize_fil)

MODES = ["NO_ROUND", "NEAREST", "BIAS", "FPHW"]


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _gold_scf(x, add_shift=0):
    # scf = 14 - add_shift - (max_exp - 127), libxsmm_dnn.c:2576
    max_exp = np.frexp(np.abs(x).max())[1] + 126  # biased exponent
    return 14 - add_shift - (max_exp - 127)


def test_scf_matches_reference_formula(rng):
    for scale in (1.0, 0.37, 129.0, 1e-3):
        x = (rng.standard_normal((64, 64)) * scale).astype(np.float32)
        q, scf = quantize(x)
        assert q.dtype == torch.int16 and scf.dtype == torch.uint8
        assert int(scf) == _gold_scf(x), (scale, int(scf), _gold_scf(x))
        assert 2 ** 13 <= int(q.abs().max()) < 2 ** 15


def test_nearest_matches_numpy_gold(rng):
    x = (rng.standard_normal((33, 17)) * 3.0).astype(np.float32)
    q, scf = quantize(x, round_mode=RoundMode.NEAREST)
    s = np.float32(2.0 ** int(scf))
    gold = np.sign(x) * np.floor(np.abs(x.astype(np.float64) * s) + 0.5)
    assert np.array_equal(q.double().numpy(), gold)


def test_no_round_truncates(rng):
    x = (rng.standard_normal((64,)) * 2.0).astype(np.float32)
    q, scf = quantize(x, round_mode=RoundMode.NO_ROUND)
    s = 2.0 ** int(scf)
    gold = np.sign(x) * np.floor(np.abs(x.astype(np.float64)) * s)
    assert np.array_equal(q.double().numpy(), gold)


def test_roundtrip_error_bound(rng):
    x = (rng.standard_normal((128, 128)) * 0.5).astype(np.float32)
    for mode in (RoundMode.NEAREST, RoundMode.FPHW, RoundMode.BIAS):
        q, scf = quantize(x, round_mode=mode)
        back = dequantize(q, scf).numpy()
        step = 2.0 ** -int(scf)
        assert np.abs(back - x).max() <= step + 1e-12, mode


def test_stochastic_rounding_unbiased():
    x = np.full((2048,), 0.3e-4, np.float32)
    g = torch.Generator().manual_seed(0)
    q, scf = quantize(x, round_mode=RoundMode.STOCH, key=g)
    back = dequantize(q, scf).numpy()
    assert abs(back.mean() - 0.3e-4) < 0.02e-4
    # each value rounds to one of its two neighbours
    step = 2.0 ** -int(scf)
    lo = np.floor(0.3e-4 / step) * step
    assert set(np.unique(back)) <= {np.float32(lo), np.float32(lo + step)}
    with pytest.raises(ValueError, match="key"):
        quantize(x, round_mode=RoundMode.STOCH)


def test_add_shift(rng):
    x = rng.standard_normal((64,)).astype(np.float32)
    q0, scf0 = quantize(x, add_shift=0)
    q2, scf2 = quantize(x, add_shift=2)
    assert int(scf0) - int(scf2) == 2
    assert int(q2.abs().max()) < 2 ** 13  # headroom for sums


def test_quantize_feeds_wimm(rng):
    """q(a) @ q(b) on the port's wimm path, dequantized with scf_a+scf_b,
    matches the f32 product to DFP16 accuracy."""
    B, M, N, K = 8, 16, 16, 16
    a = (rng.standard_normal((B, M, K)) * 0.7).astype(np.float32)
    b = (rng.standard_normal((B, K, N)) * 1.3).astype(np.float32)
    qa, scf_a = quantize_act(a)
    qb, scf_b = quantize_fil(b)
    kern = xp.wimmdispatch(M, N, K, batch=B, beta=0.0)
    c_i32 = kern(qa.numpy(), qb.numpy())
    c = np.asarray(c_i32, np.float64) * 2.0 ** -(int(scf_a) + int(scf_b))
    gold = np.matmul(a.astype(np.float64), b.astype(np.float64))
    assert np.linalg.norm(c - gold) / np.linalg.norm(gold) < 1e-3


def test_quantize_zero_tensor():
    q, scf = quantize(np.zeros((8, 8), np.float32))
    assert (q == 0).all()
    assert torch.isfinite(dequantize(q, scf)).all()


def test_quantize_large_magnitude_saturates(rng):
    x = (rng.standard_normal((64,)) * 1e6).astype(np.float32)
    q, scf = quantize(x)
    assert int(scf) == 0
    back = dequantize(q, scf).numpy()
    gold = np.clip(np.sign(x) * np.floor(np.abs(x.astype(np.float64)) + 0.5),
                   -32768, 32767)
    assert np.array_equal(back, gold)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("add_shift", [0, 2])
@pytest.mark.parametrize("fn", ["quantize", "quantize_act", "quantize_fil"])
def test_bit_exact_against_jax(rng, mode, add_shift, fn):
    """Ties on the rounding cuts (fractions 0.25, 0.5, 0.75 after scaling),
    both signs, zeros and a saturating tensor, bit for bit."""
    x = (rng.standard_normal((64, 48)) * 3).astype(np.float32)
    _, scf = quantize(x)
    step = np.float32(2.0 ** -int(scf))
    x[:4] = (np.round(x[:4] / step) + rng.choice([0.25, 0.5, 0.75],
                                                 x[:4].shape)) * step
    x[4, :8] = 0.0
    x[4, 8:16] = -x[5, 8:16]
    port = {"quantize": quantize, "quantize_act": quantize_act,
            "quantize_fil": quantize_fil}[fn]
    jfn = getattr(jq, fn)
    for arr in (x, x * 1e5):
        q, scf = port(arr, add_shift, RoundMode[mode])
        jq_, jscf = jfn(arr, add_shift, jq.RoundMode[mode])
        assert np.array_equal(q.numpy(), np.asarray(jq_)), mode
        assert int(scf) == int(jscf)
        assert np.array_equal(dequantize(q, scf).numpy(),
                              np.asarray(jq.dequantize(jq_, jscf)))


def test_round_mode_values_match():
    assert {m.name: int(m) for m in RoundMode} == \
        {m.name: int(m) for m in jq.RoundMode}


def test_stoch_distribution_matches_jax():
    """STOCH rounds up with probability frac in both packages: the share of
    values rounded up agrees within sampling noise (n = 20000)."""
    x = np.full((20000,), 1.0, np.float32)
    x[1:] = 1.0 + 0.3 * 2.0 ** -14   # fraction 0.3 below the cut
    q, _ = quantize(x, round_mode=RoundMode.STOCH,
                    key=torch.Generator().manual_seed(3))
    jq_, _ = jq.quantize(x, round_mode=jq.RoundMode.STOCH,
                         key=jax.random.PRNGKey(3))
    up_port = float((q.numpy()[1:] > 16384).mean())
    up_jax = float((np.asarray(jq_)[1:] > 16384).mean())
    assert abs(up_port - 0.3) < 0.02 and abs(up_jax - 0.3) < 0.02
