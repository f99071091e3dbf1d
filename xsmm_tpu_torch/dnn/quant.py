"""DFP16 quantization utilities: f32 -> i16 with a shared scale factor.
The port of ``xsmm_tpu/dnn/quant.py``.

Reference: libxsmm_dnn_quantize / _act / _fil / dequantize
(include/libxsmm_dnn.h:416-419, impl src/libxsmm_dnn.c:2440-2824) — the
producers for the i16 wimm/wsmm GEMM paths.  Semantics (dynamic fixed
point, DFP16): the tensor's max exponent picks one power-of-two scale

    scf = 14 - add_shift - (max_exp - 127)       (libxsmm_dnn.c:2576)

so the largest magnitude maps to ~2^14 and every element is
q = round_mode(x * 2^scf) stored as int16; dequantize is x = q * 2^-scf
(libxsmm_dnn.c:2813).  Rounding modes (libxsmm_dnn.h:353-357):

  NO_ROUND  - truncate the magnitude toward zero (mantissa chop)
  NEAREST   - round magnitude to nearest (guard bit)
  BIAS      - round magnitude up when either of the two guard bits is set
  STOCH     - stochastic rounding (IBM 2015), needs a generator
  FPHW      - FP-multiply path: q = roundf(x*2^scf), half away from zero

scf is a uint8 in the reference ABI; a tensor with max|x| >= 2^14 would
need a negative one, so scf is clamped at 0 and such values saturate at the
i16 range, as in the JAX package.  Where JAX takes a PRNG key, STOCH takes
a ``torch.Generator`` (on the tensor's device) as ``key``, and raises
without one.  The two draw different bits from one seed, so STOCH is held
to its distribution, not to JAX's values.  The _act/_fil variants are the
same per-tensor quantization (the reference's blocked relayouts have no
counterpart here).
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from .operands import device_of, on


class RoundMode(enum.IntEnum):
    """libxsmm_dnn.h:353-357 constants (values kept for parity)."""

    NO_ROUND = 80000
    BIAS = 80001
    STOCH = 80002
    NEAREST = 80003
    FPHW = 80004


def _max_exp(x: torch.Tensor) -> torch.Tensor:
    """Biased exponent of the largest |x| (0 for an all-zero tensor)."""
    bits = x.abs().max().reshape(1).view(torch.int32)
    return (bits >> 23) & 0xFF


def quantize(x, add_shift: int = 0,
             round_mode: RoundMode = RoundMode.NEAREST,
             key: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """libxsmm_dnn_quantize analog: returns (i16 tensor, uint8 scf)."""
    if round_mode == RoundMode.STOCH and key is None:
        raise ValueError("STOCH rounding requires a PRNG key (a "
                         "torch.Generator)")
    x = on(x, device_of(x), torch.float32)
    scf = torch.clamp_min(14 - add_shift - (_max_exp(x) - 127), 0)[0]
    s = x * torch.exp2(scf.float())
    mag = s.abs()
    chop = torch.floor(mag)
    frac = mag - chop
    if round_mode == RoundMode.FPHW:
        # round half away from zero; the sign from the sign bit
        qm = torch.round(s).abs()
        qm = torch.where(frac == 0.5, chop + 1.0, qm)
        q = torch.where(torch.signbit(s), -qm, qm)
    else:
        if round_mode == RoundMode.NO_ROUND:
            qm = chop
        elif round_mode == RoundMode.NEAREST:
            qm = chop + (frac >= 0.5)
        elif round_mode == RoundMode.BIAS:
            # up when either of the two bits below the cut is set
            qm = chop + (frac >= 0.25)
        elif round_mode == RoundMode.STOCH:
            p = torch.rand(x.shape, generator=key, device=x.device)
            qm = chop + (p < frac)
        else:
            raise ValueError(f"unknown round mode {round_mode!r}")
        q = torch.sign(s) * qm
    q = torch.clamp(q, -32768.0, 32767.0)
    return q.to(torch.int16), scf.to(torch.uint8)


def quantize_act(x, add_shift: int = 0,
                 round_mode: RoundMode = RoundMode.NEAREST,
                 key: Optional[torch.Generator] = None):
    """libxsmm_dnn_quantize_act analog (NHWC activations): the per-tensor
    quantization."""
    return quantize(x, add_shift, round_mode, key)


def quantize_fil(w, add_shift: int = 0,
                 round_mode: RoundMode = RoundMode.NEAREST,
                 key: Optional[torch.Generator] = None):
    """libxsmm_dnn_quantize_fil analog (conv filters; see quantize_act)."""
    return quantize(w, add_shift, round_mode, key)


def dequantize(q, scf) -> torch.Tensor:
    """libxsmm_dnn_dequantize analog: i16 * 2^-scf -> f32."""
    dev = device_of(q, scf)
    q, scf = on(q, dev), on(scf, dev)
    return q.float() * torch.exp2(-scf.float())
