"""Random number generation: the port of ``xsmm_tpu/utils/rng.py``.

Reference: src/libxsmm_rng.c — vectorized xorshift128+ float sequence
(libxsmm_rng_f32_seq) with set-seed state, plus scalar helpers.

Two tiers, as in the JAX package:

* host tier: the same exact xorshift128+ (splitmix64 seeding), so both
  packages give the same numbers for the same seed;
* device tier: ``torch.rand`` drawing from an explicit ``torch.Generator``
  where the JAX package takes a key (the bits differ, the distribution is
  the same).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = (1 << 64) - 1


class Xorshift128p:
    """Scalar xorshift128+ (the reference's generator family)."""

    def __init__(self, seed: int = 25071975):
        # splitmix64 seeding (standard practice for xorshift-family)
        s = seed & _MASK
        self.state = []
        for _ in range(2):
            s = (s + 0x9E3779B97F4A7C15) & _MASK
            z = s
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
            self.state.append(z ^ (z >> 31))

    def next_u64(self) -> int:
        s1, s0 = self.state
        r = (s0 + s1) & _MASK
        s1 ^= (s1 << 23) & _MASK
        self.state = [s0, (s1 ^ s0 ^ (s1 >> 18) ^ (s0 >> 5)) & _MASK]
        return r

    def f32(self) -> float:
        # 24 mantissa bits -> [0, 1)
        return (self.next_u64() >> 40) * (1.0 / (1 << 24))


_GLOBAL = Xorshift128p()


def rng_set_seed(seed: int) -> None:
    """libxsmm_rng_set_seed analog."""
    global _GLOBAL
    _GLOBAL = Xorshift128p(seed)


def rng_f32_seq(n: int) -> np.ndarray:
    """libxsmm_rng_f32_seq analog: n floats in [0, 1)."""
    return np.asarray([_GLOBAL.f32() for _ in range(n)], np.float32)


def rng_u32() -> int:
    return _GLOBAL.next_u64() & 0xFFFFFFFF


def device_uniform(gen: torch.Generator, shape,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Device-tier uniform [0, 1) drawn from ``gen``, on ``gen``'s
    device."""
    return torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
