"""The cells' inputs, made from ``--seed`` on the device.

Each operand has a stream of its own: a ``torch.Generator`` on the device,
seeded from (seed, stream), so the same seed gives the same data on both
sides of the comparison, and a data set can be made again after the window
for the reference.  Every seed gives the same sizes; only values differ.

A cell's calls cycle through ``SETS`` operand sets, each with streams of
its own (``stream(s, operand)``), so consecutive calls read different data,
as the stacks of one DBCSR multiplication or the stages of one RK step do,
and a stale or skipped answer differs from the one its set is due.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

SETS = 3          # operand sets a cell's calls cycle through
OPERANDS = 2      # streams of each set: A and B, or B and C_in



def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed from (seed, stream), every bit mixed: the
    CPU's generator keeps only the low 32 bits of its seed."""
    h = hashlib.blake2b(f"{int(seed)}:{int(stream)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def stream(s: int, operand: int) -> int:
    """The stream of operand ``operand`` (< ``OPERANDS``) of set ``s``."""
    if not 0 <= operand < OPERANDS:
        raise ValueError(f"operand {operand} out of range")
    return OPERANDS * s + operand


def normal(shape, dtype: torch.dtype, device: torch.device, seed: int,
           stream: int) -> torch.Tensor:
    """Standard normal data of ``shape`` and ``dtype`` on ``device``, from
    stream ``stream`` of ``seed`` (any whole number >= 0)."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return torch.randn(tuple(shape), generator=g, dtype=dtype, device=device)


def split_hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The true two-float split of f64 data: hi = f32(x), lo = f32(x -
    f64(hi)); hi + lo holds x to about 2^-48 of its size."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo
