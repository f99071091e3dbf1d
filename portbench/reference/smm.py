"""Plain reference of the batched SMM cells.

C[m, n, b] = sum_k A[m, k, b] * B[k, n, b] in f64, on the lane-packed
layout (batch last) or the natural one (batch first), with torch's f64
batched product.  Imports nothing of the program.
"""

from __future__ import annotations

import torch

F32, F64 = torch.float32, torch.float64


def packed_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A [M, K, B] and B [K, N, B] in f64 -> C [M, N, B] in f64."""
    c = torch.bmm(a.to(F64).permute(2, 0, 1), b.to(F64).permute(2, 0, 1))
    return c.permute(1, 2, 0)


def natural_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A [B, M, K] and B [B, K, N] in f64 -> C [B, M, N] in f64."""
    return torch.bmm(a.to(F64), b.to(F64))


def lo_part(x64: torch.Tensor) -> torch.Tensor:
    """x - f64(f32(x)): what a two-float split carries in its lo plane."""
    return x64 - x64.to(F32).to(F64)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 data rounded to TF32 (10 mantissa bits, to nearest, ties to
    even), as the tensor cores round their inputs in TF32 mode."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0xFFF + lsb) & ~0x1FFF
    return r.view(F32)


def natural_f32_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 product computed in TF32: inputs rounded to TF32, products
    summed in f32 (TF32 switched off, so the rounding is this one)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(to_tf32(a), to_tf32(b))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
