"""Plain reference of the sparse operator cells.

C = C_in + A @ B in f64 with the operator dense, by columns.  Imports
nothing of the program.
"""

from __future__ import annotations

import torch

F32, F64 = torch.float32, torch.float64


def acc_f64(a64: torch.Tensor, cin64: torch.Tensor,
            b64: torch.Tensor) -> torch.Tensor:
    """C_in + A @ B, all f64: A [M, K], B [K, n], C_in [M, n]."""
    return torch.addmm(cin64, a64, b64)


def acc_lo(a64: torch.Tensor, cin64: torch.Tensor,
           b64: torch.Tensor) -> torch.Tensor:
    """What the lo planes of a two-float split add to C_in + A @ B: C_in's
    lo part, plus A's hi times B's lo, plus A's lo times B's hi (the
    lo-times-lo term is below f64's own rounding)."""
    ah, bh = a64.to(F32).to(F64), b64.to(F32).to(F64)
    return ((cin64 - cin64.to(F32).to(F64)) + ah @ (b64 - bh)
            + (a64 - ah) @ bh)
