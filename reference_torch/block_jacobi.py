"""Plain reference of element block-Jacobi on dense element blocks.

Each element of a high-order DG mesh owns a dense n x n block of the
Jacobian (n = (p+1)^3 nodes); the preconditioner factors every block once
(unpivoted Doolittle LU: unit lower L, upper U) and applies it as a forward
solve with L and a backward solve with U, one element at a time.

Batch first: blocks ``[..., n, n]``, right-hand sides ``[..., n, r]``.
Everything is computed in float64, whatever the input's type, from
elementwise products and sums (no library factorization or solve), with
TF32 switched off while it runs.  Imports torch alone: no kernel, no part
of any package under test.
"""

from __future__ import annotations

import contextlib

import torch

F64 = torch.float64


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and cuDNN, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def lu(a: torch.Tensor) -> torch.Tensor:
    """Unpivoted Doolittle LU of ``a`` [..., n, n] in f64: the multipliers
    of L (unit diagonal, not stored) below the diagonal, U on and above it,
    in one tensor, as LAPACK's getrf stores them (without pivots)."""
    with exact():
        f = a.to(F64).clone()
        n = f.shape[-1]
        for k in range(n - 1):
            f[..., k + 1:, k] /= f[..., k, k, None]
            f[..., k + 1:, k + 1:] -= (f[..., k + 1:, k, None]
                                       * f[..., k, None, k + 1:])
        return f


def forward_unit(f: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y with L y = b, L the unit lower factor in ``f`` [..., n, n], b
    [..., n, r]; f64."""
    with exact():
        f = f.to(F64)
        y = b.to(F64).clone()
        for i in range(1, f.shape[-1]):
            y[..., i, :] -= (f[..., i, :i, None] * y[..., :i, :]).sum(-2)
        return y


def backward(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x with U x = y, U the upper factor in ``f`` [..., n, n] (its
    diagonal included), y [..., n, r]; f64."""
    with exact():
        f = f.to(F64)
        x = y.to(F64).clone()
        n = f.shape[-1]
        for i in reversed(range(n)):
            if i + 1 < n:
                x[..., i, :] -= (f[..., i, i + 1:, None]
                                 * x[..., i + 1:, :]).sum(-2)
            x[..., i, :] /= f[..., i, i, None]
        return x


def apply(f: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The preconditioner's apply on factored blocks: U^-1 L^-1 r."""
    return backward(f, forward_unit(f, r))


def block_jacobi(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Factor every block of ``a`` [..., n, n] and apply it to ``r``
    [..., n, r]: the solution of a x = r, block by block, in f64."""
    return apply(lu(a), r)
