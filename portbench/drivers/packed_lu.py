"""Drives the packed LU path as element block-Jacobi runs it: a call is one
implicit step's preconditioner work on operand set ``s``:

    lu = getrf_dispatch(n, n, batch=B).packed(a)                  # kernel 12
    for each of ``applies_per_call`` right-hand sides r:
        y = trsm_dispatch(n, rhs, uplo="L", diag="U", batch=B).packed(lu, r)
        x = trsm_dispatch(n, rhs, uplo="U", diag="N", batch=B).packed(lu, y)

on f32 operands in the packed layout, on the card: blocks A [n, n, B],
right-hand sides [n, rhs, B].  Both solves read the one packed ``lu``; the
call returns the solutions x, one an apply, as a tuple.

Each operand set has its own blocks and right-hand sides from the seed.
Off the diagonal a block holds N(0, 1) / sqrt(n); its diagonal is each
row's off-diagonal absolute sum times 1 + u, u ~ U(0.1, 1), so every block
is strictly row diagonally dominant and the unpivoted LU exists and is
stable.  The control rounds the factors to bf16 before the solves.

The check compares each solution with the f64 reference solve of its set's
blocks (``reference/lu.py``, the f32 data widened exactly), computed on the
device in blocks of elements: ``rel_err_max`` is the worst solve's relative
error, over every element and apply.
"""

from __future__ import annotations

import math

import torch

from .. import check, inputs, roofline_lu
from ..reference import lu as ref

F32, F64 = torch.float32, torch.float64
CHUNK = 16384   # elements a pass of the diagonal's making
BLOCK = 8192    # elements a block of the reference
STREAMS = 3     # of a set: off-diagonal values, the diagonal's u, the RHS


def stream(s: int, operand: int) -> int:
    return STREAMS * s + operand


def blocks(n: int, batch: int, device, seed: int, s: int) -> torch.Tensor:
    """Set ``s``'s blocks, packed [n, n, batch] f32."""
    g = torch.Generator(device=device)
    g.manual_seed(inputs.stream_seed(seed, stream(s, 0)))
    a = torch.randn((n, n, batch), generator=g, dtype=F32, device=device)
    a /= math.sqrt(n)
    g.manual_seed(inputs.stream_seed(seed, stream(s, 1)))
    grow = 1.1 + 0.9 * torch.rand((n, batch), generator=g, dtype=F32,
                                  device=device)
    idx = torch.arange(n, device=device)
    for c in range(0, batch, CHUNK):
        part = a[:, :, c:c + CHUNK]
        part[idx, idx] = 0.0
        part[idx, idx] = part.abs().sum(1) * grow[:, c:c + CHUNK]
    return a


def rhs(n: int, cols: int, applies: int, batch: int, device, seed: int,
        s: int) -> torch.Tensor:
    """Set ``s``'s right-hand sides, [applies, n, cols, batch] f32."""
    return inputs.normal((applies, n, cols, batch), F32, device, seed,
                         stream(s, 2))


class Driver:
    numbers = ("rel_err_max",)

    def __init__(self, config, traffic, device, seed, control=False,
                 spans=None):
        import xsmm_tpu_torch as xp

        if config["dtype"] != "float32":
            raise ValueError(f"dtype {config['dtype']}: this driver runs "
                             "the packed float32 path")
        self.xp = xp
        self.n, self.rhs = int(config["m"]), int(config["rhs"])
        self.batch = int(config["batch"])
        self.applies = int(traffic["applies_per_call"])
        self.calls_per_step = int(traffic["calls_per_step"])
        self.device, self.seed, self.control = device, seed, control
        self.sets = [self._data(s) for s in range(inputs.SETS)]
        self.ops_per_call, self.bytes_per_call = roofline_lu.call(config,
                                                                  traffic)

    def _data(self, s):
        return (blocks(self.n, self.batch, self.device, self.seed, s),
                rhs(self.n, self.rhs, self.applies, self.batch, self.device,
                    self.seed, s))

    def lookup(self):
        xp, n, cols, b = self.xp, self.n, self.rhs, self.batch
        return (xp.getrf_dispatch(n, n, batch=b),
                xp.trsm_dispatch(n, cols, uplo="L", diag="U", batch=b),
                xp.trsm_dispatch(n, cols, uplo="U", diag="N", batch=b))

    def call(self, handle, s):
        getrf, lower, upper = handle
        a, r = self.sets[s]
        lu = getrf.packed(a)
        if self.control:
            lu = lu.to(torch.bfloat16).to(F32)
        return tuple(upper.packed(lu, lower.packed(lu, r[j]))
                     for j in range(self.applies))

    def release(self):
        del self.sets

    def check(self, outputs):
        """{"rel_err_max": [one reading an output]}, each (set, output)
        against the f64 reference solves of that set's blocks."""
        return check.per_set(outputs, self._check_set)

    def _check_set(self, s, outputs):
        a, r = self._data(s)
        worst = [0.0] * len(outputs)
        for c in range(0, self.batch, BLOCK):
            f = ref.lu(a[:, :, c:c + BLOCK].permute(2, 0, 1))
            nb = f.shape[0]
            # the applies' right sides side by side: [nb, n, applies * rhs]
            cols = r[..., c:c + BLOCK].permute(3, 1, 0, 2).reshape(
                nb, self.n, self.applies * self.rhs)
            want = ref.apply(f, cols).view(nb, self.n, self.applies,
                                           self.rhs)
            del f, cols
            for i, out in enumerate(outputs):
                got = torch.stack([x[..., c:c + BLOCK] for x in out])
                worst[i] = max(worst[i], check.rel_err_max(
                    got.permute(3, 1, 0, 2), want, (1, 3)))
        return {"rel_err_max": worst}
