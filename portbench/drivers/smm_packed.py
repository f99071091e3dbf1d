"""Drives ``dmmdispatch(M, N, K, batch=B, beta=0).packed(ah, bh, bl)``: the
f64 batched SMM on f32 hi/lo planes in the lane-packed layout, on the card.

A and B are f64 data from the seed, in the packed layout, one pair an
operand set; ``ah`` is A's hi plane (the split2_fast schedule reads no A
lo), ``bh``/``bl`` the true two-float split of B.  The control is the program's own float32 path
(``XSMM_F64=float32``: ``packed(ah, bh)``, the B lo plane not read).
"""

from __future__ import annotations

import torch

from .. import check, inputs, roofline
from ..reference import smm as ref

F64 = torch.float64
BLOCK = 16384  # problems a block of the reference


class Driver:
    numbers = ("lo_missing",)

    def __init__(self, config, traffic, device, seed, control=False,
                 spans=None):
        import xsmm_tpu_torch as xp

        self.xp = xp
        self.m, self.n, self.k = config["m"], config["n"], config["k"]
        self.batch = config["batch"]
        self.beta = float(config["beta"])
        self.device, self.seed, self.control = device, seed, control
        self.calls_per_step = int(traffic["calls_per_step"])
        self.sets = []
        for s in range(inputs.SETS):
            a64, b64 = self._data(s)
            self.sets.append((a64.to(torch.float32),
                              *inputs.split_hi_lo(b64)))
            del a64, b64
        self.ops_per_call, self.bytes_per_call = roofline.smm_call(
            self.m, self.n, self.k, self.batch, (1, 2), 1)
        if control:
            xp.set_config(f64_strategy="float32")

    def _data(self, s):
        shape_a = (self.m, self.k, self.batch)
        shape_b = (self.k, self.n, self.batch)
        return (inputs.normal(shape_a, F64, self.device, self.seed,
                              inputs.stream(s, 0)),
                inputs.normal(shape_b, F64, self.device, self.seed,
                              inputs.stream(s, 1)))

    def lookup(self):
        return self.xp.dmmdispatch(self.m, self.n, self.k, batch=self.batch,
                                   beta=self.beta)

    def call(self, kernel, s):
        ah, bh, bl = self.sets[s]
        if self.control:
            return kernel.packed(ah, bh)
        return kernel.packed(ah, bh, bl)

    def release(self):
        del self.sets

    def check(self, outputs):
        """{"lo_missing": [one reading an output]}, each (set, output)
        against the f64 reference of that set's A and B."""
        return check.per_set(outputs, self._check_set)

    def _check_set(self, s, outputs):
        a64, b64 = self._data(s)
        lo = check.LoMissing(len(outputs))
        for r in range(0, self.batch, BLOCK):
            a, b = a64[..., r:r + BLOCK], b64[..., r:r + BLOCK]
            want = ref.packed_f64(a, b)
            # what B's lo plane adds: A as the schedule reads it (hi) x B lo
            add = ref.packed_f64(a.to(torch.float32), ref.lo_part(b))
            lo.block(want, add)
            for i, out in enumerate(outputs):
                lo.add(i, out[..., r:r + BLOCK])
        return {"lo_missing": lo.values()}
