"""Drives ``smmdispatch(M, N, K, batch=B, beta=0)(a, b)``: the f32 batched
SMM on batch-first ``[B, M, K]`` / ``[B, K, N]`` tensors on the card, as a
user hands them to ``torch.bmm``.  The call packs them (transposes on the
card), runs the packed kernel and returns a ``[B, M, N]`` view.

The control is the reference computed in TF32 (the precision below f32
with TF32 off) in the program's place.
"""

from __future__ import annotations

import torch

from .. import check, inputs, roofline
from ..reference import smm as ref

F32 = torch.float32
BLOCK = 16384  # problems a block of the reference


class Driver:
    numbers = ("rel_err_max",)

    def __init__(self, config, traffic, device, seed, control=False,
                 spans=None):
        import xsmm_tpu_torch as xp

        self.xp = xp
        self.m, self.n, self.k = config["m"], config["n"], config["k"]
        self.batch = config["batch"]
        self.beta = float(config["beta"])
        self.device, self.seed, self.control = device, seed, control
        self.calls_per_step = int(traffic["calls_per_step"])
        self.sets = [self._data(s) for s in range(inputs.SETS)]
        self.ops_per_call, self.bytes_per_call = roofline.smm_call(
            self.m, self.n, self.k, self.batch, (1, 1), 1)

    def _data(self, s):
        return (inputs.normal((self.batch, self.m, self.k), F32, self.device,
                              self.seed, inputs.stream(s, 0)),
                inputs.normal((self.batch, self.k, self.n), F32, self.device,
                              self.seed, inputs.stream(s, 1)))

    def lookup(self):
        return self.xp.smmdispatch(self.m, self.n, self.k, batch=self.batch,
                                   beta=self.beta)

    def call(self, kernel, s):
        a, b = self.sets[s]
        if self.control:
            return ref.natural_f32_tf32(a, b)
        return kernel(a, b)

    def release(self):
        del self.sets

    def check(self, outputs):
        """{"rel_err_max": [one reading an output]}, each (set, output)
        against the f64 product of that set's f32 A and B."""
        return check.per_set(outputs, self._check_set)

    def _check_set(self, s, outputs):
        a, b = self._data(s)
        worst = [0.0] * len(outputs)
        for r in range(0, self.batch, BLOCK):
            want = ref.natural_f64(a[r:r + BLOCK], b[r:r + BLOCK])
            for i, out in enumerate(outputs):
                worst[i] = max(worst[i], check.rel_err_max(
                    out[r:r + BLOCK], want, (1, 2)))
        return {"rel_err_max": worst}
