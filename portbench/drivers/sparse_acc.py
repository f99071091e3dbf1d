"""Drives ``create_dcsr_reg(op, N, f64_schedule=...).acc_fn(ch, cl, bh,
bl)``: C = C_in + A @ B for a fixed f64 sparse operator on f32 hi/lo
planes on the card (the split2 schedule: both lo planes read, both C
planes returned).

The operator is the config's (``pyfr_ops``), fixed and independent of the
seed; B and C_in are f64 data from the seed, one pair an operand set,
split into their true hi/lo planes.  As PyFR and LIBXSMM's pyfr sample do,
set-up creates the handle once (``create_ms``) and every step applies it:
the step's lookup is that handle, with no registry call.  Set-up also
times ``HITS`` more ``create_dcsr_reg`` calls, which the registry answers
from its cache (``create_hit_us``).  The control is the program's own f32
path (``create_csr_soa(op, N, "float32")``, ``acc_fn(ch, bh)``: no lo
plane read or written).
"""

from __future__ import annotations

import time

import torch

from .. import check, inputs, pyfr_ops, roofline
from ..reference import sparse as ref

F32, F64 = torch.float32, torch.float64
BLOCK = 1 << 17  # columns a block of the reference
HITS = 32        # registry hits timed in set-up


class Driver:
    numbers = ("lo_missing",)

    def __init__(self, config, traffic, device, seed, control=False,
                 spans=None):
        import xsmm_tpu_torch as xp

        self.xp = xp
        opc = config["operator"]
        self.op = pyfr_ops.operator(opc)
        if (list(self.op.shape) != [opc["m"], opc["k"]]
                or int((self.op != 0).sum()) != opc["nnz"]):
            raise ValueError(f"operator {opc} is not its definition's")
        self.m, self.k = self.op.shape
        self.n = int(traffic["n"])
        self.schedule = config["f64_schedule"]
        self.device, self.seed, self.control = device, seed, control
        self.calls_per_step = int(traffic["calls_per_step"])
        self.sets = []
        for s in range(inputs.SETS):
            b64, c64 = self._data(s)
            self.sets.append((*inputs.split_hi_lo(b64),
                              *inputs.split_hi_lo(c64)))
            del b64, c64
        self.csr = xp.Csr.from_dense(self.op)
        spans = {} if spans is None else spans
        t0 = time.perf_counter_ns()
        self.handle = self._create()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        spans["create_ns"] = [time.perf_counter_ns() - t0]
        hits = []
        for _ in range(HITS):
            t0 = time.perf_counter_ns()
            hit = self._create()
            hits.append(time.perf_counter_ns() - t0)
            if hit is not self.handle:
                raise RuntimeError("create_dcsr_reg missed the registry")
        spans["create_hit_ns"] = hits
        self.ops_per_call, self.bytes_per_call = roofline.sparse_acc_call(
            self.m, self.k, self.n, self.csr.nnz, 2, 2, 2)

    def _data(self, s):
        return (inputs.normal((self.k, self.n), F64, self.device, self.seed,
                              inputs.stream(s, 0)),
                inputs.normal((self.m, self.n), F64, self.device, self.seed,
                              inputs.stream(s, 1)))

    def _create(self):
        if self.control:
            return self.xp.create_csr_soa(self.csr, self.n, dtype="float32")
        return self.xp.create_dcsr_reg(self.csr, self.n,
                                       f64_schedule=self.schedule)

    def lookup(self):
        return self.handle

    def call(self, kernel, s):
        bh, bl, ch, cl = self.sets[s]
        if self.control:
            return kernel.acc_fn(ch, bh)
        return kernel.acc_fn(ch, cl, bh, bl)

    def release(self):
        del self.sets

    def check(self, outputs):
        """{"lo_missing": [one reading an output]}, each (set, output)
        against the f64 reference C_in + A @ B of that set's data."""
        return check.per_set(outputs, self._check_set)

    def _check_set(self, s, outputs):
        a64 = torch.as_tensor(self.op, dtype=F64, device=self.device)
        b64, c64 = self._data(s)
        lo = check.LoMissing(len(outputs))
        for r in range(0, self.n, BLOCK):
            b, c = b64[:, r:r + BLOCK], c64[:, r:r + BLOCK]
            want = ref.acc_f64(a64, c, b)
            add = ref.acc_lo(a64, c, b)
            lo.block(want, add)
            for i, out in enumerate(outputs):
                planes = out if isinstance(out, tuple) else (out,)
                lo.add(i, sum(p[:, r:r + BLOCK].to(F64) for p in planes))
        return {"lo_missing": lo.values()}
