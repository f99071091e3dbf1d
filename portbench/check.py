"""The comparison that decides ``correct``: numbers against their limits.

A driver computes, for each output it checks, the numbers its cell
compares (each a function below, against the plain reference).  A number
is read as its worst over the checked outputs, and an output fails when
any of its numbers is above its limit.  The limits of a cell are in
``limits/<workload>.json``, each with the readings it was set from.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

F64 = torch.float64


class LoMissing:
    """The share of the lo planes' contribution that an output lacks.

    L is what the lo planes of the inputs add to the f64 reference R.  Over
    the elements where |L| is at least one f32 ulp of R (where one f32
    output plane can carry it), it reads |sum(e * L)| / sum(L * L) with
    e = output - R: ~0 where the output carries the f64 part of the
    inputs, ~1 where it was computed from the hi planes alone.  Fed block
    by block: ``block(R, L)``, then ``add(i, output)`` for each output."""

    def __init__(self, n_outputs: int):
        self.num = [0.0] * n_outputs
        self.den = 0.0
        self._mask = self._want = self._lo = None

    def block(self, want: torch.Tensor, lo: torch.Tensor) -> None:
        _, exp = torch.frexp(want)
        ulp = torch.ldexp(torch.ones_like(want), exp - 24)
        self._mask = lo.abs() >= ulp
        self._want, self._lo = want[self._mask], lo[self._mask]
        self.den += float((self._lo * self._lo).sum())

    def add(self, i: int, out: torch.Tensor) -> None:
        err = out.to(F64)[self._mask] - self._want
        self.num[i] += float((err * self._lo).sum())

    def values(self) -> List[float]:
        if self.den <= 0.0:
            raise ValueError("the lo planes add less than an ulp everywhere: "
                             "lo_missing has nothing to measure")
        return [abs(n) / self.den for n in self.num]


def per_set(outputs, read) -> Dict[str, List[float]]:
    """The readings of ``outputs``, a list of (set, output), one an output
    in their order: ``read(s, outs)`` reads the outputs of set ``s``
    against that set's reference, {number: [one reading each]}."""
    values: Dict[str, List[float]] = {}
    for s in sorted({s for s, _ in outputs}):
        idx = [i for i, (t, _) in enumerate(outputs) if t == s]
        got = read(s, [outputs[i][1] for i in idx])
        for name, vals in got.items():
            col = values.setdefault(name, [None] * len(outputs))
            for i, v in zip(idx, vals):
                col[i] = v
    return values


def rel_err_max(out: torch.Tensor, ref: torch.Tensor, dims) -> float:
    """The worst problem's relative Frobenius error: max over problems of
    ||out - ref|| / ||ref||, the norm over ``dims``."""
    err = torch.linalg.vector_norm(out.to(F64) - ref, dim=dims)
    return float((err / torch.linalg.vector_norm(ref, dim=dims)).max())


def load_limits(path: Path) -> Dict[str, float]:
    """{number: limit} of a cell."""
    data = json.loads(Path(path).read_text())
    return {name: float(v["limit"]) for name, v in data["numbers"].items()}


def judge(values: Dict[str, List[float]], limits: Dict[str, float]
          ) -> Tuple[bool, int, Dict[str, Dict[str, float]]]:
    """(correct, failed outputs, {number: {"value", "limit"}}).  Every
    number a driver reads needs a limit, and every limit a number."""
    if set(values) != set(limits):
        raise ValueError(f"numbers {sorted(values)} but limits "
                         f"{sorted(limits)}")
    n = {len(v) for v in values.values()}
    if len(n) != 1 or 0 in n:
        raise ValueError("every number needs one reading an output")
    failed = sum(any(values[k][i] > limits[k] for k in values)
                 for i in range(n.pop()))
    checks = {k: {"value": max(v), "limit": limits[k]}
              for k, v in sorted(values.items())}
    ok = failed == 0 and all(c["value"] <= c["limit"]
                             for c in checks.values())
    return ok, failed, checks
