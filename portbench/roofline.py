"""Operations, bytes and peaks: the yardstick of the per-call rooflines.

Operations are the useful ones of the call as its shapes define them
(2*M*N*K*B for a batched SMM, 2*nnz*N for a sparse operator on N columns),
whatever a schedule computes internally.  Bytes are those of the tensors
the call takes and returns, each counted once, plus the operator a sparse
call reads: a faster schedule still has to read and write them once.
"""

from __future__ import annotations

from typing import Dict, Tuple

# Published peaks of one card (NVIDIA's data sheet, SXM part, dense rates
# without sparsity, at the full power limit of 700 W): HBM bytes/s, f32
# operations/s outside the tensor cores, device memory in bytes.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flop_per_s": 67e12,
                              "memory_bytes": 80e9},
}


def peaks(card: str) -> Dict[str, float]:
    """The peak table's row for ``card`` (``torch.cuda.get_device_name``);
    raises ``KeyError`` for a card the table does not hold."""
    try:
        return PEAKS[card]
    except KeyError:
        raise KeyError(f"no peaks for card {card!r}; known: "
                       f"{sorted(PEAKS)}") from None


def smm_call(m: int, n: int, k: int, batch: int,
             in_planes: Tuple[int, int], out_planes: int,
             itemsize: int = 4) -> Tuple[float, float]:
    """(operations, bytes) of one batched SMM call: ``in_planes`` = (planes
    of A, planes of B) it takes, ``out_planes`` planes of C it returns."""
    ops = 2.0 * m * n * k * batch
    elems = (in_planes[0] * m * k + in_planes[1] * k * n
             + out_planes * m * n)
    return ops, float(elems * batch * itemsize)


def sparse_acc_call(m: int, k: int, n: int, nnz: int, b_planes: int,
                    c_planes: int, value_planes: int,
                    itemsize: int = 4) -> Tuple[float, float]:
    """(operations, bytes) of one C = C_in + A @ B call with A sparse
    [m, k] with ``nnz`` terms, B ``b_planes`` planes [k, n], C_in and C
    ``c_planes`` planes [m, n] each; the operator: m + 1 row pointers,
    nnz column indices (int32) and ``value_planes`` f32 values a term."""
    ops = 2.0 * nnz * n
    planes = (b_planes * k + 2 * c_planes * m) * n * itemsize
    operator = (m + 1 + nnz) * 4 + value_planes * nnz * itemsize
    return ops, float(planes + operator)


def bound_s(ops: float, nbytes: float,
            peak: Dict[str, float]) -> Tuple[float, str]:
    """The least time the card could take, and which bound it is:
    max(bytes / HBM bytes/s, operations / f32 operations/s)."""
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    t_ops = ops / peak["fp32_flop_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
