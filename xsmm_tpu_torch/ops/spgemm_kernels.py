"""The four sparse x dense kernels: wrappers, plain versions, counts.

C[M,N] = A_csr[M,K] @ B[K,N] for an operator fixed at creation, on row-major
f32 planes: B ``[K, N]``, C and C_in ``[M, N]``, any N.  f64 data is carried
as f32 hi/lo planes, as in ``xsmm_tpu/ops/spgemm.py``.

The operator (``SparseOperator``) holds the CSR structure and values on one
device, made once: the f32 values ``vh = f32(v)`` and the f64 lo part
``vl = f32(v - f64(vh))``.  It plays the part of the JAX package's baked-in
constants.

Each wrapper checks device, dtype, shape and contiguity, then:

* on CUDA tensors it allocates the outputs with ``torch.empty``, launches
  its kernel (``ops/csrc/spgemm.cu``) on the current stream on the route
  ``pick_route`` names (or the one the caller forces), raises if the launch
  returned a CUDA error, and adds one to ``launches[name]`` and to
  ``route_launches`` of the route's staging and of its structure;
* on CPU tensors it runs its plain PyTorch version (``*_plain``), which
  repeats the kernel's arithmetic in the same term order.  It works on all
  rows at once: step j adds term j of every row that has one.

Any other device raises.  There is no fallback from a CUDA tensor.

Routes (``pick_route``, the one place that picks them): a route is a
staging and a structure.  Structure: the operator is copied to shared
memory ("shared") up to ``STRUCT_BUDGET`` bytes, else read from device
memory ("global").  Staging: B tiles go through a ring of at least two
stages in shared memory, filled by TMA ("tma") where N % 4 == 0, N < 2^31
and every B plane starts on 16 bytes (a TMA box starts on 16 bytes), else
by cp.async ("cp_async"); B is read from device memory ("unstaged") where
the operator has no term or the ring does not fit beside the structure
(and the acc kernels' C_in rings).
That fit is the kernel's own check (``xsmm_spgemm_fits``, asked once an
operator and kind and kept), so it is known for CUDA tensors only; on CPU
tensors the route is a name.  A caller may force a route: a name outside
``STAGINGS`` x ``STRUCTURES``, or "tma" on planes TMA cannot address,
raises ``ValueError`` on either device; on the card the kernel refuses a
route that does not fit, which raises ``ValueError`` with nothing
launched.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils import trace
from . import cuda_build

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {"spgemm_unroll_f32": 0, "spgemm_unroll_f64": 0,
                            "spgemm_acc_f32": 0, "spgemm_acc_f64": 0}

STAGINGS = ("tma", "cp_async", "unstaged")
STRUCTURES = ("shared", "global")
# staging or structure -> launches on it since the last reset_launches()
route_launches: Dict[str, int] = dict.fromkeys(STAGINGS + STRUCTURES, 0)
ROUTE_REFUSED = ("the route does not fit this operator and kernel (a "
                 "staged route needs two stages in shared memory beside the "
                 "structure; the structure must fit shared memory); nothing "
                 "was launched")
STRUCT_BUDGET = 48 * 1024  # the operator in shared memory up to this
# routes picked (pick_route's cache misses; utils/trace.build_counts)
routes_picked = 0

_LIB: Optional[ctypes.CDLL] = None

F32 = torch.float32
Out64 = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
Route = Tuple[str, str]


def reset_launches() -> None:
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("spgemm")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [i, i, ll, i, i, i, i, p]  # m k n nnz staging structure
        lib.xsmm_spgemm_unroll_f32.argtypes = [p] * 5 + tail
        lib.xsmm_spgemm_acc_f32.argtypes = [p] * 6 + tail
        lib.xsmm_spgemm_unroll_f64.argtypes = [p] * 8 + tail
        lib.xsmm_spgemm_acc_f64.argtypes = [p] * 10 + tail
        lib.xsmm_spgemm_fits.argtypes = [i] * 9
        for fn in (lib.xsmm_spgemm_unroll_f32, lib.xsmm_spgemm_acc_f32,
                   lib.xsmm_spgemm_unroll_f64, lib.xsmm_spgemm_acc_f64,
                   lib.xsmm_spgemm_fits):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def split_values(values) -> Tuple[np.ndarray, np.ndarray]:
    """The two-float split of the operator's values, elementwise:
    hi = f32(v), lo = f32(f64(v) - f64(hi))."""
    hi = np.asarray(values).astype(np.float32)
    lo = (np.asarray(values).astype(np.float64)
          - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


class SparseOperator:
    """A CSR operator's structure and values on one device."""

    def __init__(self, csr, device: torch.device):
        if torch.device(device).type not in ("cuda", "cpu"):
            raise ValueError(f"spgemm kernels run on cuda or cpu, not "
                             f"{device}")
        self.m, self.k = int(csr.m), int(csr.k)
        row_ptr = np.asarray(csr.row_ptr, np.int64)
        cols = np.asarray(csr.col_idx, np.int64)
        # the kernels index B and the values with these: check them here
        if (row_ptr.shape != (self.m + 1,) or row_ptr[0] != 0
                or (np.diff(row_ptr) < 0).any() or row_ptr[-1] != cols.size
                or np.asarray(csr.values).shape != cols.shape
                or (cols.size and not (0 <= cols.min() <= cols.max()
                                       < self.k))):
            raise ValueError(f"not a valid {self.m}x{self.k} CSR structure")
        vh, vl = split_values(csr.values)
        self.row_ptr = torch.as_tensor(row_ptr, dtype=torch.int32,
                                       device=device)
        self.col_idx = torch.as_tensor(cols, dtype=torch.int32,
                                       device=device)
        self.vh = torch.as_tensor(vh, device=device)
        self.vl = torch.as_tensor(vl, device=device)
        self.device = self.row_ptr.device  # with its index: cuda:0
        self.on_cpu = self.device.type == "cpu"
        self.nnz = int(self.col_idx.numel())
        self.ptrs = tuple(t.data_ptr() for t in (self.row_ptr, self.col_idx,
                                                 self.vh, self.vl))
        # (f64, B planes, C_in planes, TMA addresses them) -> route
        self.routes: Dict[Tuple[bool, int, int, bool], Route] = {}
        # for the plain versions: term j of every row that has one
        lengths = np.diff(row_ptr)
        self._steps_host = [np.nonzero(lengths > j)[0]
                            for j in range(int(lengths.max(initial=0)))]
        self._row_start = row_ptr[:-1]
        self._steps: Optional[List] = None

    def steps(self) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """(rows, cols, term index) of step j = 0, 1, ...: the rows with a
        j-th term, that term's B row, and its index into the values."""
        if self._steps is None:
            out = []
            for j, rows in enumerate(self._steps_host):
                idx = torch.as_tensor(self._row_start[rows] + j,
                                      device=self.device)
                out.append((torch.as_tensor(rows, device=self.device),
                            self.col_idx[idx].long(), idx))
            self._steps = out
        return self._steps

    def nonempty(self) -> torch.Tensor:
        """[M, 1] bool: rows with at least one term."""
        return (self.row_ptr[1:] > self.row_ptr[:-1])[:, None]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(op: SparseOperator, ops: Dict[str, Optional[torch.Tensor]],
           n: int) -> None:
    """Each named operand must be a contiguous f32 tensor on the
    operator's device: B planes [K, n], C planes [M, n]."""
    for name, t in ops.items():
        if t is None or (isinstance(t, torch.Tensor) and t.dtype == F32
                         and t.device == op.device and t.is_contiguous()
                         and t.shape == ((op.k if name[0] == "B" else op.m),
                                         n)):
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        shape = (op.k if name.startswith("B") else op.m, n)
        if t.device != op.device:
            raise ValueError(f"{name} is on {t.device}, the operator on "
                             f"{op.device}")
        if t.dtype != F32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {F32}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        raise ValueError(f"{name} must be contiguous")


def structure_bytes(m: int, nnz: int, f64: bool) -> int:
    """Bytes of the operator in shared memory: row_ptr rounded up to 16
    bytes, then one record a term ({col, vh}, or {col, vh, vl, pad})."""
    return (m + 4) // 4 * 16 + nnz * (16 if f64 else 8)


def tma_addresses(planes: Sequence[torch.Tensor]) -> bool:
    """Whether TMA can address these [K, N] planes: N % 4 == 0, N < 2^31,
    every plane on 16 bytes (each box, so each row, starts on 16 bytes)."""
    n = planes[0].shape[1]
    return (n % 4 == 0 and n < 2 ** 31
            and not any(p.data_ptr() % 16 for p in planes))


def fits(op: SparseOperator, f64: bool, b_planes: int, c_planes: int,
         route: Route) -> bool:
    """Whether the kernel with ``b_planes`` B planes and ``c_planes`` C_in
    planes can run ``route`` on the operator: the kernel's own check
    (``xsmm_spgemm_fits``), so CUDA operators only."""
    if op.on_cpu:
        raise ValueError("fits: the kernels' shared-memory fit is the "
                         "card's; the operator is on the CPU")
    rc = _lib().xsmm_spgemm_fits(
        int(f64), b_planes, c_planes, op.m, op.k, op.nnz,
        STAGINGS.index(route[0]), STRUCTURES.index(route[1]),
        op.device.index)
    if rc < 0:
        raise ValueError(f"fits: codes refused for route {route!r}")
    return bool(rc)


def pick_route(op: SparseOperator, f64: bool,
               planes: Sequence[torch.Tensor], c_planes: int = 0) -> Route:
    """(staging, structure) of a launch of the operator on these B planes
    (the f64 kernels read vl too) and ``c_planes`` C_in planes: the
    structure in shared memory up to ``STRUCT_BUDGET``; B staged by TMA
    where it addresses the planes, else by cp.async, where the operator has
    a term and (on the card) the ring fits, else unstaged.  Kept a kind of
    launch on the operator."""
    global routes_picked
    key = (f64, len(planes), c_planes, tma_addresses(planes))
    route = op.routes.get(key)
    if route is None:
        routes_picked += 1
        structure = ("shared" if structure_bytes(op.m, op.nnz, f64)
                     <= STRUCT_BUDGET else "global")
        staging = "tma" if key[3] else "cp_async"
        if not op.nnz or (not op.on_cpu and not fits(
                op, f64, len(planes), c_planes, (staging, structure))):
            staging = "unstaged"
        route = op.routes[key] = (staging, structure)
    return route


def _route(op: SparseOperator, f64: bool, planes: Sequence[torch.Tensor],
           c_planes: int, route: Optional[Route]) -> Route:
    """``route`` checked by name (and "tma" against the planes), else
    ``pick_route``; the kernel checks the fit."""
    if route is None:
        return pick_route(op, f64, planes, c_planes)
    if (len(route) != 2 or route[0] not in STAGINGS
            or route[1] not in STRUCTURES):
        raise ValueError(f"route {route!r}: expected (staging, structure) "
                         f"from {STAGINGS} x {STRUCTURES}")
    if route[0] == "tma" and not tma_addresses(planes):
        raise ValueError(f"route {tuple(route)}: TMA needs N % 4 == 0, N < "
                         f"2^31 and B planes on 16 bytes")
    return tuple(route)


def _launch(fn, name: str, op: SparseOperator, n: int, route: Route,
            *ptrs) -> None:
    """Launch entry point ``fn`` of kernel ``name`` on ``route``; count it."""
    cuda_build.launch(fn, op.device, *ptrs, op.m, op.k, n, op.nnz,
                      STAGINGS.index(route[0]), STRUCTURES.index(route[1]),
                      refused=ROUTE_REFUSED)
    launches[name] += 1
    for part in route:
        route_launches[part] += 1


def _width(b: torch.Tensor) -> int:
    if not isinstance(b, torch.Tensor) or b.dim() != 2:
        raise ValueError("B must be a 2-D tensor [K, N]")
    return int(b.shape[1])


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic, all rows at once, term by term
# ---------------------------------------------------------------------------


def _sums_f32(op: SparseOperator, b: torch.Tensor) -> torch.Tensor:
    """acc = v[s]*b[c[s]], then acc + v[p]*b[c[p]], per row (0 where a row
    has no term)."""
    acc = torch.zeros((op.m, b.shape[1]), dtype=F32, device=b.device)
    for j, (rows, cols, idx) in enumerate(op.steps()):
        t = op.vh[idx, None] * b[cols]
        acc[rows] = t if j == 0 else acc[rows] + t
    return acc


def _sums_f64(op: SparseOperator, bh: torch.Tensor,
              bl: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of the f64 schedule: the first term sets hi = vh*bh and
    lo = vl*bh (+ vh*bl); later terms add vh*bh and (vh*bl + vl*bh) (or
    vl*bh)."""
    shape = (op.m, bh.shape[1])
    hi = torch.zeros(shape, dtype=F32, device=bh.device)
    lo = torch.zeros(shape, dtype=F32, device=bh.device)
    for j, (rows, cols, idx) in enumerate(op.steps()):
        vh, vl = op.vh[idx, None], op.vl[idx, None]
        bhr = bh[cols]
        th = vh * bhr
        if j == 0:
            tl = vl * bhr
            if bl is not None:
                tl = tl + vh * bl[cols]
            hi[rows], lo[rows] = th, tl
            continue
        hi[rows] = hi[rows] + th
        if bl is not None:
            lo[rows] = lo[rows] + (vh * bl[cols] + vl * bhr)
        else:
            lo[rows] = lo[rows] + vl * bhr
    return hi, lo


def unroll_f32_plain(op: SparseOperator, b: torch.Tensor) -> torch.Tensor:
    return _sums_f32(op, b)


def unroll_f64_plain(op: SparseOperator, bh: torch.Tensor,
                     bl: Optional[torch.Tensor] = None, *,
                     c_lo: bool) -> Out64:
    hi, lo = _sums_f64(op, bh, bl)
    return (hi, lo) if c_lo else hi + lo


def acc_f32_plain(op: SparseOperator, cin: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    return torch.where(op.nonempty(), cin + _sums_f32(op, b), cin)


def acc_f64_plain(op: SparseOperator, chin: torch.Tensor,
                  clin: Optional[torch.Tensor], bh: torch.Tensor,
                  bl: Optional[torch.Tensor] = None) -> Out64:
    hi, lo = _sums_f64(op, bh, bl)
    keep = op.nonempty()
    if clin is not None:
        return (torch.where(keep, chin + hi, chin),
                torch.where(keep, clin + lo, clin))
    return torch.where(keep, chin + (hi + lo), chin)


# ---------------------------------------------------------------------------
# Kernel 5: CsrSpgemm._build_unroll.kernel (xsmm_tpu/ops/spgemm.py:195)
# ---------------------------------------------------------------------------


def unroll_f32(op: SparseOperator, b: torch.Tensor, *,
               route: Optional[Route] = None) -> torch.Tensor:
    """C = A @ B in f32; rows of A without a term give 0.  ``route``
    (each wrapper's) forces a (staging, structure); one the kernel cannot
    run raises ``ValueError`` on either device."""
    with trace.span("wrapper"):
        n = _width(b)
        _check(op, {"B": b}, n)
        rt = _route(op, False, [b], 0, route)
        if op.on_cpu:
            return unroll_f32_plain(op, b)
        c = torch.empty((op.m, n), dtype=F32, device=op.device)
        if c.numel():
            _launch(_lib().xsmm_spgemm_unroll_f32, "spgemm_unroll_f32", op, n,
                    rt, *op.ptrs[:3], _ptr(b), _ptr(c))
        return c


# ---------------------------------------------------------------------------
# Kernel 6: CsrSpgemm._build_unroll.kernel64 (xsmm_tpu/ops/spgemm.py:233)
# ---------------------------------------------------------------------------


def unroll_f64(op: SparseOperator, bh: torch.Tensor,
               bl: Optional[torch.Tensor] = None, *, c_lo: bool,
               route: Optional[Route] = None) -> Out64:
    """f64 schedule on f32 planes: B-lo read when ``bl`` is given; returns
    (ch, cl) when ``c_lo``, else the folded hi + lo."""
    with trace.span("wrapper"):
        n = _width(bh)
        _check(op, {"Bh": bh, "Bl": bl}, n)
        rt = _route(op, True, [bh] if bl is None else [bh, bl], 0, route)
        if op.on_cpu:
            return unroll_f64_plain(op, bh, bl, c_lo=c_lo)
        ch = torch.empty((op.m, n), dtype=F32, device=op.device)
        cl = torch.empty_like(ch) if c_lo else None
        if ch.numel():
            _launch(_lib().xsmm_spgemm_unroll_f64, "spgemm_unroll_f64", op, n,
                    rt, *op.ptrs, _ptr(bh), _ptr(bl), _ptr(ch), _ptr(cl))
        return (ch, cl) if c_lo else ch


# ---------------------------------------------------------------------------
# Kernel 7: CsrSpgemm._build_acc.kernel (xsmm_tpu/ops/spgemm.py:322)
# ---------------------------------------------------------------------------


def acc_f32(op: SparseOperator, cin: torch.Tensor, b: torch.Tensor, *,
            route: Optional[Route] = None) -> torch.Tensor:
    """C = C_in + A @ B in f32 (a new tensor; C_in is not written); rows of
    A without a term keep C_in."""
    with trace.span("wrapper"):
        n = _width(b)
        _check(op, {"B": b, "C_in": cin}, n)
        rt = _route(op, False, [b], 1, route)
        if op.on_cpu:
            return acc_f32_plain(op, cin, b)
        c = torch.empty((op.m, n), dtype=F32, device=op.device)
        if c.numel():
            _launch(_lib().xsmm_spgemm_acc_f32, "spgemm_acc_f32", op, n, rt,
                    *op.ptrs[:3], _ptr(cin), _ptr(b), _ptr(c))
        return c


# ---------------------------------------------------------------------------
# Kernel 8: CsrSpgemm._build_acc.kernel64 (xsmm_tpu/ops/spgemm.py:363)
# ---------------------------------------------------------------------------


def acc_f64(op: SparseOperator, chin: torch.Tensor,
            clin: Optional[torch.Tensor], bh: torch.Tensor,
            bl: Optional[torch.Tensor] = None, *,
            route: Optional[Route] = None) -> Out64:
    """(ch, cl) = (ch_in + hi, cl_in + lo) when ``clin`` is given, else
    c = c_in + (hi + lo); B-lo read when ``bl`` is given.  New tensors;
    rows of A without a term keep C_in."""
    with trace.span("wrapper"):
        n = _width(bh)
        _check(op, {"Bh": bh, "Bl": bl, "Ch_in": chin, "Cl_in": clin}, n)
        rt = _route(op, True, [bh] if bl is None else [bh, bl],
                    1 if clin is None else 2, route)
        if op.on_cpu:
            return acc_f64_plain(op, chin, clin, bh, bl)
        ch = torch.empty((op.m, n), dtype=F32, device=op.device)
        cl = None if clin is None else torch.empty_like(ch)
        if ch.numel():
            _launch(_lib().xsmm_spgemm_acc_f64, "spgemm_acc_f64", op, n, rt,
                    *op.ptrs, _ptr(chin), _ptr(clin), _ptr(bh), _ptr(bl),
                    _ptr(ch), _ptr(cl))
        return ch if cl is None else (ch, cl)
