"""The four packed-LA kernels (GETRF and TRSM): wrappers, plain versions,
counts.

Operands use the lane-packed layout of ``xsmm_tpu/ops/packed.py``, batch
index innermost and contiguous: GETRF A and LU ``[M, N, Bp]``; TRSM A
``[SM, SM, Bp]`` (the left operator: tril(A), or triu(A) with
``upper=True``), B and X ``[SM, SN, Bp]``; any Bp, float32.

Each TRSM kernel has an upper variant (``upper=True``): the backward solve
on triu(A), which reads A, B and X in place with row i at SM-1-i, so that
it solves on getrf's packed factors with no copy.  Its arithmetic is the
lower kernel's on the reversed order (``*_upper_plain``), the same bits as
the lower kernel on flipped copies.  Each triangle counts in ``launches``
under its own name (``trsm_loop`` and ``trsm_loop_upper``).

Each wrapper checks device, dtype, shape and contiguity (inside the span
``wrapper``), then:

* on CUDA tensors it allocates the output with ``torch.empty``, launches
  its kernel (``ops/csrc/packed.cu``) on the current stream, raises if the
  launch returned a CUDA error, and adds one to ``launches[name]``;
* on CPU tensors it runs its plain PyTorch version (``*_plain``), which
  repeats the JAX kernel's arithmetic in the JAX kernel's order, each
  product and sum rounded on its own, so that kernel and plain version
  agree bit for bit.

Any other device raises.  There is no fallback from a CUDA tensor.  The
kernels take sizes above the register buckets (64) through a block per
problem with the matrix in shared memory; ``packed.cu`` alone decides what
fits, and refuses sizes that do not fit a block's shared memory before any
launch, which ``cuda_build.launch`` raises as ``ValueError``.

Kernel 12 (``getrf_loop``) has two routes (``getrf_route``): "tile", for
65 <= min(M, N) and max(M, N) <= 128 (the p = 4 hexahedron's 125 x 125),
and "shared", the matrix in shared memory with one barrier pair a pivot
step, for every other size that fits.  The tile route is a right-looking LU
blocked by panels of 8 columns, a block a problem, the matrix held once in
shared memory, three blocks an SM: warp 0 factors a panel's diagonal block
in registers, a thread a column or a row takes U's rows right of it and L's
rows below it, and every thread takes the panel's 8 terms on an 8 x 4 block
of the trailing matrix in one pass, while warp 0 factors the next diagonal
block (two barriers a panel).  What bounds it at 125 x 125, B = 131072, is
4.89 ms of bytes beside ~5.0 ms of FP32 issue with multiply and subtract
rounded apart; the blocked schedule keeps each element's terms in pivot
order, so both routes give the plain version's bits.  ``_getrf_loop`` names the route (for the card tests and
``kernel_profile``, which hold each route against the plain version); the
kernel refuses "tile" outside its sizes, which raises ``ValueError`` with
nothing launched.  Each launch also counts in ``getrf_route_launches``.

Kernels 13 and 14 and their upper variants have two routes
(``trsm_route``, from SM, SN and Bp alone): "narrow", a thread a (problem,
column of X) (the register buckets at small SM and many columns, else the
triangle streamed from the pack), for right sides of few columns, and
"chunk", a block a problem and chunk of 128 columns, for wide ones.  Both take SM <= 256 and
give the same bits (each row's terms in its plain version's order).
``_trsm`` names the route (the card tests, ``kernel_profile``); each launch
also counts in ``trsm_route_launches``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..utils import trace
from . import cuda_build
from .cuda_build import I, LL, P

# kernel name -> launches since the last reset_launches(); the TRSM kernels'
# upper variants count apart
launches: Dict[str, int] = {"getrf_unrolled": 0, "getrf_loop": 0,
                            "trsm_unrolled": 0, "trsm_loop": 0,
                            "trsm_unrolled_upper": 0, "trsm_loop_upper": 0}

# kernel 12's routes -> their codes in ops/csrc/packed.cu, and launches
# since the last reset_launches() (each also counts in launches["getrf_loop"])
GETRF_ROUTES = {"shared": 0, "tile": 1}
getrf_route_launches: Dict[str, int] = dict.fromkeys(GETRF_ROUTES, 0)
GETRF_TILE_SIZES = (65, 128)  # the tile route's min(M, N) and max(M, N)
GETRF_TILE_REFUSED = ("the tile route takes 65 <= min(M, N) and max(M, N) <= "
                      "128; nothing was launched")

# the TRSM kernels' routes -> their codes in ops/csrc/packed.cu, and launches
# since the last reset_launches() (each also counts in launches[name])
TRSM_ROUTES = {"chunk": 0, "narrow": 1}
trsm_route_launches: Dict[str, int] = dict.fromkeys(TRSM_ROUTES, 0)
TRSM_MAX = 256           # the largest SM of either route
TRSM_NARROW_SM = 64      # up to this SM the narrow route takes any SN
TRSM_NARROW_WORK = 48 * 128 * 128  # above it, SN * SM^2 up to this
TRSM_REFUSED = {"narrow": f"the narrow route takes SM <= {TRSM_MAX}, the "
                          "sizes the chunk route's shared memory holds; "
                          "nothing was launched", "chunk": None}


def reset_launches() -> None:
    for counts in (launches, getrf_route_launches, trsm_route_launches):
        for name in counts:
            counts[name] = 0


_lib = cuda_build.bind("packed", {
    "xsmm_getrf_unrolled": [P, P, I, I, LL, I, P],
    "xsmm_getrf_loop": [P, P, I, I, LL, I, I, P],
    "xsmm_trsm_unrolled": [P, P, P, I, I, LL, I, I, I, P],
    "xsmm_trsm_loop": [P, P, P, I, I, LL, I, I, I, P],
    "xsmm_trsm_unrolled_upper": [P, P, P, I, I, LL, I, I, I, P],
    "xsmm_trsm_loop_upper": [P, P, P, I, I, LL, I, I, I, P],
})


def _check(name: str, t, device: Optional[torch.device] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"packed kernels run on cuda or cpu, not {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, A is on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if t.dim() != 3:
        raise ValueError(f"{name}: packed operands are 3-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _trsm_shapes(a: torch.Tensor, b: torch.Tensor):
    _check("A", a)
    _check("B", b, a.device)
    sm, sm2, bp = a.shape
    if sm2 != sm or b.shape[0] != sm or b.shape[2] != bp:
        raise ValueError(f"packed shapes disagree: A[SM,SM,Bp]="
                         f"{tuple(a.shape)} B[SM,SN,Bp]={tuple(b.shape)}")
    return sm, b.shape[1], bp


# ---------------------------------------------------------------------------
# Kernel 11: _getrf_kernel_unrolled (xsmm_tpu/ops/packed.py:66)
# ---------------------------------------------------------------------------


def getrf_unrolled_plain(a: torch.Tensor) -> torch.Tensor:
    """Unpivoted LU, one reciprocal per pivot: l = a[k+1:, k] * (1/a[k,k]),
    then the trailing block less l * a[k, k+1:]; stops at k + 1 >= M."""
    o = a.clone()
    m, n = a.shape[:2]
    for k in range(min(m, n)):
        if k + 1 >= m:
            break
        l = o[k + 1:, k] * torch.reciprocal(o[k, k])[None, :]
        o[k + 1:, k] = l
        if k + 1 < n:
            o[k + 1:, k + 1:] = (o[k + 1:, k + 1:]
                                 - l[:, None, :] * o[k, k + 1:][None])
    return o


def getrf_unrolled(a: torch.Tensor) -> torch.Tensor:
    """LU [M, N, Bp] of A [M, N, Bp] (unit L below the diagonal, U on and
    above it), kernel 11's arithmetic."""
    with trace.span("wrapper"):
        _check("A", a)
        if a.device.type == "cpu":
            return getrf_unrolled_plain(a)
        m, n, bp = a.shape
        o = torch.empty_like(a)
        if o.numel():
            cuda_build.launch(_lib().xsmm_getrf_unrolled, a.device,
                              a.data_ptr(), o.data_ptr(), m, n, bp)
            launches["getrf_unrolled"] += 1
        return o


# ---------------------------------------------------------------------------
# Kernel 12: _getrf_kernel (xsmm_tpu/ops/packed.py:104)
# ---------------------------------------------------------------------------


def getrf_loop_plain(a: torch.Tensor) -> torch.Tensor:
    """The same LU with the column divided by the pivot:
    l = a[k+1:, k] / a[k,k]."""
    o = a.clone()
    m, n = a.shape[:2]
    for k in range(min(m, n)):
        if k + 1 >= m:
            break  # the JAX loop's later steps change nothing
        l = o[k + 1:, k] / o[k, k][None, :]
        o[k + 1:, k] = l
        if k + 1 < n:
            o[k + 1:, k + 1:] = (o[k + 1:, k + 1:]
                                 - l[:, None, :] * o[k, k + 1:][None])
    return o


def getrf_route(m: int, n: int) -> str:
    """The route a CUDA call of ``getrf_loop`` takes for M x N: "tile"
    where 65 <= min(M, N) and max(M, N) <= 128, else "shared"."""
    lo, hi = GETRF_TILE_SIZES
    return "tile" if min(m, n) >= lo and max(m, n) <= hi else "shared"


def getrf_loop(a: torch.Tensor) -> torch.Tensor:
    """LU [M, N, Bp] of A [M, N, Bp], kernel 12's arithmetic, on the card
    on the route ``getrf_route(M, N)`` picks."""
    return _getrf_loop(a, None)


def _getrf_loop(a: torch.Tensor, route: Optional[str]) -> torch.Tensor:
    """``getrf_loop`` on a named route (None: ``getrf_route(M, N)``); the
    CPU ignores it."""
    with trace.span("wrapper"):
        _check("A", a)
        if route is not None and route not in GETRF_ROUTES:
            raise ValueError(f"route {route!r}: expected one of "
                             f"{list(GETRF_ROUTES)}")
        if a.device.type == "cpu":
            return getrf_loop_plain(a)
        m, n, bp = a.shape
        rt = route or getrf_route(m, n)
        o = torch.empty_like(a)
        if o.numel():
            cuda_build.launch(_lib().xsmm_getrf_loop, a.device, a.data_ptr(),
                              o.data_ptr(), m, n, bp, GETRF_ROUTES[rt],
                              refused=(GETRF_TILE_REFUSED if rt == "tile"
                                       else None))
            launches["getrf_loop"] += 1
            getrf_route_launches[rt] += 1
        return o


# ---------------------------------------------------------------------------
# Kernel 13: _trsm_kernel_unrolled (xsmm_tpu/ops/packed.py:196)
# ---------------------------------------------------------------------------


def trsm_unrolled_plain(a: torch.Tensor, b: torch.Tensor,
                        unit: bool) -> torch.Tensor:
    """Right-looking forward substitution: row i of X times 1/a[i,i]
    (unless unit), then the rows below less a[r,i] * x[i]."""
    x = b.clone()
    sm = a.shape[0]
    for i in range(sm):
        xi = x[i]
        if not unit:
            xi = xi * torch.reciprocal(a[i, i])[None, :]
            x[i] = xi
        if i + 1 < sm:
            x[i + 1:] = x[i + 1:] - a[i + 1:, i][:, None, :] * xi[None]
    return x


def trsm_unrolled_upper_plain(a: torch.Tensor, b: torch.Tensor,
                              unit: bool) -> torch.Tensor:
    """``trsm_unrolled_plain`` on triu(A), backward: from the last row up,
    row i of X times 1/a[i,i] (unless unit), then the rows above less
    a[r,i] * x[i]."""
    x = b.clone()
    for i in reversed(range(a.shape[0])):
        xi = x[i]
        if not unit:
            xi = xi * torch.reciprocal(a[i, i])[None, :]
            x[i] = xi
        if i > 0:
            x[:i] = x[:i] - a[:i, i][:, None, :] * xi[None]
    return x


def trsm_route(sm: int, sn: int, bp: int) -> str:
    """The route a CUDA call of ``trsm_unrolled`` or ``trsm_loop`` (either
    triangle) takes for A [SM, SM, Bp], B [SM, SN, Bp]: "narrow" up to SM
    ``TRSM_NARROW_SM`` and, above, while SN * SM^2 <= ``TRSM_NARROW_WORK``;
    else "chunk".

    The narrow route reads the triangle once a column, the chunk route once
    a chunk of 128 columns, so the edge falls with SM^2.  On the H100, both
    solves at B = 4096 and 131072: narrow faster at every SN up to 128 for
    SM <= 65, up to 64 at 96, 48 at 125; chunk faster from 96 at 96 and 64
    at 125 and 128 (48 at 128 a tie); at 125/1, B = 131072, 1.59 ms against
    29.7 (``PERF.md`` §6, row 14).  Bp moved no edge."""
    return ("narrow" if sm <= TRSM_NARROW_SM
            or sn * sm * sm <= TRSM_NARROW_WORK else "chunk")


def _trsm(kernel: str, a: torch.Tensor, b: torch.Tensor, unit: bool,
          upper: bool, route: Optional[str] = None) -> torch.Tensor:
    """Kernel 13 or 14 (``kernel``), or its upper variant: X [SM, SN, Bp]
    with tril(A) X = B, or triu(A) X = B where ``upper``, on the named
    route (None: ``trsm_route``); the CPU ignores the route."""
    name = kernel + "_upper" if upper else kernel
    with trace.span("wrapper"):
        sm, sn, bp = _trsm_shapes(a, b)
        if route is not None and route not in TRSM_ROUTES:
            raise ValueError(f"route {route!r}: expected one of "
                             f"{list(TRSM_ROUTES)}")
        if a.device.type == "cpu":
            plain = {"trsm_unrolled": trsm_unrolled_plain,
                     "trsm_unrolled_upper": trsm_unrolled_upper_plain,
                     "trsm_loop": trsm_loop_plain,
                     "trsm_loop_upper": trsm_loop_upper_plain}[name]
            return plain(a, b, unit)
        rt = route or trsm_route(sm, sn, bp)
        x = torch.empty_like(b)
        if x.numel():
            cuda_build.launch(getattr(_lib(), "xsmm_" + name), a.device,
                              a.data_ptr(), b.data_ptr(), x.data_ptr(), sm,
                              sn, bp, int(unit), TRSM_ROUTES[rt],
                              refused=TRSM_REFUSED[rt])
            launches[name] += 1
            trsm_route_launches[rt] += 1
        return x


def trsm_unrolled(a: torch.Tensor, b: torch.Tensor, unit: bool,
                  upper: bool = False) -> torch.Tensor:
    """X [SM, SN, Bp] with tril(A) X = B (unit diagonal if ``unit``), or
    triu(A) X = B where ``upper``, kernel 13's arithmetic."""
    return _trsm("trsm_unrolled", a, b, unit, upper)


# ---------------------------------------------------------------------------
# Kernel 14: _trsm_kernel (xsmm_tpu/ops/packed.py:219)
# ---------------------------------------------------------------------------


def trsm_loop_plain(a: torch.Tensor, b: torch.Tensor,
                    unit: bool) -> torch.Tensor:
    """Left-looking substitution: x[i] = (b[i] - s[i]) / a[i,i], where
    s[i] = sum_{r<i} a[i,r] * x[r] is summed from 0 in r order (kept as a
    running sum for every row, one term a step)."""
    x = torch.empty_like(b)
    s = torch.zeros_like(b)
    sm = a.shape[0]
    for i in range(sm):
        xi = b[i] - s[i]
        if not unit:
            xi = xi / a[i, i][None, :]
        x[i] = xi
        if i + 1 < sm:
            s[i + 1:] = s[i + 1:] + a[i + 1:, i][:, None, :] * xi[None]
    return x


def trsm_loop_upper_plain(a: torch.Tensor, b: torch.Tensor,
                          unit: bool) -> torch.Tensor:
    """Backward substitution, ``trsm_loop_plain`` on triu(A) from the last
    row up: x[i] = (b[i] - s[i]) / a[i,i], where s[i] = sum_{r>i} a[i,r] *
    x[r] is summed from r = SM-1 down (a running sum for every row, one
    term a step)."""
    x = torch.empty_like(b)
    s = torch.zeros_like(b)
    for i in reversed(range(a.shape[0])):
        xi = b[i] - s[i]
        if not unit:
            xi = xi / a[i, i][None, :]
        x[i] = xi
        if i > 0:
            s[:i] = s[:i] + a[:i, i][:, None, :] * xi[None]
    return x


def trsm_loop(a: torch.Tensor, b: torch.Tensor, unit: bool,
              upper: bool = False) -> torch.Tensor:
    """X [SM, SN, Bp] with tril(A) X = B, or triu(A) X = B where
    ``upper``, kernel 14's arithmetic."""
    return _trsm("trsm_loop", a, b, unit, upper)

