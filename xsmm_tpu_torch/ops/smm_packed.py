"""The batched-GEMM kernels: wrappers, plain versions, counts.

The three packed kernels take the lane-packed layout of
``xsmm_tpu/ops/smm.py`` (``BatchedSMM``), batch index innermost and
contiguous: A ``[M, K, Bp]``, B ``[K, N, Bp]``, C ``[M, N, Bp]``; any Bp.
The natural kernel (``natural_f32``) takes f32 problems in the caller's
batch-first layout, A ``[B, M, K]``, B ``[B, K, N]``, C ``[B, M, N]``, and
runs the packed f32 schedule on them with no pack: ``BatchedSMM.__call__``
takes it where its operands allow and an SM holds at least
``NATURAL_ROUTE_BLOCKS`` of its blocks (``natural_blocks``).

Each wrapper checks device, dtype, shape and contiguity, then:

* on CUDA tensors it allocates the outputs with ``torch.empty``, launches
  its kernel (``ops/csrc/smm_packed.cu``) on the current stream, raises if
  the launch returned a CUDA error, and adds one to ``launches[name]`` and
  to ``staging_launches`` under the staging the launch took (``staging``);
* on CPU tensors it runs its plain PyTorch version (``*_plain``), which
  repeats the kernel's arithmetic term by term in the same order.

Any other device raises.  There is no fallback from a CUDA tensor.

Stagings (``staging``): f32 planes take the tile kernel, staged by TMA
("tma") where Bp % 4 == 0 and every input plane starts on 16 bytes, else by
cp.async one element a copy ("cp.async"); 16-bit inputs take the first
design ("first").  The natural kernel stages whole groups of four problems
by bulk copies ("bulk") where every operand starts on 16 bytes, else by
cp.async one element a copy ("cp.async"; a ragged last group of a "bulk"
launch is staged so too).  The wrapper names the staging and the C side
checks it against the planes: a mismatch, or planes whose TMA tensor maps
cannot be encoded, is refused with nothing launched and raises
``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..utils import trace
from . import cuda_build
from .cuda_build import I, LL, P, ptr

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {"packed_f32": 0, "packed_split2_fast": 0,
                            "packed_split2": 0, "natural_f32": 0}

# stagings -> their codes in ops/csrc/smm_packed.cu (enum Staging), and
# launches since the last reset_launches() (each also counts in launches)
STAGINGS = {"tma": 0, "cp.async": 1, "first": 2, "bulk": 3}
staging_launches: Dict[str, int] = dict.fromkeys(STAGINGS, 0)
STAGING_REFUSED = ("the staging does not fit the planes, or their TMA tensor "
                   "maps could not be encoded; nothing was launched")

# dtype codes of core/descriptors.py, for the types the f32 schedule takes
_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}


def reset_launches() -> None:
    for counts in (launches, staging_launches):
        for name in counts:
            counts[name] = 0


_lib = cuda_build.bind("smm_packed", {
    "xsmm_packed_f32": [P, P, P, P, I, I, I, LL, I, I, I, I, P],
    "xsmm_natural_f32": [P, P, P, P, I, I, I, LL, I, I, I, I, P],
    "xsmm_packed_split2_fast": [P, P, P, P, P, I, I, I, LL, I, I, P],
    "xsmm_packed_split2": [P, P, P, P, P, P, P, P, I, I, I, LL, I, I, P],
})


def staging(*planes: torch.Tensor) -> str:
    """The staging a CUDA launch on these input planes (A and B, [.., ..,
    Bp]) takes: "first" for 16-bit inputs; for f32 "tma" where Bp % 4 == 0
    and every plane starts on 16 bytes, else "cp.async"."""
    if planes[0].dtype != torch.float32:
        return "first"
    if planes[0].shape[2] % 4 or any(p.data_ptr() % 16 for p in planes):
        return "cp.async"
    return "tma"


def _launch(fn, name: str, planes, *args) -> None:
    """Launch ``fn(*args, staging code, ...)`` for kernel ``name`` on the
    staging ``planes`` take, and count it."""
    st = staging(*planes)
    cuda_build.launch(fn, planes[0].device, *args, STAGINGS[st],
                      refused=STAGING_REFUSED)
    launches[name] += 1
    staging_launches[st] += 1


def _shapes(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int, int]:
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"packed operands must be 3-D, got A{tuple(a.shape)}"
                         f" B{tuple(b.shape)}")
    m, k, bp = a.shape
    k2, n, bp2 = b.shape
    if k2 != k or bp2 != bp:
        raise ValueError(f"packed shapes disagree: A[M,K,Bp]={tuple(a.shape)}"
                         f" B[K,N,Bp]={tuple(b.shape)}")
    if k < 1:
        raise ValueError("packed kernels need K >= 1")
    return m, n, k, bp


def _check(device: torch.device,
           ops: Dict[str, Tuple[Optional[torch.Tensor], torch.dtype, tuple]]
           ) -> None:
    """Each named operand (tensor or None, dtype, shape) must be a
    contiguous tensor of that dtype and shape on ``device``."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"packed kernels run on cuda or cpu, not {device}")
    for name, (t, dtype, shape) in ops.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, A is on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# Kernel 2: _make_packed_kernel_f32 (xsmm_tpu/ops/smm.py:193)
# ---------------------------------------------------------------------------


def packed_f32_plain(a, b, cin=None, *, out_dtype):
    """C (+)= sum_k A[:,k]*B[k] with the running sum held in ``out_dtype``:
    each product f32(a)*f32(b) is rounded to ``out_dtype`` and then added
    (and rounded) — bf16 -> bf16 rounds at every k step."""
    af, bf = a.float(), b.float()
    c = None if cin is None else cin.to(out_dtype)
    for kk in range(a.shape[1]):
        p = (af[:, kk, None, :] * bf[kk, None, :, :]).to(out_dtype)
        c = p if c is None else (c.float() + p.float()).to(out_dtype)
    return c


def packed_f32(a: torch.Tensor, b: torch.Tensor,
               cin: Optional[torch.Tensor] = None, *,
               out_dtype: torch.dtype) -> torch.Tensor:
    """One-product schedule: A, B in f32/bf16/f16, C in ``out_dtype``
    (f32/bf16/f16); ``cin`` (beta = 1) in ``out_dtype``."""
    with trace.span("wrapper"):
        m, n, k, bp = _shapes(a, b)
        if a.dtype not in _CODES or out_dtype not in _CODES:
            raise ValueError(f"packed_f32 takes {list(_CODES)} in and out, "
                             f"got {a.dtype} -> {out_dtype}")
        _check(a.device, {"A": (a, a.dtype, (m, k, bp)),
                          "B": (b, a.dtype, (k, n, bp)),
                          "C_in": (cin, out_dtype, (m, n, bp))})
        if a.device.type == "cpu":
            return packed_f32_plain(a, b, cin, out_dtype=out_dtype)
        c = torch.empty((m, n, bp), dtype=out_dtype, device=a.device)
        if c.numel():
            _launch(_lib().xsmm_packed_f32, "packed_f32", (a, b), ptr(a),
                    ptr(b), ptr(cin), ptr(c), m, n, k, bp,
                    _CODES[a.dtype], _CODES[out_dtype])
        return c


# ---------------------------------------------------------------------------
# Kernel 1: _make_packed_kernel_split2_fast (xsmm_tpu/ops/smm.py:296)
# ---------------------------------------------------------------------------


def packed_split2_fast_plain(ah, bh, bl, cin=None):
    """hi = (c_in +) sum ah*bh; lo = sum ah*bl, kept apart; C = hi + lo."""
    hi, lo = cin, None
    for kk in range(ah.shape[1]):
        a_k = ah[:, kk, None, :]
        th, tl = a_k * bh[kk, None, :, :], a_k * bl[kk, None, :, :]
        hi = th if hi is None else hi + th
        lo = tl if lo is None else lo + tl
    return hi + lo


def packed_split2_fast(ah: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor,
                       cin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Default f64 schedule on f32 hi/lo planes: (ah, bh, bl[, c_in]) -> C."""
    with trace.span("wrapper"):
        m, n, k, bp = _shapes(ah, bh)
        f32 = torch.float32
        _check(ah.device, {"Ah": (ah, f32, (m, k, bp)),
                           "Bh": (bh, f32, (k, n, bp)),
                           "Bl": (bl, f32, (k, n, bp)),
                           "C_in": (cin, f32, (m, n, bp))})
        if ah.device.type == "cpu":
            return packed_split2_fast_plain(ah, bh, bl, cin)
        c = torch.empty((m, n, bp), dtype=f32, device=ah.device)
        if c.numel():
            _launch(_lib().xsmm_packed_split2_fast, "packed_split2_fast",
                    (ah, bh, bl), ptr(ah), ptr(bh), ptr(bl), ptr(cin),
                    ptr(c), m, n, k, bp)
        return c


# ---------------------------------------------------------------------------
# Kernel 3: _make_packed_kernel_split2 (xsmm_tpu/ops/smm.py:251)
# ---------------------------------------------------------------------------


def packed_split2_plain(ah, al, bh, bl, chin=None, clin=None):
    """ch = (ch_in +) sum ah*bh; cl = (cl_in +) sum (ah*bl + al*bh)."""
    ch, cl = chin, clin
    for kk in range(ah.shape[1]):
        ah_k, al_k = ah[:, kk, None, :], al[:, kk, None, :]
        bh_k, bl_k = bh[kk, None, :, :], bl[kk, None, :, :]
        th = ah_k * bh_k
        tl = ah_k * bl_k + al_k * bh_k
        ch = th if ch is None else ch + th
        cl = tl if cl is None else cl + tl
    return ch, cl


def packed_split2(ah: torch.Tensor, al: torch.Tensor, bh: torch.Tensor,
                  bl: torch.Tensor, chin: Optional[torch.Tensor] = None,
                  clin: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three-product f64 schedule: (ah, al, bh, bl[, ch_in, cl_in]) ->
    (ch, cl), joined in f64 by the caller."""
    with trace.span("wrapper"):
        m, n, k, bp = _shapes(ah, bh)
        if (chin is None) != (clin is None):
            raise ValueError("split2 takes both C halves or neither")
        f32 = torch.float32
        _check(ah.device, {"Ah": (ah, f32, (m, k, bp)),
                           "Al": (al, f32, (m, k, bp)),
                           "Bh": (bh, f32, (k, n, bp)),
                           "Bl": (bl, f32, (k, n, bp)),
                           "Ch_in": (chin, f32, (m, n, bp)),
                           "Cl_in": (clin, f32, (m, n, bp))})
        if ah.device.type == "cpu":
            return packed_split2_plain(ah, al, bh, bl, chin, clin)
        ch = torch.empty((m, n, bp), dtype=f32, device=ah.device)
        cl = torch.empty_like(ch)
        if ch.numel():
            _launch(_lib().xsmm_packed_split2, "packed_split2",
                    (ah, al, bh, bl), ptr(ah), ptr(al), ptr(bh), ptr(bl),
                    ptr(chin), ptr(clin), ptr(ch), ptr(cl), m, n, k, bp)
        return ch, cl


# ---------------------------------------------------------------------------
# The natural kernel: kernel 2's f32 schedule on batch-first operands, with
# BatchedSMM.pack_a / pack_b / unpack_c fused in (it replaces no TPU kernel)
# ---------------------------------------------------------------------------

# problems a group, slots of a block's ring and columns of C a pass: NAT_G,
# NAT_SLOTS and NAT_NT of ops/csrc/smm_packed.cu; the shared memory a block
# may have: BLOCK_SMEM_MAX of ops/csrc/launch.cuh (tests/test_torch_smm.py
# reads both)
NATURAL_GROUP = 4
NATURAL_SLOTS = 2
NATURAL_COLUMNS = 24
NATURAL_MAX_SMEM = 232448
# an H100 SM's shared memory, of which each block reserves 1 KB
NATURAL_SM_SMEM = NATURAL_MAX_SMEM + 1024
# the fewest blocks an SM must hold for BatchedSMM to take the natural
# kernel: at 3 and more it beat the pack route at every shape timed on the
# H100 (2.1-12x); at 1-2 it ran 0.36-2.9x the pack route's speed (PERF.md)
NATURAL_ROUTE_BLOCKS = 3
NATURAL_REFUSED = ("the staging does not fit the operands, or the ring of "
                   "groups does not fit a block's shared memory; nothing "
                   "was launched")


def natural_smem(m: int, n: int, k: int) -> int:
    """Shared memory of a natural launch (natural_smem in
    ops/csrc/smm_packed.cu): the ring's slots, each a group's A, B and C in
    f32, their mbarriers, and a pass's columns of padding; at 23^3 a slot
    is 25,392 bytes."""
    slot = NATURAL_GROUP * (m * k + k * n + m * n) * 4
    return NATURAL_SLOTS * (slot + 8) + NATURAL_COLUMNS * 4


def natural_blocks(m: int, n: int, k: int) -> int:
    """Blocks of the natural kernel an SM holds at this shape: 0 where its
    ring does not fit a block (the launch is refused), 4 at 23^3."""
    smem = natural_smem(m, n, k)
    if smem > NATURAL_MAX_SMEM:
        return 0
    return NATURAL_SM_SMEM // (smem + 1024)


def natural_staging(*ops: Optional[torch.Tensor]) -> str:
    """The staging a natural launch on these operands (A, B, C_in, C) takes:
    "bulk" where every one starts on 16 bytes, else "cp.async"."""
    return ("cp.async" if any(t is not None and t.data_ptr() % 16
                              for t in ops) else "bulk")


def _natural_shapes(a: torch.Tensor, b: torch.Tensor, trans_a: bool,
                    trans_b: bool) -> Tuple[int, int, int, int]:
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"natural operands must be 3-D, got "
                         f"A{tuple(a.shape)} B{tuple(b.shape)}")
    nb, m, k = a.shape
    if trans_a:
        m, k = k, m
    nb2, k2, n = b.shape
    if trans_b:
        k2, n = n, k2
    if k2 != k or nb2 != nb:
        raise ValueError(f"natural shapes disagree: A{tuple(a.shape)} "
                         f"B{tuple(b.shape)} (trans_a={trans_a}, "
                         f"trans_b={trans_b})")
    if k < 1:
        raise ValueError("the natural kernel needs K >= 1")
    return nb, m, n, k


def natural_f32_plain(a, b, cin=None, *, trans_a=False, trans_b=False):
    """C (+)= sum_k A[:, :, k] * B[:, k, :] in f32, each product and each sum
    rounded, k ascending: ``packed_f32_plain``'s terms in the batch-first
    layout."""
    a = a.transpose(1, 2) if trans_a else a
    b = b.transpose(1, 2) if trans_b else b
    c = cin
    for kk in range(a.shape[2]):
        p = a[:, :, kk, None] * b[:, None, kk, :]
        c = p if c is None else c + p
    return c


def natural_f32(a: torch.Tensor, b: torch.Tensor,
                cin: Optional[torch.Tensor] = None, *, trans_a: bool = False,
                trans_b: bool = False) -> torch.Tensor:
    """f32 A ``[B, M, K]`` (``[B, K, M]`` with ``trans_a``), B ``[B, K, N]``
    (``[B, N, K]`` with ``trans_b``), ``cin`` ``[B, M, N]`` (beta = 1) ->
    C ``[B, M, N]``, contiguous; the bits of
    ``packed_f32(pack_a(a), pack_b(b), pack_c(cin))`` unpacked."""
    with trace.span("wrapper"):
        nb, m, n, k = _natural_shapes(a, b, trans_a, trans_b)
        f32 = torch.float32
        _check(a.device, {"A": (a, f32, tuple(a.shape)),
                          "B": (b, f32, tuple(b.shape)),
                          "C_in": (cin, f32, (nb, m, n))})
        if a.device.type == "cpu":
            return natural_f32_plain(a, b, cin, trans_a=trans_a,
                                     trans_b=trans_b)
        c = torch.empty((nb, m, n), dtype=f32, device=a.device)
        if c.numel():
            st = natural_staging(a, b, cin, c)
            cuda_build.launch(_lib().xsmm_natural_f32, a.device, ptr(a),
                              ptr(b), ptr(cin), ptr(c), m, n, k, nb,
                              int(trans_a), int(trans_b), STAGINGS[st],
                              refused=NATURAL_REFUSED)
            launches["natural_f32"] += 1
            staging_launches[st] += 1
        return c
