"""The RNN sequence kernels (LSTM, GRU, simple RNN), forward and backward:
wrappers, plain versions, counts.

The counterpart of ``xsmm_tpu/dnn/rnn_seq.py``, with its signatures and
return tuples (``k`` and ``prec`` follow from the operands' shapes and R's
dtype).  The forward's operands, all contiguous, on one device:
``zx [T, N, G*K]`` f32 (``x @ W + b`` for every step, computed by the
caller), ``r [K, G*K]`` f32 or bf16, ``h0`` (and ``c0``) ``[N, K]`` f32;
T, N, K >= 1.  G = 4 gates (i, g, f, o) for the LSTM, 3 (r, z, g) for the
GRU, 1 for the simple RNN.

Each wrapper checks device, dtype, shape and contiguity, then:

* on CUDA tensors it allocates the outputs and the h-exchange scratch with
  ``torch.empty``, launches its kernel (``ops/csrc/rnn_seq.cu``, one
  persistent cooperative launch for all T steps) on the current stream,
  raises if the launch returned an error, and adds one to
  ``launches[name]`` (and, for the train form, to ``train_launches``);
* on CPU tensors it runs its plain PyTorch version (``*_plain``), a loop
  over T in the JAX kernel's arithmetic.

Any other device raises.  There is no fallback from a CUDA tensor: a shape
outside the kernel's envelope is refused before any launch
(``cuda_build.launch`` raises ``ValueError``); ``seq_kernel_ok`` tells the
caller beforehand, from the envelope ``rnn_seq.cu`` itself reports.

Numerics, as the JAX kernel's ``_dot``: with f32 R the product is full f32
(the kernel's split form sums each output in another order than the plain
version's product, whose own order is cuBLAS's and changes with the shape:
the two agree to f32 rounding a step; a recurrence that expands, such as
the simple RNN's tanh over R of gain above 1, carries that difference
further over many steps, as it carries any other order's); with bf16 R, h
is rounded to bf16 before the product and the products of the bf16 values,
exact in f32, are summed in f32 in k order, by kernel (its chain and wide
forms, on FFMA) and plain version alike.  The gate math is f32, each
product and sum rounded on its own.  A recurrence over bf16-rounded h
amplifies any difference of one f32 ulp into a different bf16 rounding a
few steps later, so kernel and plain version are built to agree bit for
bit in the bf16 cells, not merely to f32 rounding; a tensor-core product,
which sums in blocks of 16 k, measured at or past the 1e-3 gate and is not
used.  ``form_launches`` counts the form of each forward launch, as the
entry point returns it.

The backward wrappers (``lstm_seq_bwd``, ``gru_seq_bwd``, ``rnn_seq_bwd``)
walk t = T-1 .. 0 over the forward's residuals ([T, N, K] f32) and R^T
``rt [G*K, K]`` f32 or bf16, emit dz in ``dz_dt`` (f32 or bf16) and sum db
in f32 from the unrounded dz; they are counted in ``bwd_launches`` and
routed by ``seq_bwd_kernel_ok``.  Their product dz @ R^T rounds dz to R's
dtype, as the JAX ``_dot``; with bf16 R the exact products are summed in
f32 in the kernel's order (``_dz_rt``), and db is summed in the kernel's
order at any N (``_db_groups``, ``_db``), so kernel and plain version
agree bit for bit on dz, dh0, dc0 and db.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, List, Optional

import torch

from ..core import platform
from ..ops import cuda_build
from ..ops.cuda_build import I, P, ptr
from ..ops.smm import _matmul

# kernel name -> launches since the last reset_launches(); train_launches
# counts the launches of the residual-emitting form among them
launches: Dict[str, int] = {"lstm_seq": 0, "gru_seq": 0, "rnn_seq": 0}
train_launches: Dict[str, int] = {"lstm_seq": 0, "gru_seq": 0}
bwd_launches: Dict[str, int] = {"lstm_seq_bwd": 0, "gru_seq_bwd": 0,
                                "rnn_seq_bwd": 0}
# the forward launches by the kernel's form, its own choice (rnn_seq.cu
# fwd_form), as its entry point returns it: "split" (f32 R where it fits:
# the k range split over a block's warps, their partial sums added in warp
# order), "chain" (bf16 R, and f32 R beyond the split form's envelope: one
# FMA chain in k order per output, 16 units a block) or "wide" (bf16 R
# where the first design's geometry, 4 x 4 tiles on 4 warps, fills the card:
# k order too)
FORMS = ("chain", "split", "wide")
form_launches: Dict[str, int] = dict.fromkeys(FORMS, 0)

# the backward kernels' orders (rnn_seq.cu: BwdGeo's BU, BROWS, by gate
# count): dz @ R^T is summed per block of BWD_UNITS hidden units, over its
# positions g*K + j (gate-major, j increasing) in one chain, and the blocks'
# partial sums are added in block order; db sums each step's rows in groups
# of BWD_ROWS (row pairs, then the pairs in order), each group over the
# steps t = T-1 .. 0, then the groups in order.  (The simple RNN with f32 R
# at K > 1768 takes 16 units x 32 rows; f32 is held to 1e-5, not its order.)
BWD_UNITS = {4: 16, 3: 16, 1: 32}
BWD_ROWS = {4: 32, 3: 32, 1: 16}

# the simple RNN's activations: name -> (the kernel's code, torch function)
ACTS = {"relu": (0, torch.relu), "sigmoid": (1, torch.sigmoid),
        "tanh": (2, torch.tanh)}


def reset_launches() -> None:
    for counts in (launches, train_launches, bwd_launches, form_launches):
        for name in counts:
            counts[name] = 0


_lib = cuda_build.bind("rnn_seq", {
    "xsmm_lstm_seq": [P, P, I] + [P] * 12 + [I, I, I, P, I, P],
    "xsmm_gru_seq": [P, P, I] + [P] * 9 + [I, I, I, P, I, P],
    "xsmm_rnn_seq": [P, P, I, P, P, P, I, P, P, I, I, I, P, I, P],
    "xsmm_lstm_seq_bwd": [P] * 10 + [I, P, I] + [P] * 6 + [I, I, I, I, P],
    "xsmm_gru_seq_bwd": [P] * 9 + [I, P, P, I] + [P] * 6 + [I, I, I, I, P],
    "xsmm_rnn_seq_bwd": [P, P, P, P, I, P, I, I] + [P] * 5 + [I, I, I, I, P],
    "xsmm_rnn_seq_fits": [I, I, I, I, I],
    "xsmm_rnn_seq_form": [I, I, I, I, P, I, P],
    "xsmm_rnn_seq_bwd_fits": [I, I, I, I, I],
    "xsmm_rnn_seq_bwd_scratch": [I, I, I, I, P, I, P],
})


@functools.lru_cache(maxsize=256)
def _fits(n: int, k: int, gates: int, r_itemsize: int, device: int,
          bwd: bool = False) -> bool:
    fn = (_lib().xsmm_rnn_seq_bwd_fits if bwd else _lib().xsmm_rnn_seq_fits)
    rc = fn(n, k, gates, r_itemsize, device)
    if rc < 0 or rc > 1:
        raise RuntimeError(f"{fn.__name__}({n}, {k}, {gates}, "
                           f"{r_itemsize}) failed (code {rc})")
    return rc == 1


def seq_kernel_ok(n: int, k: int, gates: int, r_itemsize: int) -> bool:
    """Static routing decision for the sequence kernels (the counterpart of
    the JAX package's ``seq_pallas_ok``): True on the CPU target, where the
    plain versions take every shape; on the card, whether the kernel's own
    envelope (``xsmm_rnn_seq_fits`` in ``rnn_seq.cu``: shared memory of a
    block, blocks the card holds at once) takes N x K in both forms."""
    if platform.interpret_mode():
        return True
    dev = platform.device()
    return _fits(n, k, gates, r_itemsize, dev.index)


@functools.lru_cache(maxsize=256)
def _form(n: int, k: int, gates: int, r_itemsize: int, device: int) -> tuple:
    out = (ctypes.c_int * 6)()
    cuda_build.launch(_lib().xsmm_rnn_seq_form, torch.device("cuda", device),
                      n, k, gates, r_itemsize, ctypes.addressof(out))
    return tuple(out)


def seq_form(n: int, k: int, gates: int, r_itemsize: int,
             device: int = 0) -> Dict[str, object]:
    """The forward kernel's launch plan for N x K on card ``device``, as
    its entry point makes it (``xsmm_rnn_seq_form``): ``blocks`` (the
    grid), ``column_blocks`` (16 hidden units each; 64 for the simple RNN's
    wide form), ``passes`` (row passes a block), ``rows`` (of a pass),
    ``form`` (one of FORMS, as ``form_launches`` counts them) and ``sms``
    (the card's).  Raises ValueError outside the envelope."""
    grid, cb, passes, form, sms, rows = _form(n, k, gates, r_itemsize,
                                              device)
    return {"blocks": grid, "column_blocks": cb, "passes": passes,
            "rows": rows, "form": FORMS[form], "sms": sms}


def seq_bwd_kernel_ok(n: int, k: int, gates: int, r_itemsize: int) -> bool:
    """The same decision for the backward kernels, from their own envelope
    (``xsmm_rnn_seq_bwd_fits``: a block holds G*K rows of R^T, G times the
    forward's)."""
    if platform.interpret_mode():
        return True
    dev = platform.device()
    return _fits(n, k, gates, r_itemsize, dev.index, True)


def _check(name: str, t, dtypes, dim: int,
           device: Optional[torch.device] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rnn_seq kernels run on cuda or cpu, not {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the first operand on "
                         f"{device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _shapes(zx, r, h0, c0, gates: int):
    """(T, N, K) of the operands, after checking them."""
    f32 = (torch.float32,)
    _check("zx", zx, f32, 3)
    _check("R", r, (torch.float32, torch.bfloat16), 2, zx.device)
    _check("h0", h0, f32, 2, zx.device)
    t, n, gk = zx.shape
    k = r.shape[0]
    if (min(t, n, k) < 1 or gk != gates * k or r.shape[1] != gk
            or tuple(h0.shape) != (n, k)):
        raise ValueError(f"shapes disagree ({gates} gates): zx[T,N,G*K]="
                         f"{tuple(zx.shape)} R[K,G*K]={tuple(r.shape)} "
                         f"h0[N,K]={tuple(h0.shape)}")
    if c0 is not None:
        _check("c0", c0, f32, 2, zx.device)
        if c0.shape != h0.shape:
            raise ValueError(f"c0 {tuple(c0.shape)} != h0 {tuple(h0.shape)}")
    return t, n, k


# the products kept by ``keep_products`` (None: none is kept)
_kept: Optional[List] = None


@contextlib.contextmanager
def keep_products():
    """Keep, in call order, the products the cells compute outside the
    kernels -- x@W, and on the plain versions every step's h@R -- as
    (name, a, b, a@b): copies of the very operands and result of the call,
    for a diagnosis that must not recompute them.  Yields the list."""
    global _kept
    saved, _kept = _kept, []
    try:
        yield _kept
    finally:
        _kept = saved


def keep(name: str, a: torch.Tensor, b: torch.Tensor,
         out: torch.Tensor) -> torch.Tensor:
    """``out`` (= a @ b), kept with its operands under ``keep_products``."""
    if _kept is not None:
        _kept.append((name, a.detach().clone(), b.detach().clone(),
                      out.detach().clone()))
    return out


def _hr(h: torch.Tensor, r32: torch.Tensor, bf16: bool) -> torch.Tensor:
    """h @ R as the JAX kernel's ``_dot`` (``r32`` is R in f32).  f32: the
    full-f32 product (TF32 off).  bf16: h rounded to bf16, and the products of the
    rounded values, exact in f32, summed in f32 in k order, one addcmul a k
    (the kernel's FMA chain gives the same sums, so the two agree bit for
    bit where their gate functions do)."""
    if not bf16:
        return keep("h@R", h, r32, _matmul(h, r32))
    hb = h.to(torch.bfloat16).float()
    acc = torch.zeros((h.shape[0], r32.shape[1]), dtype=torch.float32,
                      device=h.device)
    for k in range(r32.shape[0]):
        acc.addcmul_(hb[:, k:k + 1], r32[k])
    return keep("h@R (h in bf16)", hb, r32, acc)


def _scratch(n: int, k: int, dev: torch.device):
    """The kernels' h-exchange buffer [2, N, round_up(K, 4)] and barrier
    word (zeroed by the entry point)."""
    return (torch.empty((2, n, (k + 3) // 4 * 4), dtype=torch.float32,
                        device=dev),
            torch.empty((1,), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Kernel 15: _lstm_kernel (xsmm_tpu/dnn/rnn_seq.py:112)
# ---------------------------------------------------------------------------


def lstm_seq_plain(zx: torch.Tensor, r: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor, *, train: bool):
    """z = zx[t] + h@R; i, g, f, o = sig, tanh, sig, sig of its four K-wide
    column blocks; c' = f*c + i*g; h' = o*tanh(c')."""
    t, _, gk = zx.shape
    k = gk // 4
    bf16 = r.dtype == torch.bfloat16
    r32 = r.float()
    h, c = h0, c0
    outs = [[] for _ in range(6 if train else 1)]
    for ti in range(t):
        z = zx[ti] + _hr(h, r32, bf16)
        i = torch.sigmoid(z[:, :k])
        g = torch.tanh(z[:, k:2 * k])
        f = torch.sigmoid(z[:, 2 * k:3 * k])
        o = torch.sigmoid(z[:, 3 * k:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        for seq, v in zip(outs, (h, c, i, g, f, o)):
            seq.append(v)
    hs, *res = (torch.stack(seq) for seq in outs)
    return (hs, h, c, *res)


def lstm_seq(zx: torch.Tensor, r: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor, *, train: bool):
    """Returns (hs, h_T, c_T), or (hs, h_T, c_T, cs, i, g, f, o) if train;
    every output f32, hs and the residuals [T, N, K]."""
    t, n, k = _shapes(zx, r, h0, c0, 4)
    if c0 is None:
        raise ValueError("lstm_seq needs c0")
    if zx.device.type == "cpu":
        return lstm_seq_plain(zx, r, h0, c0, train=train)
    dev = zx.device
    seqs = [torch.empty((t, n, k), dtype=torch.float32, device=dev)
            for _ in range(6 if train else 1)]
    ht, ct = (torch.empty((n, k), dtype=torch.float32, device=dev)
              for _ in range(2))
    res = seqs[1:] if train else [None] * 5
    hbuf, bar = _scratch(n, k, dev)
    form = ctypes.c_int(-1)
    cuda_build.launch(_lib().xsmm_lstm_seq, dev, zx.data_ptr(), r.data_ptr(),
                      int(r.dtype == torch.bfloat16), h0.data_ptr(),
                      c0.data_ptr(), seqs[0].data_ptr(), ht.data_ptr(),
                      ct.data_ptr(), *(ptr(x) for x in res), hbuf.data_ptr(),
                      bar.data_ptr(), t, n, k, ctypes.byref(form))
    launches["lstm_seq"] += 1
    form_launches[FORMS[form.value]] += 1
    if train:
        train_launches["lstm_seq"] += 1
    return (seqs[0], ht, ct, *seqs[1:])


# ---------------------------------------------------------------------------
# Kernel 17: _gru_kernel (xsmm_tpu/dnn/rnn_seq.py:271)
# ---------------------------------------------------------------------------


def gru_seq_plain(zx: torch.Tensor, r: torch.Tensor, h0: torch.Tensor, *,
                  train: bool):
    """zr = h@R; ri = sig(zx_r + zr_r), zi = sig(zx_z + zr_z),
    gi = tanh(zx_g + ri*zr_g); h' = (1 - zi)*gi + zi*h."""
    t, _, gk = zx.shape
    k = gk // 3
    bf16 = r.dtype == torch.bfloat16
    r32 = r.float()
    h = h0
    outs = [[] for _ in range(5 if train else 1)]
    for ti in range(t):
        zx_t = zx[ti]
        zr = _hr(h, r32, bf16)
        ri = torch.sigmoid(zx_t[:, :k] + zr[:, :k])
        zi = torch.sigmoid(zx_t[:, k:2 * k] + zr[:, k:2 * k])
        zr_g = zr[:, 2 * k:]
        gi = torch.tanh(zx_t[:, 2 * k:] + ri * zr_g)
        h = (1.0 - zi) * gi + zi * h
        for seq, v in zip(outs, (h, ri, zi, gi, zr_g)):
            seq.append(v)
    hs, *res = (torch.stack(seq) for seq in outs)
    return (hs, h, *res)


def gru_seq(zx: torch.Tensor, r: torch.Tensor, h0: torch.Tensor, *,
            train: bool):
    """Returns (hs, h_T), or (hs, h_T, ris, zis, gis, zrgs) if train."""
    t, n, k = _shapes(zx, r, h0, None, 3)
    if zx.device.type == "cpu":
        return gru_seq_plain(zx, r, h0, train=train)
    dev = zx.device
    seqs = [torch.empty((t, n, k), dtype=torch.float32, device=dev)
            for _ in range(5 if train else 1)]
    ht = torch.empty((n, k), dtype=torch.float32, device=dev)
    res = seqs[1:] if train else [None] * 4
    hbuf, bar = _scratch(n, k, dev)
    form = ctypes.c_int(-1)
    cuda_build.launch(_lib().xsmm_gru_seq, dev, zx.data_ptr(), r.data_ptr(),
                      int(r.dtype == torch.bfloat16), h0.data_ptr(),
                      seqs[0].data_ptr(), ht.data_ptr(),
                      *(ptr(x) for x in res), hbuf.data_ptr(),
                      bar.data_ptr(), t, n, k, ctypes.byref(form))
    launches["gru_seq"] += 1
    form_launches[FORMS[form.value]] += 1
    if train:
        train_launches["gru_seq"] += 1
    return (seqs[0], ht, *seqs[1:])


# ---------------------------------------------------------------------------
# Kernel 19: _rnn_kernel (xsmm_tpu/dnn/rnn_seq.py:451)
# ---------------------------------------------------------------------------


def _act(name: str):
    """(kernel code, torch function) of activation ``name``."""
    if name not in ACTS:
        raise ValueError(f"act {name!r}: expected one of {sorted(ACTS)}")
    return ACTS[name]


def rnn_seq_plain(zx: torch.Tensor, r: torch.Tensor, h0: torch.Tensor, *,
                  act: str):
    """h' = act(zx[t] + h@R)."""
    fn = _act(act)[1]
    bf16 = r.dtype == torch.bfloat16
    r32 = r.float()
    h = h0
    hs = []
    for ti in range(zx.shape[0]):
        h = fn(zx[ti] + _hr(h, r32, bf16))
        hs.append(h)
    return torch.stack(hs), h


def rnn_seq(zx: torch.Tensor, r: torch.Tensor, h0: torch.Tensor, *,
            act: str):
    """Returns (hs, h_T); hs doubles as the residual.  ``act`` is "relu",
    "sigmoid" or "tanh"."""
    t, n, k = _shapes(zx, r, h0, None, 1)
    code = _act(act)[0]
    if zx.device.type == "cpu":
        return rnn_seq_plain(zx, r, h0, act=act)
    dev = zx.device
    hs = torch.empty((t, n, k), dtype=torch.float32, device=dev)
    ht = torch.empty((n, k), dtype=torch.float32, device=dev)
    hbuf, bar = _scratch(n, k, dev)
    form = ctypes.c_int(-1)
    cuda_build.launch(_lib().xsmm_rnn_seq, dev, zx.data_ptr(), r.data_ptr(),
                      int(r.dtype == torch.bfloat16), h0.data_ptr(),
                      hs.data_ptr(), ht.data_ptr(), code,
                      hbuf.data_ptr(), bar.data_ptr(), t, n, k,
                      ctypes.byref(form))
    launches["rnn_seq"] += 1
    form_launches[FORMS[form.value]] += 1
    return hs, ht


# ---------------------------------------------------------------------------
# The backward kernels 16, 18, 20: the reverse scan over the residuals
# ---------------------------------------------------------------------------


def _dz_rt(dz: torch.Tensor, rt32: torch.Tensor, bf16: bool) -> torch.Tensor:
    """dz @ R^T as the JAX kernel's ``_dot`` (``rt32`` is R^T [G*K, K] in
    f32).  f32: the full-f32 product.  bf16: dz rounded to bf16, and the
    exact products summed in f32 in the backward kernels' order: for each
    block of BWD_UNITS units j0 .. j0+15, a partial sum over its positions
    g*K + j, one addcmul a position (g, then j, increasing), then the blocks'
    partials added in block order."""
    if not bf16:
        return _matmul(dz, rt32)
    k = rt32.shape[1]
    gates = rt32.shape[0] // k
    units = BWD_UNITS[gates]
    dzb = dz.to(torch.bfloat16).float()
    out = None
    for j0 in range(0, k, units):
        part = torch.zeros((dz.shape[0], k), dtype=torch.float32,
                           device=dz.device)
        for g in range(gates):
            for q in range(g * k + j0, g * k + min(j0 + units, k)):
                part.addcmul_(dzb[:, q:q + 1], rt32[q])
        out = part if out is None else out + part
    return out


def _db_groups(dz: torch.Tensor, gates: int) -> torch.Tensor:
    """One step's db by row group of BWD_ROWS[G], [ceil(N/rows), G*K], in
    the backward kernels' order: rows in pairs, then the pairs of a group in
    order (rows past N are zeros)."""
    n, rows = dz.shape[0], BWD_ROWS[gates]
    x = dz.new_zeros(((n + rows - 1) // rows * rows, dz.shape[1]))
    x[:n] = dz
    x = x.view(-1, rows // 2, 2, dz.shape[1])
    pairs = x[:, :, 0] + x[:, :, 1]
    out = pairs[:, 0]
    for e in range(1, rows // 2):
        out = out + pairs[:, e]
    return out


def _db(groups: torch.Tensor) -> torch.Tensor:
    """db [1, G*K] from the groups' sums over the steps, in group order."""
    out = groups[0]
    for row in groups[1:]:
        out = out + row
    return out[None]


def _bwd_shapes(dhs, res, states, rt, gates: int, dz_dt) -> tuple:
    """(T, N, K) of a backward kernel's operands, after checking them:
    dhs and the residuals [T, N, K] f32, the states [N, K] f32, rt
    [G*K, K] f32 or bf16."""
    f32 = (torch.float32,)
    _check("dhs", dhs, f32, 3)
    t, n, k = dhs.shape
    for i, x in enumerate(res):
        _check(f"residual {i}", x, f32, 3, dhs.device)
    for i, x in enumerate(states):
        _check(f"state {i}", x, f32, 2, dhs.device)
    _check("rt", rt, (torch.float32, torch.bfloat16), 2, dhs.device)
    if dz_dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dz_dt {dz_dt}: expected torch.float32 or "
                         f"torch.bfloat16")
    if (min(t, n, k) < 1 or any(x.shape != dhs.shape for x in res)
            or any(tuple(x.shape) != (n, k) for x in states)
            or tuple(rt.shape) != (gates * k, k)):
        raise ValueError(
            f"shapes disagree ({gates} gates): dhs[T,N,K]={tuple(dhs.shape)} "
            f"residuals {[tuple(x.shape) for x in res]} states[N,K] "
            f"{[tuple(x.shape) for x in states]} rt[G*K,K]={tuple(rt.shape)}")
    return t, n, k


@functools.lru_cache(maxsize=256)
def _bwd_scratch_floats(n: int, k: int, gates: int, r_itemsize: int,
                        device: int) -> tuple:
    floats = (ctypes.c_longlong * 2)()
    cuda_build.launch(_lib().xsmm_rnn_seq_bwd_scratch,
                      torch.device("cuda", device), n, k, gates, r_itemsize,
                      ctypes.addressof(floats))
    return floats[0], floats[1]


def _bwd_scratch(n: int, k: int, gates: int, rt: torch.Tensor):
    """The backward kernels' scratch on rt's card, of the sizes
    ``xsmm_rnn_seq_bwd_scratch`` gives for the launch plan: db's row-group
    sums and the column blocks' partial products of one row chunk (at most
    32 MB, or one pass of the grid where that is larger, whatever N), flat
    f32; and the barrier word (zeroed by the entry point).  Raises ValueError
    outside the envelope, before any launch."""
    dev = rt.device
    dbp, pbuf = _bwd_scratch_floats(n, k, gates, rt.element_size(),
                                    dev.index)
    return (torch.empty((dbp,), dtype=torch.float32, device=dev),
            torch.empty((pbuf,), dtype=torch.float32, device=dev),
            torch.empty((1,), dtype=torch.int32, device=dev))


# -- Kernel 16: _lstm_bwd_kernel (xsmm_tpu/dnn/rnn_seq.py:185) --------------


def lstm_seq_bwd_plain(dhs, is_, gs, fs, os_, cs, c0, dh_t, dc_t, rt, *,
                       dz_dt=torch.float32):
    """dh = dhs[t] + dh'; do = dh*tanh(c_t); dc = dc' + dh*o*(1 - tanh^2);
    dz = [dc*g*i*(1-i), dc*i*(1-g^2), dc*c_{t-1}*f*(1-f), do*o*(1-o)];
    dh' = dz @ R^T, dc' = dc*f."""
    bf16 = rt.dtype == torch.bfloat16
    rt32 = rt.float()
    dh_n, dc_n = dh_t, dc_t
    dzs, db = [], None
    for t in reversed(range(dhs.shape[0])):
        i, g, f, o = is_[t], gs[t], fs[t], os_[t]
        tc = torch.tanh(cs[t])
        cp = c0 if t == 0 else cs[t - 1]
        dh = dhs[t] + dh_n
        do = dh * tc
        dc = dc_n + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dc * g * i * (1.0 - i), dc * i * (1.0 - g * g),
                        dc * cp * f * (1.0 - f), do * o * (1.0 - o)], dim=1)
        dzs.append(dz.to(dz_dt))
        db = _db_groups(dz, 4) if db is None else db + _db_groups(dz, 4)
        dh_n = _dz_rt(dz, rt32, bf16)
        dc_n = dc * f
    return torch.stack(dzs[::-1]), dh_n, dc_n, _db(db)


def lstm_seq_bwd(dhs, is_, gs, fs, os_, cs, c0, dh_t, dc_t, rt, *,
                 dz_dt=torch.float32):
    """Returns (dzs [T, N, 4K] dz_dt, dh0, dc0, db [1, 4K] f32)."""
    t, n, k = _bwd_shapes(dhs, (is_, gs, fs, os_, cs), (c0, dh_t, dc_t), rt,
                          4, dz_dt)
    if dhs.device.type == "cpu":
        return lstm_seq_bwd_plain(dhs, is_, gs, fs, os_, cs, c0, dh_t, dc_t,
                                  rt, dz_dt=dz_dt)
    dev = dhs.device
    dz = torch.empty((t, n, 4 * k), dtype=dz_dt, device=dev)
    dh0, dc0 = (torch.empty((n, k), dtype=torch.float32, device=dev)
                for _ in range(2))
    db = torch.empty((1, 4 * k), dtype=torch.float32, device=dev)
    dbp, pbuf, bar = _bwd_scratch(n, k, 4, rt)
    cuda_build.launch(
        _lib().xsmm_lstm_seq_bwd, dev,
        *(x.data_ptr() for x in (dhs, is_, gs, fs, os_, cs, c0, dh_t, dc_t,
                                 rt)),
        int(rt.dtype == torch.bfloat16), dz.data_ptr(),
        int(dz_dt == torch.bfloat16),
        *(x.data_ptr() for x in (dh0, dc0, db, dbp, pbuf, bar)), t, n, k)
    bwd_launches["lstm_seq_bwd"] += 1
    return dz, dh0, dc0, db


# -- Kernel 18: _gru_bwd_kernel (xsmm_tpu/dnn/rnn_seq.py:335) ---------------


def gru_seq_bwd_plain(dhs, ris, zis, gis, zrgs, hs, h0, dh_t, rt, *,
                      dz_dt=torch.float32):
    """dh = dhs[t] + dh'; dzi = dh*(h_{t-1} - gi)*zi*(1-zi);
    dgi = dh*(1-zi)*(1-gi^2); dri = dgi*zr_g*ri*(1-ri); dzx = [dri, dzi,
    dgi]; dh' = dh*zi + [dri, dzi, dgi*ri] @ R^T."""
    bf16 = rt.dtype == torch.bfloat16
    rt32 = rt.float()
    dh_n = dh_t
    dzxs, dgiris, db = [], [], None
    for t in reversed(range(dhs.shape[0])):
        ri, zi, gi, zr_g = ris[t], zis[t], gis[t], zrgs[t]
        hp = h0 if t == 0 else hs[t - 1]
        dh = dhs[t] + dh_n
        dzi = dh * (hp - gi) * zi * (1.0 - zi)
        dgi = dh * (1.0 - zi) * (1.0 - gi * gi)
        dri = dgi * zr_g * ri * (1.0 - ri)
        dgiri = dgi * ri
        dzx = torch.cat([dri, dzi, dgi], dim=1)
        dzxs.append(dzx.to(dz_dt))
        dgiris.append(dgiri.to(dz_dt))
        db = _db_groups(dzx, 3) if db is None else db + _db_groups(dzx, 3)
        dh_n = dh * zi + _dz_rt(torch.cat([dri, dzi, dgiri], dim=1), rt32,
                                bf16)
    return (torch.stack(dzxs[::-1]), torch.stack(dgiris[::-1]), dh_n,
            _db(db))


def gru_seq_bwd(dhs, ris, zis, gis, zrgs, hs, h0, dh_t, rt, *,
                dz_dt=torch.float32):
    """Returns (dzxs [T, N, 3K], dgiris [T, N, K], both dz_dt, dh0,
    db [1, 3K] f32)."""
    t, n, k = _bwd_shapes(dhs, (ris, zis, gis, zrgs, hs), (h0, dh_t), rt, 3,
                          dz_dt)
    if dhs.device.type == "cpu":
        return gru_seq_bwd_plain(dhs, ris, zis, gis, zrgs, hs, h0, dh_t, rt,
                                 dz_dt=dz_dt)
    dev = dhs.device
    dzx = torch.empty((t, n, 3 * k), dtype=dz_dt, device=dev)
    dgiri = torch.empty((t, n, k), dtype=dz_dt, device=dev)
    dh0, carry = (torch.empty((n, k), dtype=torch.float32, device=dev)
                  for _ in range(2))
    db = torch.empty((1, 3 * k), dtype=torch.float32, device=dev)
    dbp, pbuf, bar = _bwd_scratch(n, k, 3, rt)
    cuda_build.launch(
        _lib().xsmm_gru_seq_bwd, dev,
        *(x.data_ptr() for x in (dhs, ris, zis, gis, zrgs, hs, h0, dh_t, rt)),
        int(rt.dtype == torch.bfloat16), dzx.data_ptr(), dgiri.data_ptr(),
        int(dz_dt == torch.bfloat16),
        *(x.data_ptr() for x in (dh0, carry, db, dbp, pbuf, bar)), t, n, k)
    bwd_launches["gru_seq_bwd"] += 1
    return dzx, dgiri, dh0, db


# -- Kernel 20: _rnn_bwd_kernel (xsmm_tpu/dnn/rnn_seq.py:407) ---------------


def _dact(act: str, h: torch.Tensor) -> torch.Tensor:
    """The activation's derivative from its output: relu 1[h > 0], sigmoid
    h(1-h), tanh 1-h^2."""
    if act == "relu":
        return (h > 0).float()
    if act == "sigmoid":
        return h * (1.0 - h)
    return 1.0 - h * h


def rnn_seq_bwd_plain(dhs, hs, dh_t, rt, *, act: str, dz_dt=torch.float32):
    """dz = (dhs[t] + dh') * act'(h_t); dh' = dz @ R^T."""
    _act(act)
    bf16 = rt.dtype == torch.bfloat16
    rt32 = rt.float()
    dh_n = dh_t
    dzs, db = [], None
    for t in reversed(range(dhs.shape[0])):
        dz = (dhs[t] + dh_n) * _dact(act, hs[t])
        dzs.append(dz.to(dz_dt))
        db = _db_groups(dz, 1) if db is None else db + _db_groups(dz, 1)
        dh_n = _dz_rt(dz, rt32, bf16)
    return torch.stack(dzs[::-1]), dh_n, _db(db)


def rnn_seq_bwd(dhs, hs, dh_t, rt, *, act: str, dz_dt=torch.float32):
    """Returns (dzs [T, N, K] dz_dt, dh0, db [1, K] f32).  ``act`` is
    "relu", "sigmoid" or "tanh" (the JAX kernel takes its derivative)."""
    t, n, k = _bwd_shapes(dhs, (hs,), (dh_t,), rt, 1, dz_dt)
    code = _act(act)[0]
    if dhs.device.type == "cpu":
        return rnn_seq_bwd_plain(dhs, hs, dh_t, rt, act=act, dz_dt=dz_dt)
    dev = dhs.device
    dz = torch.empty((t, n, k), dtype=dz_dt, device=dev)
    dh0 = torch.empty((n, k), dtype=torch.float32, device=dev)
    db = torch.empty((1, k), dtype=torch.float32, device=dev)
    dbp, pbuf, bar = _bwd_scratch(n, k, 1, rt)
    cuda_build.launch(
        _lib().xsmm_rnn_seq_bwd, dev, dhs.data_ptr(), hs.data_ptr(),
        dh_t.data_ptr(), rt.data_ptr(), int(rt.dtype == torch.bfloat16),
        dz.data_ptr(), int(dz_dt == torch.bfloat16), code,
        *(x.data_ptr() for x in (dh0, db, dbp, pbuf, bar)), t, n, k)
    bwd_launches["rnn_seq_bwd"] += 1
    return dz, dh0, db
