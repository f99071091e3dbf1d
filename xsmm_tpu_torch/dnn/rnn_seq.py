"""The three RNN forward sequence kernels (LSTM, GRU, simple RNN): wrappers,
plain versions, counts.

The counterpart of the forward side of ``xsmm_tpu/dnn/rnn_seq.py``, with its
signatures and return tuples.  Operands, all contiguous, on one device:
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

Numerics, as the JAX kernel's ``_dot``: with f32 R the product is full f32;
with bf16 R, h is rounded to bf16 before the product and the products of
the bf16 values, exact in f32, are summed in f32 (in k order, by kernel and
plain version alike).  The gate math is f32, each product and sum rounded
on its own.  A recurrence over bf16-rounded h amplifies any difference of
one f32 ulp into a different bf16 rounding a few steps later, so kernel and
plain version are built to agree bit for bit in the bf16 cells, not merely
to f32 rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from ..core import platform
from ..ops import cuda_build
from ..ops.smm import _matmul

# kernel name -> launches since the last reset_launches(); train_launches
# counts the launches of the residual-emitting form among them
launches: Dict[str, int] = {"lstm_seq": 0, "gru_seq": 0, "rnn_seq": 0}
train_launches: Dict[str, int] = {"lstm_seq": 0, "gru_seq": 0}

# the simple RNN's activations: name -> (the kernel's code, torch function)
ACTS = {"relu": (0, torch.relu), "sigmoid": (1, torch.sigmoid),
        "tanh": (2, torch.tanh)}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for counts in (launches, train_launches):
        for name in counts:
            counts[name] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("rnn_seq")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xsmm_lstm_seq.argtypes = [p, p, i, p, p, p, p, p, p, p, p, p, p,
                                      p, p, i, i, i, i, p]
        lib.xsmm_gru_seq.argtypes = [p, p, i, p, p, p, p, p, p, p, p, p, i, i,
                                     i, i, p]
        lib.xsmm_rnn_seq.argtypes = [p, p, i, p, p, p, i, p, p, i, i, i, i, p]
        lib.xsmm_rnn_seq_fits.argtypes = [i, i, i, i, i]
        for fn in (lib.xsmm_lstm_seq, lib.xsmm_gru_seq, lib.xsmm_rnn_seq,
                   lib.xsmm_rnn_seq_fits):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=256)
def _fits(n: int, k: int, gates: int, r_itemsize: int, device: int) -> bool:
    rc = _lib().xsmm_rnn_seq_fits(n, k, gates, r_itemsize, device)
    if rc < 0 or rc > 1:
        raise RuntimeError(f"xsmm_rnn_seq_fits({n}, {k}, {gates}, "
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


def _check(name: str, t, dtypes, dim: int,
           device: Optional[torch.device] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rnn_seq kernels run on cuda or cpu, not {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, zx is on {device}")
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


def _hr(h: torch.Tensor, r32: torch.Tensor, bf16: bool) -> torch.Tensor:
    """h @ R as the JAX kernel's ``_dot`` (``r32`` is R in f32).  f32: the
    full-f32 product (TF32 off).  bf16: h rounded to bf16, and the products of the
    rounded values, exact in f32, summed in f32 in k order, one addcmul a k
    (the kernel's FMA chain gives the same sums, so the two agree bit for
    bit where their gate functions do)."""
    if not bf16:
        return _matmul(h, r32)
    hb = h.to(torch.bfloat16).float()
    acc = torch.zeros((h.shape[0], r32.shape[1]), dtype=torch.float32,
                      device=h.device)
    for k in range(r32.shape[0]):
        acc.addcmul_(hb[:, k:k + 1], r32[k])
    return acc


def _scratch(n: int, k: int, dev: torch.device):
    """The kernels' h-exchange buffer [2, N, round_up(K, 4)] and barrier
    word (zeroed by the entry point)."""
    return (torch.empty((2, n, (k + 3) // 4 * 4), dtype=torch.float32,
                        device=dev),
            torch.empty((1,), dtype=torch.int32, device=dev))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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
    cuda_build.launch(_lib().xsmm_lstm_seq, dev, zx.data_ptr(), r.data_ptr(),
                      int(r.dtype == torch.bfloat16), h0.data_ptr(),
                      c0.data_ptr(), seqs[0].data_ptr(), ht.data_ptr(),
                      ct.data_ptr(), *(_ptr(x) for x in res), hbuf.data_ptr(),
                      bar.data_ptr(), t, n, k)
    launches["lstm_seq"] += 1
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
    cuda_build.launch(_lib().xsmm_gru_seq, dev, zx.data_ptr(), r.data_ptr(),
                      int(r.dtype == torch.bfloat16), h0.data_ptr(),
                      seqs[0].data_ptr(), ht.data_ptr(),
                      *(_ptr(x) for x in res), hbuf.data_ptr(),
                      bar.data_ptr(), t, n, k)
    launches["gru_seq"] += 1
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
    cuda_build.launch(_lib().xsmm_rnn_seq, dev, zx.data_ptr(), r.data_ptr(),
                      int(r.dtype == torch.bfloat16), h0.data_ptr(),
                      hs.data_ptr(), ht.data_ptr(), code,
                      hbuf.data_ptr(), bar.data_ptr(), t, n, k)
    launches["rnn_seq"] += 1
    return hs, ht
