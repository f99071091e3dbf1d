"""Packed training datasets and the native prefetching loader: the port of
``xsmm_tpu/utils/dataset.py``.

The GxM data-layer analog (reference: samples/deeplearning/gxm reads
LMDB/JPEG with background I/O threads; documentation/gxm.md).  Datasets are
a packed uint8 file ("XSD1": header + label/image records, the JAX
package's format byte for byte); the loader is the C++ worker pool of
``native/dataloader.cpp``, built by ``core/native_bridge`` and bound with
ctypes, or a Python reader of the same format.

* ``native=True`` (the default) takes the worker pool: batches in its
  order (an xorshift Fisher-Yates permutation an epoch, seeded
  ``seed * phi64 + epoch + 1``) and its normalization (``u8 * (1/255) -
  0.5`` in f32).  There is no quiet fallback: a library that is off
  (``XSMM_NATIVE=0``) or fails to build, and a dataset ``xsmm_dl_open``
  refuses, raise with the reason, where the JAX loader drops to Python.
* ``native=False`` takes the Python reader: the JAX Python path's batches
  bit for bit (``rng.permutation`` and ``u8 / 255 - 0.5``).

With ``device=None`` a batch is numpy (images f32 [B, H, W, C], labels i32
[B]), as in the JAX package.  With a device, it is a pair of tensors there:
for the card each batch lands in a pinned buffer of the staging pool
(``utils/scratch``; the native loader writes into it directly) and crosses
with a non-blocking copy, the buffer handed out again only after that copy
has landed.

Usage:
    write_dataset(path, images_u8, labels)         # [N,H,W,C] u8, [N] int
    for x, y in DataLoader(path, batch=256, device="cuda"):
        ...
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import scratch

_MAGIC = 0x31445358  # "XSD1"
_HDR = struct.Struct("<IIQIII")  # magic, nclasses, count, h, w, c


def write_dataset(path: str, images: np.ndarray, labels: np.ndarray,
                  nclasses: Optional[int] = None) -> None:
    """Pack [N,H,W,C] uint8 images + int labels into an XSD1 file."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    labels = np.asarray(labels, dtype=np.int32)
    if images.ndim != 4 or labels.shape != (images.shape[0],):
        raise ValueError(f"images must be [N,H,W,C] and labels [N], got "
                         f"{images.shape} and {labels.shape}")
    n, h, w, c = images.shape
    nclasses = int(nclasses if nclasses is not None else labels.max() + 1)
    with open(path, "wb") as f:
        f.write(_HDR.pack(_MAGIC, nclasses, n, h, w, c))
        for i in range(n):
            f.write(struct.pack("<i", int(labels[i])))
            f.write(images[i].tobytes())


def _read_header(path: str):
    with open(path, "rb") as f:
        magic, ncls, count, h, w, c = _HDR.unpack(f.read(_HDR.size))
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an XSD1 dataset")
    return ncls, count, h, w, c


def native_lib() -> ctypes.CDLL:
    """The native library with its loader bound; raises where it is off
    or cannot be built."""
    from ..core.native_bridge import get_lib

    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native loader needs the native library, "
                           "which XSMM_NATIVE=0 turns off; pass "
                           "native=False for the Python reader")
    return lib


class DataLoader:
    """Iterable over (images f32 [B,H,W,C], labels i32 [B]) batches.

    ``epochs`` bounds the iteration; records are shuffled anew each epoch.
    ``backend`` is "native" or "python"."""

    def __init__(self, path: str, batch: int, epochs: int = 1,
                 prefetch: int = 4, nthreads: int = 2, seed: int = 42,
                 native: bool = True, device=None):
        self.path = path
        self.batch = batch
        self.epochs = epochs
        self.prefetch = prefetch
        self.nthreads = nthreads
        self.seed = seed
        self.device = None if device is None else torch.device(device)
        (self.nclasses, self.count, self.h, self.w, self.c) = \
            _read_header(path)
        self.batches_per_epoch = self.count // batch if batch > 0 else 0
        if self.batches_per_epoch == 0:
            raise ValueError(f"batch {batch} must be in 1 .. {self.count}, "
                             f"the dataset's count")
        self._lib = native_lib() if native else None
        self.backend = "native" if native else "python"

    def __len__(self):
        return self.batches_per_epoch * self.epochs

    def __iter__(self) -> Iterator[Tuple]:
        if self._lib is not None:
            return self._iter_native()
        return self._iter_python()

    # -- where a batch goes --------------------------------------------------
    def _buffers(self, i: int):
        """Host buffers for batch ``i``: numpy arrays, or torch tensors
        (pinned, from the staging pool, two in turns) for a device."""
        shape = (self.batch, self.h, self.w, self.c)
        if self.device is None:
            return (np.empty(shape, np.float32),
                    np.empty((self.batch,), np.int32))
        if self.device.type == "cpu":
            return (torch.empty(shape), torch.empty((self.batch,),
                                                    dtype=torch.int32))
        pool = scratch.get_staging_pool()
        return (pool.buffer(shape, torch.float32, f"loader_x{i % 2}"),
                pool.buffer((self.batch,), torch.int32, f"loader_y{i % 2}"))

    def _deliver(self, x, y):
        if self.device is None or self.device.type == "cpu":
            return x, y
        out = (x.to(self.device, non_blocking=True),
               y.to(self.device, non_blocking=True))
        stream = torch.cuda.current_stream(self.device)
        pool = scratch.get_staging_pool()
        pool.mark_in_flight(x, stream)
        pool.mark_in_flight(y, stream)
        return out

    # -- the native worker pool ----------------------------------------------
    def _iter_native(self):
        lib = self._lib
        h = lib.xsmm_dl_open(os.fsencode(self.path), self.batch,
                             self.prefetch, self.nthreads, self.seed)
        if not h:
            raise RuntimeError(f"xsmm_dl_open refused {self.path} (a file it "
                               f"cannot open or read, or batch "
                               f"{self.batch} beyond its {self.count} "
                               f"records)")
        try:
            for i in range(len(self)):
                x, y = self._buffers(i)
                ptr = (lambda a: a.ctypes.data if isinstance(a, np.ndarray)
                       else a.data_ptr())
                epoch = lib.xsmm_dl_next(h, ptr(x), ptr(y))
                if epoch < 0:
                    raise RuntimeError(f"the native loader stopped at batch "
                                       f"{i} of {len(self)} (a failed read "
                                       f"of {self.path})")
                yield self._deliver(x, y)
        finally:
            lib.xsmm_dl_close(h)

    # -- the Python reader (same format, same shuffle-per-epoch) -------------
    def _iter_python(self):
        px = self.h * self.w * self.c
        rec = 4 + px
        with open(self.path, "rb") as f:
            raw = f.read()
        body = np.frombuffer(raw, np.uint8, offset=_HDR.size)
        recs = body[:self.count * rec].reshape(self.count, rec)
        labels = recs[:, :4].copy().view(np.int32).ravel()
        images = recs[:, 4:]
        rng = np.random.default_rng(self.seed)
        i = 0
        for _ in range(self.epochs):
            perm = rng.permutation(self.count)
            for b in range(self.batches_per_epoch):
                idx = perm[b * self.batch:(b + 1) * self.batch]
                x = (images[idx].astype(np.float32) / 255.0 - 0.5).reshape(
                    self.batch, self.h, self.w, self.c)
                y = labels[idx].astype(np.int32)
                if self.device is not None:
                    bx, by = self._buffers(i)
                    bx.copy_(torch.from_numpy(x))
                    by.copy_(torch.from_numpy(y))
                    x, y = self._deliver(bx, by)
                i += 1
                yield x, y
