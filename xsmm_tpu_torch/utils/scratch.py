"""Memory / scratch management: limits, scoped accounting, host staging.

Reference: the scratch-pool allocator and its introspection
(libxsmm_scratch_malloc / libxsmm_get_scratch_info, src/libxsmm_malloc.c:
1181,1436; env LIBXSMM_SCRATCH_{POOLS,LIMIT,SCALE}).  The port of
``xsmm_tpu/utils/scratch.py``:

* **Device scratch is PyTorch's caching allocator.**  What the reference's
  LIMIT maps to is accounting and enforcement: ``scratch_scope()`` measures
  a region's peak device-byte delta from ``torch.cuda.memory_stats`` and
  enforces ``XSMM_SCRATCH_LIMIT`` (warn, or raise when ``strict=True``).
* **Host staging pool** (``HostStagingPool``): the f64 entry points move
  hundreds of MB from numpy to the card a call.  They stage them through
  reused **pinned** host buffers keyed by (shape, dtype, slot, thread),
  bounded by ``XSMM_SCRATCH_POOLS`` keys (LRU).  A buffer is handed out
  again only after the copy that read it has finished: ``mark_in_flight``
  records a CUDA event on the copying stream and ``buffer()`` waits on it.
  ``host_to_device`` and ``device_to_host`` are the two transfers the entry
  points use; on the CPU target neither runs (the tensors are numpy's own
  memory, zero-copy).  A result lands in a pinned block **leased** from the
  pool: the returned array, and every view of it, holds the lease, and the
  pool hands the block out again only once the lease is gone.  A key keeps
  at most ``RESULT_BLOCKS`` blocks (the caller's and the next call's); when
  the caller holds them all, the result comes back through two pinned
  chunks into a new pageable array.  So a held result is never
  overwritten, and the pinned memory stays bounded by the pool's keys
  whatever the caller holds.
* **Donation** (``donate``) returns the function as it is: the caching
  allocator and in-place ops take the role of JAX's buffer donation.

Stated differences from the JAX package: ``donate`` wraps nothing;
``XSMM_SCRATCH_POOLS`` below 1 raises ``ValueError`` when read (the JAX
pool takes 0 and fails at its first ``buffer()``); ``buffer()`` returns a
torch tensor (pinned where a card is present), not a numpy array.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import warnings
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# inputs below this many bytes take the plain pageable copy: staging them
# would cost more in bookkeeping than it saves, and would crowd the pool
STAGE_MIN_BYTES = 1 << 20
# the granule of the host fill / DMA pipeline in host_to_device: the fill
# of one chunk (host threads) runs while the previous chunk's copy is on the
# link
CHUNK_BYTES = 32 << 20
# pinned result blocks a key keeps: in a loop ``c = kern(a, b)`` the caller
# holds one while the next call lands in the other
RESULT_BLOCKS = 2


@dataclasses.dataclass
class ScratchInfo:
    """libxsmm_scratch_info analog."""

    size: int = 0        # bytes currently allocated (live)
    local: int = 0       # peak bytes
    npools: int = 1      # the caching allocator = one pool (+ host staging)
    nmallocs: int = 0    # allocation count (when the backend reports it)


def device_memory_stats(device=None) -> Dict[str, int]:
    """The caching allocator's counters of ``device`` (default: the current
    card), or {} where there is no card or ``device`` is the CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


def get_scratch_info(device=None) -> ScratchInfo:
    """libxsmm_get_scratch_info analog from the caching allocator's stats;
    zero on the CPU."""
    s = device_memory_stats(device)
    pool = _staging
    return ScratchInfo(
        size=int(s.get("allocated_bytes.all.current", 0)),
        local=int(s.get("allocated_bytes.all.peak",
                        s.get("allocated_bytes.all.current", 0))),
        npools=1 + (len(pool._bufs) if pool is not None else 0),
        nmallocs=int(s.get("allocation.all.allocated", 0)),
    )


def scratch_limit() -> int:
    """XSMM_SCRATCH_LIMIT in bytes (suffixes K/M/G or KB/MB/GB;
    0 = unlimited) — the LIBXSMM_SCRATCH_LIMIT surface.  An unparsable
    value raises: silently disabling a limit the user configured is
    worse than failing loudly."""
    raw = os.environ.get("XSMM_SCRATCH_LIMIT", "0")
    v = raw.strip().upper()
    if v.endswith("B") and len(v) > 1 and v[-2] in "KMG":
        v = v[:-1]
    mult = 1
    for suf, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if v.endswith(suf):
            v, mult = v[:-1], m
            break
    try:
        return int(float(v) * mult)
    except ValueError:
        raise ValueError(
            f"XSMM_SCRATCH_LIMIT={raw!r} is not a byte count "
            f"(expected e.g. 512M, 2G, 1073741824)") from None


@contextlib.contextmanager
def scratch_scope(label: str = "", limit: Optional[int] = None,
                  strict: bool = False, device=None):
    """Measure a region's peak device-memory delta; enforce the limit.

    Yields a dict filled at exit: {peak_delta, live_delta, limit}.
    Exceeding the limit warns, or raises MemoryError when strict.  On the
    CPU the scope is a no-op report.
    """
    before = device_memory_stats(device)
    report: Dict[str, int] = {}
    yield report
    after = device_memory_stats(device)
    lim = scratch_limit() if limit is None else limit
    cur, peak = "allocated_bytes.all.current", "allocated_bytes.all.peak"
    live_delta = (after.get(cur, 0) - before.get(cur, 0)) if after else 0
    # the allocator's peak is a PROCESS-lifetime high-water mark (unless
    # someone resets it): only when the scope raises it is the scope's own
    # peak observable (new peak minus pre-scope live); otherwise the best
    # bound available is the live delta
    pb = before.get(peak, 0)
    pa = after.get(peak, 0) if after else 0
    if pa > pb:
        peak_delta = pa - before.get(cur, 0)
    else:
        peak_delta = max(live_delta, 0)
    report.update(peak_delta=max(peak_delta, 0),
                  live_delta=live_delta, limit=lim)
    if lim and report["peak_delta"] > lim:
        msg = (f"scratch_scope{f' {label!r}' if label else ''}: peak "
               f"device delta {report['peak_delta']} B exceeds limit "
               f"{lim} B (XSMM_SCRATCH_LIMIT)")
        if strict:
            raise MemoryError(msg)
        warnings.warn(msg)


def _pool_bound(max_pools: Optional[int]) -> int:
    if max_pools is None:
        raw = os.environ.get("XSMM_SCRATCH_POOLS", "16")
        try:
            max_pools = int(raw)
        except ValueError:
            raise ValueError(f"XSMM_SCRATCH_POOLS={raw!r} is not an "
                             f"integer") from None
    if max_pools < 1:
        raise ValueError(f"XSMM_SCRATCH_POOLS={max_pools}: the staging pool "
                         f"needs at least one key")
    return max_pools


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class HostStagingPool:
    """Reusable host staging buffers for repeated host->device feeds.

    ``buffer(shape, dtype, slot)`` returns a tensor owned by the pool,
    pinned when a card is present (``pin_memory``); ``mark_in_flight(buf,
    stream)`` records an event on the stream that copies from (or into) it.
    The next ``buffer()`` for the same key waits on that event first.  At
    most ``XSMM_SCRATCH_POOLS`` keys (default 16) are kept, least recently
    used dropped first.  ``slot`` tells same-shape operands of one call
    apart so they neither share nor wait on each other's buffer; the thread
    is part of the key, so threads never share one.  No staging buffer is
    ever returned to a caller of the entry points.

    ``lease(shape, dtype)`` hands out a pinned result block of this thread
    (``RESULT_BLOCKS`` at most a key, the keys bounded as above) as a
    ``_Lease``: ``np.asarray(lease)`` is the caller's array, and the block
    is free again once that array and every view of it are gone.
    """

    def __init__(self, max_pools: Optional[int] = None,
                 pin_memory: Optional[bool] = None):
        self._max = _pool_bound(max_pools)
        self._pin = (torch.cuda.is_available() if pin_memory is None
                     else pin_memory)
        self._bufs: "collections.OrderedDict[Tuple, torch.Tensor]" = \
            collections.OrderedDict()
        # events keyed by POOL KEY: an eviction drops the event with the
        # buffer; mark_in_flight on an evicted buffer is a no-op
        self._in_flight: Dict[Tuple, object] = {}
        # result blocks: key -> [[block, weakref to its lease or None], ...]
        self._results: "collections.OrderedDict[Tuple, list]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.nmallocs = 0
        self.nreuse = 0
        self.nresults = 0       # result blocks allocated
        self.nresult_reuse = 0  # results landed in a block given back

    def buffer(self, shape, dtype, slot: str = "") -> torch.Tensor:
        dt = _torch_dtype(dtype)
        key = (tuple(int(s) for s in shape), str(dt), slot,
               threading.get_ident())
        with self._lock:
            buf = self._bufs.pop(key, None)
            pending = self._in_flight.pop(key, None)
        if pending is not None:
            pending.synchronize()
        if buf is None:
            buf = torch.empty(key[0], dtype=dt, pin_memory=self._pin)
            self.nmallocs += 1
        else:
            self.nreuse += 1
        with self._lock:
            while len(self._bufs) >= self._max:
                old_key, _ = self._bufs.popitem(last=False)
                self._in_flight.pop(old_key, None)
            self._bufs[key] = buf
        return buf

    def mark_in_flight(self, buf: torch.Tensor, stream=None) -> None:
        """Record that a copy on ``stream`` (default: the current stream)
        reads or writes ``buf``."""
        with self._lock:
            # the pool holds at most XSMM_SCRATCH_POOLS buffers: a scan
            key = next((k for k, b in self._bufs.items() if b is buf), None)
        if key is None:
            return
        ev = torch.cuda.Event()
        ev.record(stream if stream is not None
                  else torch.cuda.current_stream())
        with self._lock:
            if self._bufs.get(key) is buf:
                self._in_flight[key] = ev

    def lease(self, shape, dtype) -> Optional["_Lease"]:
        """A lease on a result block of ``shape`` and ``dtype``: one whose
        earlier lease is gone, else a new one while the key keeps fewer than
        ``RESULT_BLOCKS``; None when the caller holds them all."""
        dt = _torch_dtype(dtype)
        key = (tuple(int(s) for s in shape), str(dt),
               threading.get_ident())
        with self._lock:
            blocks = self._results.pop(key, [])
            self._results[key] = blocks
            while len(self._results) > self._max:
                self._results.popitem(last=False)
            slot = next((b for b in blocks
                         if b[1] is None or b[1]() is None), None)
        if slot is not None:
            self.nresult_reuse += 1
        elif len(blocks) < RESULT_BLOCKS:
            slot = [torch.empty(key[0], dtype=dt, pin_memory=self._pin),
                    None]
            self.nresults += 1
            with self._lock:
                blocks.append(slot)
        else:
            return None
        lease = _Lease(slot[0])
        slot[1] = weakref.ref(lease)
        return lease

    def pinned(self) -> bool:
        return self._pin

    def clear(self) -> None:
        with self._lock:
            pending = list(self._in_flight.values())
            self._bufs.clear()
            self._in_flight.clear()
            self._results.clear()
        for ev in pending:   # a dropped buffer may still be on the link
            ev.synchronize()


class _Lease:
    """The owner of a result array over a pooled block: ``np.asarray``
    gives the array, whose base (and every view's) is the lease."""

    def __init__(self, block: torch.Tensor):
        self.block = block
        self.__array_interface__ = block.numpy().__array_interface__


_staging: Optional[HostStagingPool] = None
_staging_lock = threading.Lock()


def get_staging_pool() -> HostStagingPool:
    """The process's pool, made at first use (reading XSMM_SCRATCH_POOLS)."""
    global _staging
    if _staging is None:
        with _staging_lock:
            if _staging is None:
                _staging = HostStagingPool()
    return _staging


def release_scratch() -> None:
    """libxsmm_release_scratch analog: drop the pooled host buffers (after
    their copies have landed) and the result blocks no result holds, and
    empty the caching host allocator's cache where torch offers that; the
    device's caching allocator keeps its blocks."""
    global _staging
    with _staging_lock:
        pool, _staging = _staging, None
    if pool is not None:
        pool.clear()
    import gc
    gc.collect()
    empty = getattr(torch.accelerator, "empty_host_cache", None)
    if empty is not None and torch.cuda.is_initialized():
        empty()


def donate(fn, *donate_argnums: int):
    """JAX's buffer donation has no PyTorch counterpart: the caching
    allocator reuses freed blocks and in-place ops update buffers, so ``fn``
    is returned as it is (a stated difference)."""
    return fn


# ---------------------------------------------------------------------------
# The entry points' host <-> card transfers
# ---------------------------------------------------------------------------


def host_to_device(arr: np.ndarray, device: torch.device,
                   dtype: Optional[torch.dtype] = None,
                   slot: str = "") -> torch.Tensor:
    """``arr`` (numpy, C-contiguous, read in full before this returns) as a
    new tensor of ``dtype`` on the card ``device``.

    Large arrays go through a pinned pool buffer: the host threads fill it
    chunk by chunk (``Tensor.copy_``) while the previous chunk's
    non-blocking copy is on the link.  An f64 array wanted as f32 is rounded
    by the host on the fill (round to nearest on either side, so the bits
    are those of a rounding on the card) and only the f32 bytes cross the
    link; other conversions run on the card.  Small arrays take the plain
    copy."""
    src = torch.from_numpy(arr)
    dtype = src.dtype if dtype is None else dtype
    if src.numel() * src.element_size() < STAGE_MIN_BYTES:
        return src.to(device=device, dtype=dtype)
    wire = (dtype if (src.dtype, dtype) == (torch.float64, torch.float32)
            else src.dtype)
    pool = get_staging_pool()
    buf = pool.buffer(src.shape, wire, slot)
    out = torch.empty(src.shape, dtype=wire, device=device)
    fb, fs, fo = buf.view(-1), src.view(-1), out.view(-1)
    step = max(1, CHUNK_BYTES // buf.element_size())
    for i in range(0, fb.numel(), step):
        fb[i:i + step].copy_(fs[i:i + step])
        fo[i:i + step].copy_(fb[i:i + step], non_blocking=True)
    pool.mark_in_flight(buf, torch.cuda.current_stream(device))
    return out if wire == dtype else out.to(dtype)


def device_to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` (on the card) as a numpy array that no later call writes.

    A large result lands in a pinned block leased from the pool (see the
    module's docstring), synchronized before the array is returned.  When
    the caller holds every block of the key, it comes back through two
    pinned pool chunks in turns into a new pageable array: while one chunk
    is on the link, the host threads copy the other, landed, one into the
    result (``Tensor.copy_``), each chunk synchronized before it is read."""
    t = t.contiguous()
    stream = torch.cuda.current_stream(t.device)
    if t.numel() * t.element_size() < STAGE_MIN_BYTES:
        return t.cpu().numpy()
    pool = get_staging_pool()
    lease = pool.lease(t.shape, t.dtype)
    if lease is not None:
        lease.block.copy_(t, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(stream)
        landed.synchronize()
        return np.asarray(lease)
    res = torch.empty(t.shape, dtype=t.dtype)
    step = max(1, CHUNK_BYTES // t.element_size())
    ring = pool.buffer((2, step), t.dtype, "device_to_host")
    ft, fr, n = t.view(-1), res.view(-1), t.numel()
    starts = list(range(0, n, step))
    landed = [None, None]

    def issue(j):
        s = starts[j]
        ring[j % 2, :min(step, n - s)].copy_(ft[s:s + step],
                                             non_blocking=True)
        landed[j % 2] = torch.cuda.Event()
        landed[j % 2].record(stream)

    try:
        for j in range(min(2, len(starts))):
            issue(j)
        for j, s in enumerate(starts):
            landed[j % 2].synchronize()
            fr[s:s + step].copy_(ring[j % 2, :min(step, n - s)])
            if j + 2 < len(starts):
                issue(j + 2)
    finally:
        # nothing is left on the link after a whole loop; after an error
        # the next user of the ring waits for what may be
        pool.mark_in_flight(ring, stream)
    return res.numpy()
