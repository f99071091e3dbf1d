"""Code registry and dispatch cache.

Reference: internal_find_code (src/libxsmm_main.c:1697-1925): a 131072-slot
hash table of JIT'd kernels keyed by packed descriptors, with a 4-entry
per-thread MRU cache in front and double-checked locking around the build.
Statistics (TRY/JIT/STA/COL, bucketed sml/med/big/xxx) are printed at exit
under LIBXSMM_VERBOSE (internal_print_statistic, libxsmm_main.c:278-348).

The port of ``xsmm_tpu/core/registry.py``.  A "kernel" is a built callable
(a ``BatchedSMM``, say, whose CUDA library is built at first launch).  The
hash probe runs in the C++ CRC32C open-addressing table
(``native/registry.cpp``, through ``core/native_bridge``; ``info()["native"]``
is True) unless ``XSMM_NATIVE=0``, which selects a Python dict with the same
semantics.  Either way the kernels live in a Python-side table indexed by
slot, and the dict stays authoritative for release and introspection.  A
failed native build raises; it does not fall back to the dict.
"""

from __future__ import annotations

import atexit
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import trace
from .config import get_config


def _make_native(capacity: int):
    """The native index, or None under ``XSMM_NATIVE=0``; raises when the
    library cannot be built or loaded."""
    if not get_config().use_native:
        return None
    from . import native_bridge
    return native_bridge.load(capacity)


class Stats:
    """Dispatch statistics (reference: libxsmm_main.c:278-348).

    Buckets: sml (<=13^3), med (<=23^3), big (<=64^3), xxx (beyond) —
    thresholds from libxsmm_main.c:635-637.
    """

    BUCKETS = ("sml", "med", "big", "xxx")

    def __init__(self):
        self.lock = threading.Lock()
        self.ntry = 0     # dispatch attempts
        self.njit = 0     # kernels built at runtime
        self.nsta = 0     # kernels registered statically (AOT list)
        self.ncol = 0     # key collisions / cache evictions
        self.ncache_hit = 0
        self.by_bucket: Dict[str, Dict[str, int]] = {}

    @staticmethod
    def bucket(m: int, n: int, k: int) -> str:
        v = max(1, m) * max(1, n) * max(1, k)
        if v <= 13 ** 3:
            return "sml"
        if v <= 23 ** 3:
            return "med"
        if v <= 64 ** 3:
            return "big"
        return "xxx"

    def record(self, kind: str, dtype: str, bucket: str, jit: bool, static: bool):
        with self.lock:
            self.ntry += 1
            if jit:
                self.njit += 1
            if static:
                self.nsta += 1
            row = self.by_bucket.setdefault(dtype, {b: 0 for b in self.BUCKETS})
            row[bucket] += 1

    def summary(self, nbytes: int = 0) -> str:
        lines = ["xsmm_tpu_torch dispatch statistics:",
                 f"  TRY={self.ntry} JIT={self.njit} STA={self.nsta} "
                 f"COL={self.ncol} HIT={self.ncache_hit}"
                 + (f" registry~{nbytes / 1024:.0f}KB" if nbytes else "")]
        if self.by_bucket:
            lines.append("  dtype      sml    med    big    xxx")
            for dt, row in sorted(self.by_bucket.items()):
                lines.append("  {:<9}{:>6} {:>6} {:>6} {:>6}".format(
                    dt, row["sml"], row["med"], row["big"], row["xxx"]))
        return "\n".join(lines)


class RegistryEntry:
    __slots__ = ("kernel", "descriptor", "nbytes_est", "name", "hits")

    def __init__(self, kernel: Callable, descriptor: Any, name: str):
        self.kernel = kernel
        self.descriptor = descriptor
        self.name = name
        self.nbytes_est = 0
        self.hits = 0

    def info(self) -> Dict[str, Any]:
        """Per-kernel introspection record (libxsmm_get_mmkernel_info
        analog, src/libxsmm_main.c:1969)."""
        d = self.descriptor
        return {
            "name": self.name,
            "kind": type(d).__name__,
            "m": getattr(d, "m", None),
            "n": getattr(d, "n", None),
            "k": getattr(d, "k", None),
            "batch": getattr(d, "batch", None),
            "dtype": str(getattr(d, "in_dtype",
                                 getattr(d, "dtype", "?"))),
            "flags": getattr(d, "flags", 0),
            "nbytes_est": self.nbytes_est,
            "hits": self.hits,
        }


class Registry:
    """Descriptor -> built-kernel registry with MRU front cache."""

    def __init__(self, capacity: Optional[int] = None):
        cfg = get_config()
        self.capacity = capacity or cfg.registry_capacity
        self._table: Dict[bytes, RegistryEntry] = {}
        self._entries: List[Optional[RegistryEntry]] = []  # slot-indexed
        # Reentrant: dispatch() holds this lock across builder(), and a
        # builder may dispatch another kernel.
        self._build_lock = threading.RLock()
        self._tls = threading.local()
        self.stats = Stats()
        # the native CRC32C probe table as the fast index; None => the dict
        self._native = _make_native(self.capacity)
        self.native_finds = 0   # lookups answered by the native index
        # Front memo for the typed dispatch frontends (ops/smm.mmdispatch):
        # raw-args tuple -> (kernel, stats row, bucket, entry).  Cleared by
        # release()/clear().
        self.front_memo: Dict[Any, Any] = {}

    # -- MRU per-thread cache (reference: TLS cache, libxsmm_main.c:1704-1732)
    def _cache(self) -> List[Tuple[bytes, RegistryEntry]]:
        c = getattr(self._tls, "cache", None)
        if c is None:
            c = []
            self._tls.cache = c
        return c

    def _cache_probe(self, key: bytes) -> Optional[RegistryEntry]:
        cache = self._cache()
        for i, (k, e) in enumerate(cache):
            if k == key:
                if i:
                    cache.insert(0, cache.pop(i))
                return e
        return None

    def _cache_insert(self, key: bytes, entry: RegistryEntry):
        cache = self._cache()
        cache.insert(0, (key, entry))
        if len(cache) > get_config().cache_maxsize:
            cache.pop()
            self.stats.ncol += 1

    def lookup(self, key: bytes) -> Optional[RegistryEntry]:
        e = self._cache_probe(key)
        if e is not None:
            self.stats.ncache_hit += 1
            e.hits += 1
            return e
        if self._native is not None:
            slot = self._native.find(key)
            e = self._entries[slot] if slot >= 0 else None
            if e is not None:
                self.native_finds += 1
        else:
            e = self._table.get(key)
        if e is not None:
            e.hits += 1
            self._cache_insert(key, e)
        return e

    def kernel_info(self, descriptor) -> Optional[Dict[str, Any]]:
        """libxsmm_get_mmkernel_info analog (libxsmm_main.c:1969)."""
        e = self._table.get(descriptor.pack())
        return e.info() if e is not None else None

    def kernels(self) -> List[Dict[str, Any]]:
        """One info record per registered kernel, hottest first
        (libxsmm_get_registry_info's walk, libxsmm_main.c:2092)."""
        with self._build_lock:
            entries = list(self._table.values())
        return sorted((e.info() for e in entries), key=lambda r: -r["hits"])

    def insert(self, key: bytes, entry: RegistryEntry) -> RegistryEntry:
        """Insert under the build lock; first writer wins (double-checked)."""
        with self._build_lock:
            return self._insert_locked(key, entry)

    def _insert_locked(self, key: bytes, entry: RegistryEntry) -> RegistryEntry:
        existing = self._table.get(key)
        if existing is not None:
            return existing
        if len(self._table) >= self.capacity:
            # Degrade like the reference (libxsmm_main.c:1880-1890): a full
            # registry yields an uncached kernel, not an error.
            self.stats.ncol += 1
            if get_config().verbose:
                import warnings
                warnings.warn("xsmm_tpu_torch registry capacity exhausted; "
                              "kernel not cached")
            # The thread-local MRU cache still holds it, so a hot
            # over-capacity descriptor is not rebuilt on every dispatch.
            self._cache_insert(key, entry)
            return entry
        self._table[key] = entry
        self._entries.append(entry)
        if self._native is not None:
            try:
                slot = self._native.insert(key, len(self._entries) - 1)
            except RuntimeError:
                # the native table never removes keys, so release/insert
                # churn can fill it while the dict is below capacity: the
                # dict takes over as the index (as in the JAX package)
                self._native = None
                self.stats.ncol += 1
            else:
                if slot != len(self._entries) - 1:
                    # stale slot of a released key: repoint it
                    self._entries[slot] = entry
        self._cache_insert(key, entry)
        return entry

    def dispatch(self, descriptor, builder: Callable[[], Callable],
                 name: str = "", static: bool = False) -> Callable:
        """The internal_find_code analog: probe, else build under lock.

        ``builder`` runs at most once per descriptor per process.
        """
        key = descriptor.pack()
        entry = self.lookup(key)
        jit = False
        if entry is None:
            # Build exactly once per descriptor (reference:
            # INTERNAL_FIND_CODE_LOCK around libxsmm_build,
            # libxsmm_main.c:1822-1857).
            with self._build_lock:
                entry = self._table.get(key)
                if entry is None:
                    jit = True
                    with trace.span("registry.build"):
                        kernel = builder()
                    entry = RegistryEntry(kernel, descriptor, name)
                    # working-set estimate for the registry-bytes stat:
                    # per-problem operand bytes x batch, f64 counted at
                    # 8 B/element (an f32 hi/lo pair)
                    m = getattr(descriptor, "m", 0)
                    n = getattr(descriptor, "n", 0)
                    k0 = getattr(descriptor, "k", 0)
                    dt = str(getattr(descriptor, "in_dtype",
                                     getattr(descriptor, "dtype", "f4")))
                    isz = 8 if "64" in dt else (2 if "16" in dt else 4)
                    bat = max(int(getattr(descriptor, "batch", 1)), 1)
                    entry.nbytes_est = isz * bat * (m * k0 + k0 * n + m * n)
                    entry = self._insert_locked(key, entry)
        m = getattr(descriptor, "m", 1)
        n = getattr(descriptor, "n", 1)
        k = getattr(descriptor, "k", 1)
        dt = getattr(descriptor, "in_dtype", getattr(descriptor, "dtype", "?"))
        self.stats.record(type(descriptor).__name__, dt,
                          Stats.bucket(m, n, k), jit=jit, static=static)
        return entry.kernel

    def release(self, descriptor) -> bool:
        """Analog of libxsmm_release_kernel (libxsmm_main.c:2585)."""
        key = descriptor.pack()
        with self._build_lock:
            e = self._table.pop(key, None)
            if e is not None:
                # tombstone the slot (native keys are not removable; the
                # slot is repointed on re-insert of the same key)
                for i, ent in enumerate(self._entries):
                    if ent is e:
                        self._entries[i] = None
                        break
            self._tls = threading.local()  # drop MRU references
            self.front_memo.clear()
            return e is not None

    def info(self) -> Dict[str, Any]:
        """Analog of libxsmm_get_registry_info (libxsmm_main.c:2092)."""
        return {
            "capacity": self.capacity,
            "size": len(self._table),
            "nbytes": sum(e.nbytes_est for e in self._table.values()),
            "native": self._native is not None,
            "ntry": self.stats.ntry,
            "njit": self.stats.njit,
            "nsta": self.stats.nsta,
            "ncol": self.stats.ncol,
            "nhit": self.stats.ncache_hit,
        }

    def clear(self):
        with self._build_lock:
            self._table.clear()
            self._entries.clear()
            if self._native is not None:
                self._native.clear()
            self._tls = threading.local()
            self.front_memo.clear()


_REGISTRY: Optional[Registry] = None
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> Registry:
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = Registry()
    return _REGISTRY


def initialized() -> bool:
    return _REGISTRY is not None


def finalize(verbose: Optional[bool] = None):
    """Analog of libxsmm_finalize (libxsmm_main.c:822): print stats, drop cache."""
    global _REGISTRY
    if _REGISTRY is None:
        return
    v = get_config().verbose if verbose is None else verbose
    if v and _REGISTRY.stats.ntry:
        print(_REGISTRY.stats.summary(_REGISTRY.info()["nbytes"]))
    _REGISTRY = None


@atexit.register
def _atexit_stats():
    if _REGISTRY is not None and get_config().verbose >= 2 and _REGISTRY.stats.ntry:
        print(_REGISTRY.stats.summary(_REGISTRY.info()["nbytes"]))
