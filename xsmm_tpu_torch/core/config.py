"""Runtime configuration for xsmm_tpu_torch.

The same fields, defaults and ``XSMM_*`` environment names as the JAX
package's ``xsmm_tpu/core/config.py``, so one environment drives both
packages (the analog of LIBXSMM's env-var surface, libxsmm_main.c:562-677).

What differs in this package:

* ``target``: "cuda" (or "" = the card) runs every entry point on the GPU;
  "cpu" selects the CPU and each kernel's plain PyTorch version.  With the
  target unset and no CUDA device, building or calling a kernel raises.
* ``interpret``: kept for parity and has no effect here.  A CUDA kernel has
  no interpreter; the plain versions run exactly when the tensors lie on
  the CPU (``target="cpu"``).
* ``use_native`` (``XSMM_NATIVE``, default 1): the registry index, the .mtx
  reader and spmdm's ELL pack run in the C++ runtime of ``native/``, which
  ``core/native_bridge`` builds at first use; a failed build raises.  0
  selects the Python paths.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass
class Config:
    """Process-wide configuration (reference: libxsmm_main.c:546-705 internal_init)."""

    # Verbosity: 0 silent, 1 errors, 2 warnings+stats at exit, >=3 debug.
    verbose: int = 0

    # Target override: "cuda", "cpu", or "" = the CUDA card (the analog of
    # LIBXSMM_TARGET, libxsmm_main.c:617-621).
    target: str = ""

    # FP64 strategy: "split2_fast" (default), "split2", "float32" or
    # "native" (a real f64 torch.matmul on the card).
    f64_strategy: str = "split2_fast"

    # Dispatch cache capacity (reference: 131072-slot registry).
    registry_capacity: int = 131072

    # Per-thread MRU cache size (reference: LIBXSMM_CACHE_MAXSIZE = 4).
    cache_maxsize: int = 4

    # Tiled-GEMM tile overrides, 0 = auto (LIBXSMM_TGEMM_M/N/K).
    tgemm_m: int = 0
    tgemm_n: int = 0
    tgemm_k: int = 0

    # M*N*K above which dispatch leaves the batched kernels for the plain
    # product path ((M*N*K)^(1/3) <= 64 is "small"; reference README.md:11).
    gemm_threshold: int = 64 * 64 * 64

    # AOT shape list: comma-separated "MxNxK[:dtype]" specs.
    aot_shapes: str = ""

    # Pivot count up to which getrf/trsm unroll their pivot loops.
    getrf_unroll: int = 64

    # Batched-SMM backend: "pallas" (the packed kernels; the name is kept so
    # one environment drives both packages) or "xla" (the plain batched
    # product path).
    smm_backend: str = "pallas"

    # Parity only; see the module docstring.
    interpret: Optional[bool] = None

    # The C++ runtime of native/; see the module docstring.
    use_native: bool = True

    @staticmethod
    def from_env() -> "Config":
        return Config(
            verbose=_env_int("XSMM_VERBOSE", 0),
            target=_env_str("XSMM_TARGET", ""),
            f64_strategy=_env_str("XSMM_F64", "split2_fast"),
            registry_capacity=_env_int("XSMM_REGISTRY_CAPACITY", 131072),
            cache_maxsize=_env_int("XSMM_CACHE_MAXSIZE", 4),
            tgemm_m=_env_int("XSMM_TGEMM_M", 0),
            tgemm_n=_env_int("XSMM_TGEMM_N", 0),
            tgemm_k=_env_int("XSMM_TGEMM_K", 0),
            gemm_threshold=_env_int("XSMM_GEMM_THRESHOLD", 64 * 64 * 64),
            aot_shapes=_env_str("XSMM_AOT_SHAPES", ""),
            getrf_unroll=_env_int("XSMM_GETRF_UNROLL", 64),
            smm_backend=_env_str("XSMM_SMM_BACKEND", "pallas"),
            interpret=(None if "XSMM_INTERPRET" not in os.environ
                       else bool(_env_int("XSMM_INTERPRET", 0))),
            use_native=bool(_env_int("XSMM_NATIVE", 1)),
        )


_CONFIG: Optional[Config] = None


def get_config() -> Config:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = Config.from_env()
    return _CONFIG


_GENERATION = 0


def config_generation() -> int:
    """Monotone counter bumped by every set_config: lets the dispatch memo
    (ops/smm.mmdispatch) drop kernels built under an older config."""
    return _GENERATION


def set_config(**kwargs) -> Config:
    """Override config fields programmatically (tests, notebooks)."""
    global _GENERATION
    cfg = get_config()
    for k, v in kwargs.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"unknown config field: {k}")
        setattr(cfg, k, v)
    _GENERATION += 1
    if "target" in kwargs or "interpret" in kwargs:
        # platform.backend() is cached; a new target must take effect
        from . import platform
        platform.reset_platform_cache()
    return cfg


def set_verbosity(level: int) -> int:
    """Analog of libxsmm_set_verbosity (libxsmm_main.c:1101-1113)."""
    cfg = get_config()
    prev, cfg.verbose = cfg.verbose, int(level)
    return prev
