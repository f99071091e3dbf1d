"""Platform detection — the CPUID analog.

Reference: src/libxsmm_cpuid_x86.c:85 detects the ISA and
libxsmm_main.c:1027 lets LIBXSMM_TARGET override it.  Here the platform is
the CUDA card, and ``target="cpu"`` (``XSMM_TARGET=cpu``) selects the CPU,
where every kernel wrapper takes its plain PyTorch version — the analog of
the reference's ``noarch`` fallback, used by the tests.  With the target
unset the entry points run on the card; with no card they raise, they never
fall back to the CPU.
"""

from __future__ import annotations

import functools

import torch

from .config import get_config

_TARGETS = ("cuda", "cpu")


@functools.lru_cache(maxsize=None)
def backend() -> str:
    """"cuda" or "cpu": the configured target, else the card."""
    target = get_config().target or "cuda"
    if target not in _TARGETS:
        raise ValueError(f"unknown target {target!r}; expected one of "
                         f"{list(_TARGETS)} (XSMM_TARGET)")
    return target


def device() -> torch.device:
    """The device the entry points run on; raises when the target is the
    card and there is none."""
    if backend() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "xsmm_tpu_torch: no CUDA device (torch.cuda.is_available() is "
            "False) and the target is the card; set XSMM_TARGET=cpu (or "
            "set_config(target='cpu')) to run the plain versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def interpret_mode() -> bool:
    """Whether the plain PyTorch versions run in place of the kernels: true
    exactly when the target is the CPU."""
    return backend() == "cpu"


@functools.lru_cache(maxsize=None)
def target_name() -> str:
    """Analog of libxsmm_cpuid_name (libxsmm_cpuid_x86.c:164)."""
    if backend() == "cpu":
        return "cpu"
    device()  # raises without a card
    return torch.cuda.get_device_name(0)


def reset_platform_cache() -> None:
    backend.cache_clear()
    target_name.cache_clear()
