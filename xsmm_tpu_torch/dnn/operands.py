"""Operands of the DNN layer handles: where they run, and carrying the JAX
package's parameters across.

A layer call runs on the device of the first tensor among its operands;
with none (numpy arrays, lists) on the entry points' device,
``platform.device()``: the card unless ``target="cpu"``.  Every other
operand is moved there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import platform
from ..ops.smm import as_tensor


def device_of(*xs) -> torch.device:
    """The device of the first tensor among ``xs``, else the entry points'
    device (which raises without a card unless the target is the CPU)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return platform.device()


def on(x, dev: torch.device,
       dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """``x`` (tensor or array-like) on ``dev`` in ``dtype``; None stays
    None.  A tensor already there is returned as it is, so autograd flows
    through."""
    return None if x is None else as_tensor(x, dev, dtype)


def dnn_params_from_numpy(*params, device=None):
    """The JAX package's layer parameters as the port's tensors on
    ``device`` (default: the entry points' device), in the same structure:
    an array becomes a tensor of its dtype; a tuple or list (FC's
    ``(w, bias)``, conv's ``(w, bias)`` with w in its filter format, BN's
    ``(gamma, beta)``) its tuple; a JAX ``BnRunning`` the port's
    ``BnRunning``.  Returns one converted value per argument (the value
    itself for one argument)."""
    from .batchnorm import BnRunning

    dev = platform.device() if device is None else torch.device(device)

    def conv(p):
        if p is None:
            return None
        if getattr(p, "_fields", None) == BnRunning._fields:
            return BnRunning(*(conv(v) for v in p))
        if isinstance(p, (tuple, list)):
            return tuple(conv(v) for v in p)
        return as_tensor(np.asarray(p), dev).contiguous()

    out = tuple(conv(p) for p in params)
    return out[0] if len(out) == 1 else out
