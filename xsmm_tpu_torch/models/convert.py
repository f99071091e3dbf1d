"""Weights carried across from the JAX package.

``params_from_jax`` turns the JAX package's model parameters (the
``{"layers": ..., "_meta": ...}`` tree of ``resnet(...)`` and the rest,
with arrays as numpy arrays or anything ``np.asarray`` reads) into the
port's tree of tensors, structure kept: dicts stay dicts, lists lists,
None None, and the ``_meta`` entries are copied as they are.
``state_from_jax`` does the same for the BN running state (a dict of the
JAX ``BnRunning``), giving the port's ``BnRunning``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import platform
from ..dnn.batchnorm import BnRunning
from ..ops.smm import as_tensor
from .engine import tree_map


def _device(device) -> torch.device:
    return platform.device() if device is None else torch.device(device)


def params_from_jax(tree, device=None):
    """The JAX package's parameter tree as the port's, on ``device``
    (default: the entry points' device); the top level's ``_`` entries
    (``_meta``) pass as they are."""
    dev = _device(device)

    def leaf(a):
        return as_tensor(np.array(a), dev).contiguous()

    if isinstance(tree, dict):
        return {k: v if k.startswith("_") else tree_map(leaf, v)
                for k, v in tree.items()}
    return tree_map(leaf, tree)


def state_from_jax(state, device=None):
    """The JAX package's BN running state ({key: BnRunning}) as the
    port's, on ``device`` (default: the entry points' device)."""
    dev = _device(device)
    return {k: BnRunning(*params_from_jax(tuple(v), dev))
            for k, v in state.items()}
