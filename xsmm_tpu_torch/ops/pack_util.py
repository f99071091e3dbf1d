"""Padding and lane-packing helpers on tensors.

The counterpart of ``xsmm_tpu/ops/pallas_util.py`` without its interpret
switch: which code runs (kernel or plain version) follows the device of the
tensors.  ``LANES`` is kept because the reference's routing rule
(``ops/smm._fits_vmem``) is written in it.
"""

from __future__ import annotations

import torch

LANES = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_axis(x: torch.Tensor, axis: int, to_multiple: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``to_multiple``."""
    size = x.shape[axis]
    target = round_up(size, to_multiple)
    if target == size:
        return x
    shape = list(x.shape)
    shape[axis] = target - size
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def pack_lanes(x: torch.Tensor, lane_multiple: int = 1) -> torch.Tensor:
    """[B, ...dims] -> [...dims, Bp]: move batch to the last, contiguous axis.

    The SOA/packed layout of the reference (one problem per batch index).
    The kernels take any Bp, so no padding is needed unless asked for.
    """
    return pad_axis(torch.movedim(x, 0, -1).contiguous(), -1, lane_multiple)


def unpack_lanes(x: torch.Tensor, batch: int) -> torch.Tensor:
    """Inverse of pack_lanes: [...dims, Bp] -> [B, ...dims]."""
    return torch.movedim(x, -1, 0)[:batch]
