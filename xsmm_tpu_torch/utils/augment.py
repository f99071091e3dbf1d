"""Image augmentation on the device — the GxM JitterData analog: the port of
``xsmm_tpu/utils/augment.py``.

Reference: samples/deeplearning/gxm/src/JitterData.cpp augments on host
worker threads (random crop with mirror, scale/color jitter, mean
subtraction) before feeding the device.  As in the JAX package the
augmentation runs on the device, on the raw batch: pad -> per-image random
crop -> random horizontal mirror -> brightness/contrast jitter -> mean
subtraction.

The random draws are split from the transform: ``augment.draw(gen, x)``
makes them from a ``torch.Generator`` (where the JAX package takes a key:
the bits differ, the distributions are the same) and
``augment.transform(x, draws)`` applies them, so the JAX package's own
draws can be fed to the port's transform.

Usage:
    aug = make_augment(crop=32, pad=4, flip=True,
                       brightness=0.2, contrast=0.2)
    x_aug = aug(gen, x)   # x: [B,H,W,C] f32 tensor, gen on x's device
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F


class AugmentDraws(NamedTuple):
    """One batch's draws; a field is None where its step is off."""

    oy: Optional[torch.Tensor]      # [B] int64 crop row offsets
    ox: Optional[torch.Tensor]      # [B] int64 crop column offsets
    flip: Optional[torch.Tensor]    # [B] bool horizontal mirror
    bright: Optional[torch.Tensor]  # [B] f32 brightness shift
    contrast: Optional[torch.Tensor]  # [B] f32 contrast factor


def make_augment(crop: Optional[int] = None, pad: int = 4,
                 flip: bool = True, brightness: float = 0.0,
                 contrast: float = 0.0,
                 mean: Optional[Sequence[float]] = None):
    """Build an augmentation fn(gen, x [B,H,W,C]) -> [B,h',w',C].

    crop: output side (random-crop window from the ``pad``-padded image);
    None keeps the input size (crop after padding still jitters position).
    flip: random horizontal mirror per image.
    brightness/contrast: uniform jitter amplitudes (0 disables).
    mean: per-channel mean to subtract (the mean-file analog).
    """

    def out_hw(h, w):
        return crop or h, crop or w

    def draw(gen: torch.Generator, x: torch.Tensor) -> AugmentDraws:
        b, h, w, _ = x.shape
        dev = x.device
        oy = ox = fl = db = dc = None
        if pad or crop:
            oh, ow = out_hw(h, w)
            oy = torch.randint(0, h + 2 * pad - oh + 1, (b,), generator=gen,
                               device=dev)
            ox = torch.randint(0, w + 2 * pad - ow + 1, (b,), generator=gen,
                               device=dev)
        if flip:
            fl = torch.rand((b,), generator=gen, device=dev) < 0.5
        if brightness:
            db = (torch.rand((b,), generator=gen, device=dev) * 2 - 1) \
                * brightness
        if contrast:
            dc = 1.0 + (torch.rand((b,), generator=gen, device=dev) * 2 - 1) \
                * contrast
        return AugmentDraws(oy, ox, fl, db, dc)

    def transform(x: torch.Tensor, d: AugmentDraws) -> torch.Tensor:
        b, h, w, c = x.shape
        if pad or crop:
            oh, ow = out_hw(h, w)
            xp = F.pad(x, (0, 0, pad, pad, pad, pad))
            rows = d.oy.to(x.device)[:, None] + torch.arange(
                oh, device=x.device)
            cols = d.ox.to(x.device)[:, None] + torch.arange(
                ow, device=x.device)
            bi = torch.arange(b, device=x.device)[:, None, None]
            x = xp[bi, rows[:, :, None], cols[:, None, :]]
        if flip:
            x = torch.where(d.flip.to(x.device)[:, None, None, None],
                            x.flip(2), x)
        if brightness:
            x = x + d.bright.to(x.device, x.dtype)[:, None, None, None]
        if contrast:
            dc = d.contrast.to(x.device, x.dtype)[:, None, None, None]
            m = x.mean(dim=(1, 2, 3), keepdim=True)
            x = (x - m) * dc + m
        if mean is not None:
            x = x - torch.as_tensor(mean, dtype=x.dtype,
                                    device=x.device).reshape(1, 1, 1, -1)
        return x

    def augment(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        return transform(x, draw(gen, x))

    augment.draw = draw
    augment.transform = transform
    return augment
