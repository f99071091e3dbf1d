"""Standard image-format ingestion -> packed XSD1 datasets: the port's own
copy of ``xsmm_tpu/utils/images.py`` (numpy only; the same bytes in and
out as the JAX package's).

The GxM data path reads standard image formats into its LMDB training
store (samples/deeplearning/gxm: JPEG via OpenCV + LMDB,
documentation/gxm.md).  The framework carries no image codec, so it reads
the uncompressed standards a numpy-only reader can own completely:

  * netpbm  P5 (PGM, grayscale) / P6 (PPM, RGB), binary, maxval <= 255
  * BMP     uncompressed 24-bit BGR (the Windows V3 header)
  * MHD     MetaImage volumes via utils/mhd (already in-tree)

``ingest_image_dir`` is the dataset-prep step: a directory of class
subdirectories (the torchvision/ImageFolder convention, which GxM's list
files encode equivalently) becomes one packed XSD1 file consumable by the
native prefetching DataLoader.  Resize is area-average downscale /
nearest upscale, numpy-only.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from .dataset import write_dataset
from .mhd import mhd_read


def read_pnm(path: str) -> np.ndarray:
    """Read a binary PGM (P5) or PPM (P6) file -> uint8 [H,W,C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM/PPM (P5/P6) file")
    rgb = data[:2] == b"P6"
    # header tokens: magic, width, height, maxval; '#' comments allowed
    tokens: List[bytes] = []
    i = 2
    while len(tokens) < 3:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    w, h, maxval = (int(t) for t in tokens)
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit netpbm not supported")
    i += 1  # single whitespace after maxval
    c = 3 if rgb else 1
    px = np.frombuffer(data, np.uint8, count=h * w * c, offset=i)
    img = px.reshape(h, w, c)
    if maxval != 255:
        # netpbm values are relative to maxval: rescale to full range
        img = np.clip(np.round(img.astype(np.float32) * (255.0 / maxval)),
                      0, 255).astype(np.uint8)
    return img


def write_pnm(path: str, img: np.ndarray) -> None:
    """Write uint8 [H,W] / [H,W,1] (P5) or [H,W,3] (P6)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    magic = b"P6" if c == 3 else b"P5"
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def read_bmp(path: str) -> np.ndarray:
    """Read an uncompressed 24-bit BMP -> uint8 [H,W,3] (RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    off = struct.unpack_from("<I", data, 10)[0]
    w, h = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    comp = struct.unpack_from("<I", data, 30)[0]
    if bpp != 24 or comp != 0:
        raise ValueError(f"{path}: only uncompressed 24-bit BMP supported "
                         f"(bpp={bpp}, compression={comp})")
    flip = h > 0          # positive height = bottom-up rows
    h = abs(h)
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=stride * h, offset=off)
    rows = rows.reshape(h, stride)[:, :w * 3].reshape(h, w, 3)
    if flip:
        rows = rows[::-1]
    return rows[:, :, ::-1].copy()  # BGR -> RGB


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write uint8 [H,W,3] RGB as an uncompressed 24-bit BMP."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    bgr = img[:, :, ::-1]
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = bgr.reshape(h, w * 3)
    rows = rows[::-1]  # bottom-up
    pix = rows.tobytes()
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 54 + len(pix), 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                            len(pix), 2835, 2835, 0, 0))
        f.write(pix)


_READERS = {
    ".ppm": read_pnm, ".pgm": read_pnm, ".pnm": read_pnm,
    ".bmp": read_bmp,
    ".mhd": lambda p: np.asarray(mhd_read(p)),
}


def read_image(path: str) -> np.ndarray:
    """Read any supported format -> uint8 [H,W,C]."""
    ext = os.path.splitext(path)[1].lower()
    reader = _READERS.get(ext)
    if reader is None:
        raise ValueError(
            f"{path}: unsupported image format {ext!r} (supported: "
            f"{sorted(_READERS)}; no JPEG/PNG codec is built in)")
    img = np.asarray(reader(path))
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        # e.g. a [D,H,W] MHD volume: depth is NOT a channel axis — force
        # the caller to slice explicitly rather than silently mislabel
        raise ValueError(
            f"{path}: shape {img.shape} is not a 2-D image (volumes must "
            f"be sliced before ingestion)")
    if img.dtype != np.uint8:
        # float images in [0,1] scale to the u8 range; anything else
        # clips (integer types are already absolute)
        if np.issubdtype(img.dtype, np.floating) and img.size \
                and float(np.nanmax(np.abs(img))) <= 1.0:
            img = img * 255.0
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


def resize(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Resize uint8 [H,W,C]: integer-factor area-average downscale when
    divisible, else nearest-neighbor (numpy-only; codecs own fancy
    filtering in richer environments)."""
    h0, w0, c = img.shape
    h1, w1 = hw
    if h0 == h1 and w0 == w1:
        return img
    if h0 % h1 == 0 and w0 % w1 == 0:
        fh, fw = h0 // h1, w0 // w1
        return (img.reshape(h1, fh, w1, fw, c).mean((1, 3))
                .astype(np.uint8))
    yi = np.minimum((np.arange(h1) * h0) // h1, h0 - 1)
    xi = np.minimum((np.arange(w1) * w0) // w1, w0 - 1)
    return img[yi][:, xi]


def ingest_image_dir(root: str, out_path: str, hw: Tuple[int, int] = (32, 32),
                     channels: int = 3,
                     classes: Optional[List[str]] = None) -> dict:
    """Directory of class subdirectories -> packed XSD1 dataset.

    The GxM dataset-prep analog (its list files name (path, label) pairs;
    the subdirectory name IS the label here).  Returns a manifest dict
    {classes, n_images, out_path}."""
    classes = classes or sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"{root}: no class subdirectories")
    images, labels = [], []
    for li, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for name in sorted(os.listdir(cdir)):
            if os.path.splitext(name)[1].lower() not in _READERS:
                continue
            img = resize(read_image(os.path.join(cdir, name)), hw)
            if img.shape[2] == 1 and channels == 3:
                img = np.repeat(img, 3, axis=2)
            elif img.shape[2] == 3 and channels == 1:
                img = img.mean(axis=2, keepdims=True).astype(np.uint8)
            images.append(img)
            labels.append(li)
    if not images:
        raise ValueError(f"{root}: no readable images "
                         f"(supported: {sorted(_READERS)})")
    write_dataset(out_path, np.stack(images),
                  np.asarray(labels, np.int32))
    return {"classes": classes, "n_images": len(images),
            "out_path": out_path}
