"""MetaImage (.mhd/.raw) I/O — tensor debug dumps.

Reference: src/libxsmm_mhd.c — read/write MetaImage files used by the DNN
samples and tests/mhd.c for dumping/inspecting tensors as images.

The port's own copy of ``xsmm_tpu/utils/mhd.py`` (numpy only): a file written
by either package reads back the same in the other.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_TYPES = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG": np.int64, "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_RTYPES = {np.dtype(v): k for k, v in _TYPES.items()}


def mhd_write(path: str, data: np.ndarray) -> None:
    """Write array as .mhd header + .raw payload (libxsmm_mhd_write)."""
    data = np.ascontiguousarray(data)
    base = os.path.splitext(path)[0]
    raw_name = os.path.basename(base) + ".raw"
    dt = np.dtype(data.dtype)
    if dt not in _RTYPES:
        raise ValueError(f"unsupported element type: {dt}")
    # MetaImage DimSize is fastest-varying first
    dims = " ".join(str(d) for d in reversed(data.shape))
    with open(base + ".mhd", "w") as f:
        f.write("ObjectType = Image\n")
        f.write(f"NDims = {data.ndim}\n")
        f.write(f"DimSize = {dims}\n")
        f.write(f"ElementType = {_RTYPES[dt]}\n")
        f.write("BinaryData = True\n")
        f.write("BinaryDataByteOrderMSB = False\n")
        f.write(f"ElementDataFile = {raw_name}\n")
    data.tofile(base + ".raw")


def mhd_read(path: str) -> np.ndarray:
    """Read a .mhd file back into a numpy array (libxsmm_mhd_read)."""
    header = {}
    with open(path) as f:
        for line in f:
            if "=" in line:
                k, v = line.split("=", 1)
                header[k.strip()] = v.strip()
    ndims = int(header["NDims"])
    dims = [int(x) for x in header["DimSize"].split()][:ndims]
    dtype = _TYPES[header["ElementType"]]
    if header.get("BinaryDataByteOrderMSB", "False") == "True":
        dtype = np.dtype(dtype).newbyteorder(">")
    raw = header["ElementDataFile"]
    raw_path = os.path.join(os.path.dirname(os.path.abspath(path)), raw)
    data = np.fromfile(raw_path, dtype=dtype)
    return data.reshape(tuple(reversed(dims)))


def mhd_compare(path_a: str, path_b: str, tol: float = 1e-3):
    """Element compare of two images (mhd element comparison analog)."""
    from .matdiff import matdiff
    a, b = mhd_read(path_a), mhd_read(path_b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    info = matdiff(a.reshape(a.shape[0], -1).astype(np.float64),
                   b.reshape(b.shape[0], -1).astype(np.float64))
    return info.ok(tol), info
