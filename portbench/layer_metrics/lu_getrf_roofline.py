"""CUDA kernels, packed LU cells: kernel 12's share of its roofline, in %:
getrf's least time a call (``roofline_lu.py``: the larger of its bytes over
HBM bytes/s and its operations over f32 operations/s) over the device time
a call of the getrf kernels in the capture of the card's activity alone;
``bound`` names the bound."""

from .. import roofline_lu


def read(ctx):
    return roofline_lu.share(ctx, "getrf")
