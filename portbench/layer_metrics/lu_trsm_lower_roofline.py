"""CUDA kernels, packed LU cells: the lower (unit L) solves' share of their
roofline, in %: the least time of a call's ``applies_per_call`` forward
solves (``roofline_lu.py``) over the device time a call of the lower trsm
kernels in the capture of the card's activity alone; ``bound`` names the
bound."""

from .. import roofline_lu


def read(ctx):
    return roofline_lu.share(ctx, "trsm_lower")
