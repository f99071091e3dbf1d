"""CUDA kernels, packed LU cells: the upper variant's share of its
roofline, in %: the least time of a call's ``applies_per_call`` backward
solves on the packed factors (``roofline_lu.py``) over the device time a
call of the upper trsm kernels (``trsm_shared_upper``, ``trsm_reg_upper``)
in the capture of the card's activity alone; ``bound`` names the bound.
Nothing to read where the program has no upper variant."""

from .. import roofline_lu


def read(ctx):
    return roofline_lu.share(ctx, "trsm_upper")
