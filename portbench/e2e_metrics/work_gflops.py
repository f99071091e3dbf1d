"""Useful operations of every call completed in the window, over the
window's whole time, in GFLOP/s (operations counted from shapes by
``roofline.py``)."""


def read(ctx):
    return ctx.calls * ctx.ops_per_call / (ctx.window_ns * 1e-9) / 1e9
