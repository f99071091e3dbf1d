"""CUDA kernels: the share of its roofline that the port's kernel reaches,
in %: the least time the card could take for one call (max of the call's
bytes over HBM bytes/s and its operations over f32 operations/s, counted
by ``roofline.py``) over the port's kernels' device time a call in the
traced window.  ``bound`` says which of the two it is."""

from .. import roofline


def read(ctx):
    t = ctx.trace
    if t is None or t.port_ns == 0 or not ctx.trace_calls or not ctx.peaks:
        return None
    bound, which = roofline.bound_s(ctx.ops_per_call, ctx.bytes_per_call,
                                    ctx.peaks)
    per_call = t.port_ns * 1e-9 / ctx.trace_calls
    return {"value": 100.0 * bound / per_call, "bound": which}
