"""Frontends on the card: the device time of operations that are not the
port's own CUDA kernels (the torch ops that pack, unpack, split, copy),
over all device time of the traced window, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.port_ns + t.other_ns == 0:
        return None
    return 100.0 * t.other_ns / (t.port_ns + t.other_ns)
