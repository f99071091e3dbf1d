"""Dispatch + registry: the mean host time of a step's kernel lookup (the
``dmmdispatch``/``smmdispatch`` memo hit) over the measured window, in us;
the benchmark's own span."""


def read(ctx):
    if not ctx.lookup_ns:
        return None
    return sum(ctx.lookup_ns) / len(ctx.lookup_ns) / 1e3
