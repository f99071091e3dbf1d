"""Kernel wrappers: the self time of the ``wrapper`` spans of a call of
the entry point (checks, route or staging, output allocation, the launch
counts), in us, over the span pass; the program's own spans."""

from .. import program_spans


def read(ctx):
    p = program_spans.of(ctx)
    if p is None or not p.per_call["calls"] or not p.per_call["wrapper"]:
        return None
    return p.per_call["wrapper"] / p.per_call["calls"] / 1e3
