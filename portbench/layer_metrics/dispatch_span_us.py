"""Dispatch + registry: the program's ``dispatch`` spans (the typed
dispatcher's memo probe, and ``mmdispatch`` on a miss) a step, in us: the
summed lengths of the span pass's ``dispatch`` spans over its steps; the
program's own span.  ``lookup_us`` is the same pass's mean lookup a step
on the benchmark's clock (``dispatch_hit_us`` with recording on): what it
holds beyond ``dispatch`` lies in the loop around the call."""

from .. import program_spans


def read(ctx):
    p = program_spans.of(ctx)
    if p is None or not p.dispatch_ns or not p.steps:
        return None
    out = {"value": sum(p.dispatch_ns) / p.steps / 1e3}
    if p.lookup_ns:
        out["lookup_us"] = sum(p.lookup_ns) / len(p.lookup_ns) / 1e3
    return out
