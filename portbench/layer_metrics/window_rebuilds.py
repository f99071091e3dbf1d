"""Dispatch + registry: what the program built while the span passes ran
(``program_spans``: a second loop of the cell, on the shapes that set-up
warmed up and the measured window ran): its build counters
(``trace.build_counts()``: CUDA libraries compiled and loaded, sparse
routes picked, registry builds, CUDA graphs captured) after the loop's
last step less before its first, summed; ``by_counter`` gives each.  The
program's own counters."""

from .. import program_spans


def read(ctx):
    p = program_spans.of(ctx)
    before, after = (None, None) if p is None else p.builds
    if before is None or after is None:
        return None
    moved = {k: after[k] - before.get(k, 0) for k in after}
    return {"value": sum(moved.values()), "by_counter": moved}
