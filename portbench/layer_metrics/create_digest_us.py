"""Sparse create: the mean length of the program's ``create.digest`` span
(the operator's ``Csr.structure_digest()``) over the last 32 creates of
the span passes' driver's set-up (``program_spans``), each answered by the
registry from its cache, in us; ``create_us`` is the mean length of those
creates' ``create`` spans.  The program's own spans."""

from .. import program_spans


def read(ctx):
    p = program_spans.of(ctx)
    if p is None or not p.creates or not p.creates[1]:
        return None
    creates, digests = p.creates
    return {"value": program_spans.mean_us(digests),
            "create_us": program_spans.mean_us(creates)}
