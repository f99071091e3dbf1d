"""Sparse create: the host time of the set-up's ``create_dcsr_reg``, which
creates the operator's handle on the card, through a synchronize, in ms;
the benchmark's own span."""


def read(ctx):
    spans = ctx.spans.get("create_ns")
    if not spans:
        return None
    return spans[0] / 1e6
