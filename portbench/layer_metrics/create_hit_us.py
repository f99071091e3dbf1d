"""Sparse create: the mean host time of a ``create_dcsr_reg`` call that
the registry answers from its cache (the operator's digest and the
descriptor's lookup), timed over the set-up's calls after the create, in
us; the benchmark's own span."""


def read(ctx):
    spans = ctx.spans.get("create_hit_ns")
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3
