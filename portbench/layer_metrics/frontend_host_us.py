"""Frontends: the self time of a call's ``frontend`` spans (the entry
point's own Python: operand checks, ``as_tensor``, packing, the
schedule's choice), summed, a call of the entry point, in us, over the
span pass; ``issue_us`` is the same pass's mean host time from a call's
entry to its return on the benchmark's clock (``host_issue_us`` with
recording on).  The program's own spans."""

from .. import program_spans


def read(ctx):
    p = program_spans.of(ctx)
    if p is None or not p.per_call["calls"]:
        return None
    calls = p.per_call["calls"]
    out = {"value": p.per_call["frontend"] / calls / 1e3}
    if p.issue_ns:
        out["issue_us"] = sum(p.issue_ns) / len(p.issue_ns) / 1e3
    return out
