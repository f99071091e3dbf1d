"""Device: of the card's idle time in the span capture (the card's
activity alone, with the program's spans recorded), the share during which
the innermost span open on the host at the gap's middle was one of the
program's, in %; ``by_span`` splits the idle time, in %, by that span's
name, and ``caller`` where none of the program's spans was open (the
benchmark's loop, its synchronize)."""

from .. import program_spans


def read(ctx):
    p = program_spans.of(ctx)
    idle = None if p is None else p.idle_by_span
    total = sum(idle.values()) if idle else 0
    if not total:
        return None
    caller = idle.get(program_spans.CALLER, 0)
    return {"value": 100.0 * (total - caller) / total,
            "by_span": {k: 100.0 * v / total for k, v in
                        sorted(idle.items(), key=lambda kv: -kv[1])}}
