"""Launch: the length of the ``launch`` spans of a call of the entry point
(``cuda_build.launch``: the stream's handle, the ctypes call to its return
code), in us, over the span pass; the program's own span.  Nothing to read
where no kernel was launched (the CPU's plain versions)."""

from .. import program_spans


def read(ctx):
    p = program_spans.of(ctx)
    if p is None or not p.per_call["calls"] or not p.per_call["launch"]:
        return None
    return p.per_call["launch"] / p.per_call["calls"] / 1e3
