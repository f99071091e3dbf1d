"""From the start of the process to the first timed step: imports, the
CUDA context, builds or cached loads, inputs and operator, and the
warm-up of the cell's own shapes, in s."""


def read(ctx):
    return ctx.setup_s
