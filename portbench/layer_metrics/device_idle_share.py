"""Device: the share of the measured window in which no operation ran on
the card, in %: one minus the card's busy time a step, from the capture of
its activity alone, over the measured window's time a step.  The traced
window's own share (``device.busy_s`` / ``device.window_s``) reads higher
wherever the profiler slows the host's issue: its per-launch cost
lengthens the traced steps, while the card's busy time a step stays."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_ns == 0 or not ctx.trace_steps \
            or not ctx.step_ns:
        return None
    busy_per_step = t.busy_ns / ctx.trace_steps
    step = ctx.window_ns / len(ctx.step_ns)
    return 100.0 * (1.0 - busy_per_step / step)
