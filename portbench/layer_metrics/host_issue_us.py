"""Frontends + kernel wrappers: the mean host time from a call's entry to
its return (no synchronize) over the measured window, in us; the
benchmark's own span around each call."""


def read(ctx):
    if not ctx.issue_ns:
        return None
    return sum(ctx.issue_ns) / len(ctx.issue_ns) / 1e3
