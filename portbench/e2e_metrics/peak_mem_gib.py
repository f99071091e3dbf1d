"""``torch.cuda.max_memory_allocated()`` over the window (after
``reset_peak_memory_stats()`` at its start), in GiB."""


def read(ctx):
    if ctx.window_peak_bytes is None:
        return None
    return ctx.window_peak_bytes / 2 ** 30
