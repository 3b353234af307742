"""``torch.cuda.max_memory_allocated`` over the run up to the traced window's end."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
