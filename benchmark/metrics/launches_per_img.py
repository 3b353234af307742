"""Kernels launched in the traced window, per image (a count)."""


def read(ctx):
    kernels = ctx.trace.kernels()
    return len(kernels) / ctx.trace_images if kernels else None
