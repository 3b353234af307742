"""The share of the untraced window in which no device work ran: one less the
device's busy seconds an image, from the traced window of the device's
activity alone, times the untraced window's images a second. Tracing stretches
the host's dispatch (the profiler's hook on every launch), so the traced
window's own idle share reads the profiler's cost too; the device's time an
image it does not change."""


def read(ctx):
    if not ctx.trace.device or not ctx.window.steps:
        return None
    busy_per_image = ctx.trace.busy_s() / ctx.trace_images
    return 100.0 * (1.0 - busy_per_image * ctx.window.rate(ctx.images_per_step))
