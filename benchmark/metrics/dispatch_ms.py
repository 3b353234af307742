"""The median host time, in the untraced window, from calling the program's
step (or forward) to its return."""

import statistics


def read(ctx):
    return statistics.median(ctx.window.dispatch_s) * 1e3 if ctx.window.dispatch_s else None
