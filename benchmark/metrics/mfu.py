"""Model FLOPs of the window's images (the entry's count an image: the
analytic counts of ``flops.py`` times the passes of a step, 3 for a forward
and its backward) over the window's time, as a share of the card's bf16 peak
(989 TFLOP/s)."""

from benchmark import work


def read(ctx):
    return 100.0 * ctx.flops_per_image * ctx.window.rate(ctx.images_per_step) / work.PEAK_TC
