"""Device ms an image of the kernels launched inside a ``*.update`` span of
the program (``deit.update``: clip, LAMB, EMA; ``ssl.update``: clip, AdamW,
the teacher's EMA), in the window with the program's spans."""

from benchmark import spans


def read(ctx):
    st = getattr(ctx, "spans", None)
    return None if st is None else spans.device_ms_per_img(st, ".update")
