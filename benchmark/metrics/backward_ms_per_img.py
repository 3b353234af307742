"""Device ms an image of the kernels launched while a ``*.backward`` span of
the program was open (``deit.backward``, ``ssl.backward``; the backward's
ops run on autograd's thread inside it), in the window with the program's
spans."""

from benchmark import spans


def read(ctx):
    st = getattr(ctx, "spans", None)
    return None if st is None else spans.device_ms_per_img(st, ".backward")
