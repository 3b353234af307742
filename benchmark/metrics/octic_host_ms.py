"""Host ms a forward inside the program's ``vit.octic_blocks`` spans (the
octic blocks of the trunk, packing included), in the window with the
program's spans."""

from benchmark import spans


def read(ctx):
    st = getattr(ctx, "spans", None)
    return None if st is None else spans.host_ms(st, lambda name: name == "vit.octic_blocks")
