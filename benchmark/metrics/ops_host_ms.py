"""Host ms a forward inside the outermost ``op.<Function>.fwd`` spans of the
program: the hand-written ops' forwards (their checks, allocations and
launches), in the window with the program's spans."""

from benchmark import spans


def read(ctx):
    st = getattr(ctx, "spans", None)
    if st is None:
        return None
    return spans.host_ms(st, lambda name: name.startswith("op.") and name.endswith(".fwd"))
