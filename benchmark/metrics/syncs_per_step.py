"""Synchronizing runtime calls and copies without ``Async`` (``spans.py``)
that start inside a root span of the program, a step (or forward), in the
window with the program's spans: one for each blocking copy of PyTorch's."""


def read(ctx):
    st = getattr(ctx, "spans", None)
    if st is None or not st.device:
        return None
    return st.per_root(float(sum(c.sync and c.span is not None for c in st.calls)))
