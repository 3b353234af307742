"""Host ms a step (or forward) inside the runtime calls that block the host
(``spans.py``: synchronizing calls, copies without ``Async`` or to or from
pageable memory) that start inside a root span of the program (``deit.step``,
``ssl.step``, ``vit.forward``), in the window with the program's spans. The
client's copy of the answer to the host lies outside the root."""


def read(ctx):
    st = getattr(ctx, "spans", None)
    if st is None or not st.device:
        return None
    ns = sum(c.end - c.start for c in st.calls if c.blocking and c.span is not None)
    return st.per_root(ns / 1e6)
