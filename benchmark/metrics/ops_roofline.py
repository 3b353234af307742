"""The op layer's share of its roofline: the least time the card could take
for the work of every op-layer call in the traced window (``ops/*.json`` at
each call's shape as the profiler recorded it, ``work.py``'s peaks) over the
device time of the kernels those calls launched, forward and backward."""

from benchmark import work


def read(ctx):
    layer = ctx.op_layer()
    if not layer["calls"] or not layer["op_ns"]:
        return None
    if any(b is None for _, _, b, _ in layer["calls"]):
        return None
    bound = sum(count * work.bound_s(*work.work(ctx.ops[op], direction, ctx.shape_env(b, n)))
                for (op, direction, b, n), count in layer["calls"].items())
    return 100.0 * bound / (layer["op_ns"] / 1e9)
