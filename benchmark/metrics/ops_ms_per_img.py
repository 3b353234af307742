"""Device ms of the kernels launched inside the op layer, per image."""


def read(ctx):
    ns = ctx.op_layer()["op_ns"]
    return ns / 1e6 / ctx.shaped_images if ns else None
