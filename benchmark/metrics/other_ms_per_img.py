"""Device ms of every kernel outside the op layer (plain PyTorch), per image."""


def read(ctx):
    ns = ctx.op_layer()["other_ns"]
    return ns / 1e6 / ctx.shaped_images if ns else None
