"""loop.aten_ops_per_step (ops): the host's aten operations in the traced
window, on every thread, over its train steps (the loop's dispatch cost)."""


def read(ctx):
    seg = ctx.a
    return seg.aten_ops / seg.steps if seg.steps and seg.aten_ops else None
