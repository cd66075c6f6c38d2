"""device_idle_share (%): the share of the traced window in which no
kernel, copy or fill ran on the card (the trace without Python stacks)."""


def read(ctx):
    seg = ctx.a
    if not seg.ops or seg.window_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s / seg.window_s)
