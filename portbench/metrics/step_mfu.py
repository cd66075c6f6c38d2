"""step_mfu (%): the model FLOPs of an example (forward and backward of
the towers, interaction or CIN, counted from the configuration's shapes by
the family's reference) times the window's examples a second, over the
peak of the configuration's precision (``counts.peak_flops``)."""

from portbench import counts


def read(ctx):
    if not ctx.rate:
        return None
    flops = sum(ctx.ref.flops_per_example(ctx.conf).values())
    return 100.0 * flops * ctx.rate / (counts.peak_flops(ctx.conf) * ctx.chips)
