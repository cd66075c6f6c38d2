"""roofline.optimizer (%): the update's bound by the optimizer's semantics
(``counts.optimizer_bytes``: SGD the touched rows, dense Adam every element
of p, m and v) over the device time of every operation launched from
``train/optimizers.py`` or ``ops/fused_adam.py`` a step."""

from portbench import counts


def _mine(op):
    return op.from_file("train/optimizers.py") or op.from_file("ops/fused_adam.py")


def read(ctx):
    t = ctx.b.per_step_s(_mine)
    if t <= 0:
        return None
    nbytes = counts.optimizer_bytes(ctx.optimizer, ctx.leaves, ctx.ref.TABLE_LEAVES,
                                    ctx.distinct)
    return 100.0 * counts.bound_s(nbytes=nbytes) / t
