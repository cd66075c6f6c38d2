"""roofline.table_grad (%): the table gradient's bound (row gradients and
ids read, one summed row a distinct id written) over the device time of
every operation the lookup's backward (``_LookupBackward``: the zero fill
and ``scatter_rows.cu``) launches a step."""

from portbench import counts


def _mine(op):
    return op.under("_LookupBackward")


def read(ctx):
    t = ctx.b.per_step_s(_mine)
    if t <= 0:
        return None
    nbytes = counts.table_grad_bytes(ctx.batch, ctx.fields, ctx.lookup_width, ctx.distinct)
    return 100.0 * counts.bound_s(nbytes=nbytes) / t
