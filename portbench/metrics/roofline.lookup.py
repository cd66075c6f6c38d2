"""roofline.lookup (%): the gather's bound (ids read, each distinct row
read once, rows written, at the memory peak) over the device time of every
gather a step (``embedding_lookup.cu``'s ``lookup_*`` kernels)."""

import re

from portbench import counts


def _gather(op):
    return op.cat == "kernel" and re.search(r"\blookup_\w*kernel", op.name) \
        and not op.under("LookupBackward")


def read(ctx):
    t = ctx.b.per_step_s(_gather)
    if t <= 0:
        return None
    nbytes = counts.lookup_bytes(ctx.batch, ctx.fields, ctx.lookup_width, ctx.distinct)
    return 100.0 * counts.bound_s(nbytes=nbytes) / t
