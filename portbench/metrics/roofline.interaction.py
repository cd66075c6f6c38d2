"""roofline.interaction (%): the pairwise dots' bound over the device time
of what ``ops/interaction.py`` launches a step, forward and backward. The
bound of each pass is the larger of its bytes (the [B, n, K] vectors read,
the [B, P] dots written; backward: the dots' and the vectors' gradients
read, the vectors' gradient written) and its FLOPs (2 B P K forward, twice
that backward) at the peak of the configuration's precision."""

import re

from portbench import counts


def _mine(op):
    return (op.from_file("ops/interaction.py") or op.under("_InteractBackward")
            or re.search(r"\binteract_\w*kernel", op.name))


def read(ctx):
    t = ctx.b.per_step_s(_mine)
    if t <= 0:
        return None
    b, k = ctx.batch, ctx.conf["embedding_size"]
    n = ctx.fields + 1
    p = n * (n - 1) // 2
    vec, dots = b * n * k * counts.F32, b * p * counts.F32
    fwd = counts.bound_s(flops=2 * b * p * k, nbytes=vec + dots, conf=ctx.conf)
    bwd = counts.bound_s(flops=4 * b * p * k, nbytes=dots + 2 * vec, conf=ctx.conf)
    return 100.0 * (fwd + bwd) / t
