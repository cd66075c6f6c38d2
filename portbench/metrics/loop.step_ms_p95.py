"""loop.step_ms_p95 (ms): the 95th percentile of the intervals between
the starts of consecutive steps' gathers (each step launches one, first of
its model's kernels) in the traced window."""

import re
import statistics


def _gather(op):
    return op.cat == "kernel" and re.search(r"\blookup_\w*kernel", op.name) \
        and not op.under("LookupBackward")


def read(ctx):
    starts = sorted(op.ts for op in ctx.a.picked(_gather))
    gaps = [(b - a) * 1e-3 for a, b in zip(starts, starts[1:])]
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=100)[94]
