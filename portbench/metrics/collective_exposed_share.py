"""collective_exposed_share (%): the share of the traced window in which an
NCCL kernel runs with no other device operation beside it, read on every
rank; the slowest rank's."""

SLOWEST_RANK = True


def _nccl(op):
    return op.cat == "kernel" and "nccl" in op.name.lower()


def read(ctx):
    seg = ctx.a
    nccl = seg.union(seg.picked(_nccl))
    if not nccl or seg.window_s <= 0:
        return None
    other = seg.union(seg.picked(lambda op: not _nccl(op)))
    covered, j = 0.0, 0
    for a, b in nccl:
        while j < len(other) and other[j][1] <= a:
            j += 1
        k = j
        while k < len(other) and other[k][0] < b:
            covered += min(b, other[k][1]) - max(a, other[k][0])
            k += 1
    exposed = sum(b - a for a, b in nccl) - covered
    return 100.0 * exposed * 1e-6 / seg.window_s
