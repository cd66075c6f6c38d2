"""collective_ms_per_step (ms): the device time of the NCCL kernels a step
(their union), read on every rank; the slowest rank's."""

SLOWEST_RANK = True


def _nccl(op):
    return op.cat == "kernel" and "nccl" in op.name.lower()


def read(ctx):
    if not ctx.a.picked(_nccl):
        return None
    return 1e3 * ctx.a.per_step_s(_nccl)
