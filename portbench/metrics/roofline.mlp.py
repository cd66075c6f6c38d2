"""roofline.mlp (%): the towers' GEMM FLOPs, forward and backward
(``flops_per_example``'s ``mlp``), at the peak of the configuration's
precision, over the device time of the cuBLAS GEMMs that
``models/base.py``'s towers launch, forward and backward, a step."""

from portbench import counts

_GEMM = ("gemm", "gemv", "xmma", "cutlass", "splitk")


def _mine(op):
    low = op.name.lower()
    return op.cat == "kernel" and any(g in low for g in _GEMM) and op.from_file("models/base.py")


def read(ctx):
    t = ctx.b.per_step_s(_mine)
    if t <= 0:
        return None
    flops = ctx.ref.flops_per_example(ctx.conf)["mlp"] * ctx.batch
    return 100.0 * counts.bound_s(flops=flops, conf=ctx.conf) / t
