"""The collectives of the EP exchanges, with their transposes.

rectpu differentiates through ``shard_map``, so JAX derives each
collective's transpose. Here every differentiated collective is a
``torch.autograd.Function`` over one mesh axis (``parallel/mesh.Axis``),
named after the ``lax`` call it replaces, with the transpose JAX uses:

  - ``all_gather`` (tiled, along dim 0): transposes to ``psum_scatter``
    (JAX's ``_all_gather_transpose_rule``);
  - ``psum_scatter`` (tiled, along dim 0): transposes to ``all_gather``;
  - ``all_to_all`` (split = concat = 0): its own transpose (device i's block
    j lands on device j's block i, and back);
  - ``psum`` of a value that varies over the axis into one that does not:
    its transpose is ``pvary``, the identity on each rank. Every rank of the
    axis then holds the whole cotangent, because the ranks of the axis
    compute the same function of the same summed value (rectpu's ``1d``
    exchange, whose towers are replicated over 'model');
  - ``pvary`` (Megatron's *f*): the identity on a value that every rank of
    the axis holds, whose transpose is ``psum``: each rank's cotangent is
    the share of the ranks' computations it fed, and their sum is the
    whole. With ``psum`` (Megatron's *g*) it brackets the tensor-parallel
    towers (``models/base.apply_mlp``).

The towers under tensor parallelism also convert between layouts. A value
that every rank of 'model' holds alike has its whole cotangent on every
rank, so:

  - ``local_columns`` (this rank's block of the last dim) transposes to the
    zero-padded cotangent summed over the axis;
  - ``gather_columns`` (``all_gather`` of the ranks' column blocks along the
    last dim, into a value every rank holds) transposes to this rank's
    columns of the whole cotangent;
  - ``own_rows`` (this rank's block of dim 0 of a value that every rank
    holds) transposes to ``all_gather`` of the row cotangents: every rank
    then holds the cotangent of every row, as the towers' weight gradients
    need;
  - ``gather_rows`` (``all_gather`` of the ranks' rows into a value that
    every rank then holds) transposes to this rank's rows of the whole
    cotangent. ``all_gather`` itself (transpose ``psum_scatter``) takes its
    place where the cotangents that reach it are the ranks' shares.

The CPU tests hold each against rectpu's gradients. ``raw_*`` are the same
collectives outside autograd (ids, metrics, gradient reductions). A failed
collective raises.

Every collective of a step goes through ``raw_*``, and each of them through
``collective``: it allocates the output and hands (op, input, output, axis)
to ``launch``, or, while a step is captured or recorded
(``train/dispatch.py``; ``set_controller``), to the controller's
``collective``, which returns the output the step goes on with. A CUDA graph
cannot hold a collective that copies through host memory (Gloo), so the
capture controller cuts the step's graph at each collective and runs the
collective eagerly between the segments' replays, on the buffers it
recorded.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from rectpu_torch.parallel.mesh import Axis

OPS = ("all_gather", "psum_scatter", "all_to_all", "psum")
_controller = None  # see set_controller


def set_controller(controller) -> None:
    """Route every collective to ``controller.collective(op, x, out, axis)``
    (None: run each as it comes, ``launch``). The controller is one for the
    process, not for a thread: a step's backward runs its collectives on the
    autograd engine's device thread."""
    global _controller
    _controller = controller


def launch(op: str, x: torch.Tensor, out: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Run collective ``op`` of ``x`` into ``out`` (``collective``'s
    shapes) over ``axis`` now; returns ``out``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # the _tensor names' deprecation
        if op == "all_gather":
            dist.all_gather_into_tensor(out, x, group=axis.group)
        elif op == "psum_scatter":
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=axis.group)
        elif op == "all_to_all":
            dist.all_to_all_single(out, x, group=axis.group)
        elif op == "psum":
            out.copy_(x)
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
        else:
            raise ValueError(f"unknown collective {op!r}")
    return out


def collective(op: str, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Collective ``op`` (one of OPS) of a contiguous ``x`` over ``axis``
    (of more than one rank) into a new tensor: ``all_gather`` along dim 0
    (axis.size times the rows), ``psum_scatter`` (a 1/axis.size block of
    dim 0), ``all_to_all`` and ``psum`` (x's shape)."""
    n = axis.size
    if op in ("psum_scatter", "all_to_all") and x.shape[0] % n:
        raise ValueError(f"{op}: dim 0 ({x.shape[0]}) is not divisible by the "
                         f"{axis.name} axis ({n})")
    if op == "all_gather":
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    elif op == "psum_scatter":
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    else:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if _controller is not None:
        return _controller.collective(op, x, out, axis)
    return launch(op, x, out, axis)


def raw_all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0, in axis order."""
    if axis.size == 1:
        return x
    return collective("all_gather", x.contiguous(), axis)


def raw_psum_scatter(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over the axis and keep this rank's block of dim 0."""
    if axis.size == 1:
        return x
    return collective("psum_scatter", x.contiguous(), axis)


def raw_all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Block j of dim 0 goes to rank j; block i of the result came from rank i."""
    if axis.size == 1:
        return x
    return collective("all_to_all", x.contiguous(), axis)


def raw_psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over the axis (a new tensor; ``x`` is left as it is)."""
    if axis.size == 1:
        return x
    return collective("psum", x, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return raw_all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return raw_psum_scatter(g.contiguous(), ctx.axis), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return raw_psum_scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        return raw_all_gather(g.contiguous(), ctx.axis), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return raw_all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return raw_all_to_all(g.contiguous(), ctx.axis), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return raw_psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return raw_psum(g, ctx.axis), None


class _LocalColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.meta = (axis, x.shape[-1])
        w = x.shape[-1] // axis.size
        return x[..., axis.index * w:(axis.index + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        axis, width = ctx.meta
        full = g.new_zeros((*g.shape[:-1], width))
        w = width // axis.size
        full[..., axis.index * w:(axis.index + 1) * w] = g
        return raw_psum(full, axis), None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        full = raw_all_gather(x.movedim(-1, 0).contiguous(), axis)
        return full.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        w = g.shape[-1] // ctx.axis.size
        return g[..., ctx.axis.index * w:(ctx.axis.index + 1) * w].contiguous(), None


class _OwnRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        n = x.shape[0] // axis.size
        return x[axis.index * n:(axis.index + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return raw_all_gather(g.contiguous(), ctx.axis), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return raw_all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // ctx.axis.size
        return g[ctx.axis.index * n:(ctx.axis.index + 1) * n].contiguous(), None


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=0, tiled=True)``, differentiable."""
    return _AllGather.apply(x, axis)


def psum_scatter(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``, differentiable."""
    return _PsumScatter.apply(x, axis)


def all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0)``, differentiable."""
    return _AllToAll.apply(x, axis)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.psum(x, axis)`` of a value that varies over the axis, differentiable."""
    return _Psum.apply(x, axis)


def pvary(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The identity on a value every rank of the axis holds; its transpose
    sums the ranks' cotangents (JAX's ``pvary``, Megatron's *f*)."""
    return _Pvary.apply(x, axis) if axis.size > 1 else x


def local_columns(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's block of the last dim of a value every rank holds."""
    return _LocalColumns.apply(x, axis) if axis.size > 1 else x


def gather_columns(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's block of the last dim, concatenated in axis order, into a
    value every rank holds."""
    return _GatherColumns.apply(x, axis) if axis.size > 1 else x


def own_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's block of dim 0 of a value every rank holds; the transpose
    all_gathers the row cotangents."""
    return _OwnRows.apply(x, axis) if axis.size > 1 else x


def gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's rows, concatenated in axis order, into a value every rank
    holds; the transpose keeps this rank's rows of the whole cotangent."""
    return _GatherRows.apply(x, axis) if axis.size > 1 else x
