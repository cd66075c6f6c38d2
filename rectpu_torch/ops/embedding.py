"""Embedding lookup: the port of ``rectpu/ops/embedding.py``.

rectpu has five lookup implementations (``embedding_impl``: "auto", "take",
"onehot", "pallas", "split") and the lane-packed ``lookup_flat``, chosen for
the TPU's hardware; all of them compute the same function,
``out[..., :] = table[ids[...], :]``, and its transpose, the dense table
cotangent. In the port every one of them is this module's ``lookup``, a
``torch.autograd.Function``:

  - forward: on CUDA tensors the hand-written gather kernel
    (``kernels/csrc/embedding_lookup.cu``, the port of the Pallas
    ``_fwd_kernel`` at ``rectpu/ops/embedding.py:70``), on CPU tensors its
    plain version ``lookup_take``;
  - backward: ``ops.scatter_rows.scatter_rows_dense`` into a dense [V, W]
    cotangent with fp32 collision sums (the kernel that ports ``_bwd_kernel``,
    :81, and the scatter of ``lookup_flat``'s mxu backward), cast to
    ``grad_dtype`` and then to the table's dtype: the contract of
    ``lookup_split`` and ``lookup_flat`` (:366, :681).

``gather_dtype`` casts the table before the gather, as ``lookup_split`` and
``lookup_flat`` do (:267, :501); the cast's transpose is the final cast back
to the table's dtype. Ids outside ``[0, V)`` give a zero row and receive no
gradient, as the Pallas one-hot kernels do.
"""

from __future__ import annotations

import ctypes

import torch

from rectpu_torch.kernels import LaunchCount, build
from rectpu_torch.ops.scatter_rows import scatter_rows_dense

IMPLS = ("auto", "take", "onehot", "pallas", "split")

launches = LaunchCount("embedding_lookup")

_DTYPE_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_SIGNATURES = {
    "rectpu_lookup_rows": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def lookup_take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: table [V, W], ids [...] integer -> [..., W]; rows of
    out-of-range ids are zero."""
    v = table.shape[0]
    ids = ids.long()
    valid = (ids >= 0) & (ids < v)
    rows = table[ids.clamp(0, max(v - 1, 0))]
    return torch.where(valid.unsqueeze(-1), rows, torch.zeros((), dtype=table.dtype,
                                                              device=table.device))


def lookup_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch the gather kernel: table [V, W] fp32 or bf16, contiguous; ids
    [...] int32, contiguous, on the same card. Raises on anything else."""
    if not (table.is_cuda and ids.is_cuda and table.device == ids.device):
        raise ValueError(f"lookup_cuda needs table and ids on one CUDA device, got "
                         f"{table.device} and {ids.device}")
    if table.dim() != 2 or table.dtype not in _DTYPE_BYTES:
        raise ValueError(f"table must be 2-D float32 or bfloat16, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("lookup_cuda needs contiguous table and ids")
    v, w = table.shape
    if v >= 2**31 or w >= 2**31:
        raise ValueError(f"table {tuple(table.shape)} exceeds the kernel's int32 extents")
    out = torch.empty(*ids.shape, w, dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = build.load("embedding_lookup", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.rectpu_lookup_rows(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                                     ids.numel(), v, w, _DTYPE_BYTES[table.dtype], stream)
    if err != 0:
        raise RuntimeError(f"embedding_lookup kernel launch failed: cudaError {err}")
    launches.add()
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` outside autograd (zero rows for out-of-range ids): the
    plain version for CPU tensors, the gather kernel for CUDA tensors."""
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return lookup_take(table, ids)
    return lookup_cuda(table, ids)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, gather_dtype, grad_dtype):
        ctx.save_for_backward(ids)
        ctx.table_meta = (table.shape[0], table.dtype, grad_dtype)
        source = table.to(gather_dtype) if gather_dtype is not None else table
        return gather_rows(source.contiguous(), ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        v, table_dtype, grad_dtype = ctx.table_meta
        w = g.shape[-1]
        dtable = scatter_rows_dense(ids.reshape(-1), g.reshape(-1, w).contiguous(), v,
                                    out_dtype=grad_dtype or torch.float32)
        return dtable.to(table_dtype), None, None, None


def lookup(table: torch.Tensor, ids: torch.Tensor, impl: str = "auto",
           gather_dtype: torch.dtype | None = None,
           grad_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Rows of ``table`` [V, W] at ``ids`` [...] -> [..., W], differentiable
    in ``table``.

    ``impl`` is the recorded ``embedding_impl``; every value runs the same
    function. ``gather_dtype`` casts the table before the gather;
    ``grad_dtype`` is the dtype the dense cotangent is rounded to before the
    cast back to the table's dtype (None: fp32). CPU tensors take the plain
    versions, CUDA tensors the kernels (which raise on what they do not
    take)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown embedding_impl {impl!r} (expected one of {IMPLS})")
    return _Lookup.apply(table, ids, gather_dtype, grad_dtype)
