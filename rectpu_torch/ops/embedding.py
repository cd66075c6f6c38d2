"""Embedding lookup: the port of ``rectpu/ops/embedding.py``'s forward.

rectpu has five lookup implementations (``embedding_impl``: "auto", "take",
"onehot", "pallas", "split"), chosen for the TPU's hardware; all of them
compute the same function, ``out[..., :] = table[ids[...], :]``. In the port
every one of them is this module's ``lookup``:

  - on CUDA tensors, the hand-written gather kernel
    (``kernels/csrc/embedding_lookup.cu``, the port of the Pallas
    ``_fwd_kernel`` at ``rectpu/ops/embedding.py:70``);
  - on CPU tensors, its plain PyTorch version ``lookup_take``.

Ids outside ``[0, V)`` give a zero row in both, as the Pallas one-hot kernel
does. The backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from rectpu_torch.kernels import LaunchCount, build

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


def lookup(table: torch.Tensor, ids: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Rows of ``table`` [V, W] at ``ids`` [...] -> [..., W].

    ``impl`` is the export's recorded ``embedding_impl``; every value runs the
    same function. CPU tensors take the plain version, CUDA tensors the
    kernel (which raises on what it does not take)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown embedding_impl {impl!r} (expected one of {IMPLS})")
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return lookup_take(table, ids)
    return lookup_cuda(table, ids)
