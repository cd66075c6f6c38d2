"""In-place row SET into a slab: the port of ``rectpu/ops/scatter_dma.py``.

    scatter_rows_dma(slab, rows, vals) == slab.at[rows].set(vals, mode="drop")

for sorted ``rows`` that are unique among the valid ones; rows at or past
``v_valid`` (the sentinels of ``dedupe_rows``) are dropped. It is a set, not
an add, so the result is bit for bit the source rows, as rectpu's tests
assert (``tests/test_scatter_dma.py``). The sparse fast step writes its
lazy-Adam rows of the table and of the m|v slab through it
(``scatter_backend="dma"``, ``train/sparse.py``).

  - On CUDA tensors: the hand-written kernel ``kernels/csrc/scatter_dma.cu``
    (the port of ``_rmw_kernel``, ``rectpu/ops/scatter_dma.py:49``), one warp
    per row, which writes the slab IN PLACE and returns it (rectpu aliases its
    output to the slab, ``input_output_aliases={2: 0}``).
  - On CPU tensors: the plain version ``scatter_rows_dma_plain``, a masked
    ``index_copy_``, also in place.

rectpu's 8-row windows, 16-row val tiles, per-window SMEM table
(``plan_windows``), pad-row sentinel windows and 24k-window chunking are TPU
layout devices and are not carried over. Its checks a caller sees are kept:
a slab whose row count is a multiple of 8 (a ``ValueError`` here), at least 8
pad rows past ``v_valid`` and ``vals`` of shape ``[n, C]``.
``set_rows`` is the same function without the pad-row rule (any ``v_valid``
up to the slab's row count): the port's ``.at[].set(mode="drop")``.
"""

from __future__ import annotations

import ctypes

import torch

from rectpu_torch.kernels import LaunchCount, build

WROWS = 8  # pad rows rectpu needs past v_valid for its sentinel windows

launches = LaunchCount("scatter_rows_dma")

_SIGNATURES = {
    "rectpu_set_rows": (
        [ctypes.c_void_p] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_DTYPES = (torch.float32, torch.bfloat16)


def _check(slab: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, v_valid: int) -> None:
    if slab.dim() != 2:
        raise ValueError(f"slab must be [V, C], got {tuple(slab.shape)}")
    if rows.dim() != 1:
        raise ValueError(f"rows must be 1-D, got {tuple(rows.shape)}")
    if tuple(vals.shape) != (rows.shape[0], slab.shape[1]):
        raise ValueError(f"vals {tuple(vals.shape)} for {rows.shape[0]} rows of a "
                         f"{tuple(slab.shape)} slab")
    if vals.dtype != slab.dtype:
        raise ValueError(f"vals {vals.dtype} into a {slab.dtype} slab")
    if not 0 <= v_valid <= slab.shape[0]:
        raise ValueError(f"v_valid={v_valid} outside [0, {slab.shape[0]}]")


def scatter_rows_dma_plain(slab: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, *,
                           v_valid: int) -> torch.Tensor:
    """Plain version: ``slab[rows[i]] = vals[i]`` for ``0 <= rows[i] < v_valid``,
    in place; returns the slab."""
    _check(slab, rows, vals, v_valid)
    rows = rows.long()
    keep = (rows >= 0) & (rows < v_valid)
    slab.index_copy_(0, rows[keep], vals[keep])
    return slab


def scatter_rows_dma_cuda(slab: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, *,
                          v_valid: int) -> torch.Tensor:
    """Launch the row-set kernel: slab [V, C] and vals [n, C] fp32 or bf16,
    rows [n] int32, all contiguous on one card; writes the slab in place and
    returns it. Raises on anything the kernel does not take."""
    if not (slab.is_cuda and rows.is_cuda and vals.is_cuda
            and slab.device == rows.device == vals.device):
        raise ValueError(f"scatter_rows_dma_cuda needs slab, rows and vals on one CUDA "
                         f"device, got {slab.device}, {rows.device}, {vals.device}")
    _check(slab, rows, vals, v_valid)
    if slab.dtype not in _DTYPES:
        raise ValueError(f"slab must be float32 or bfloat16, got {slab.dtype}")
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32, got {rows.dtype}")
    if not (slab.is_contiguous() and rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_rows_dma_cuda needs a contiguous slab, rows and vals")
    if slab.shape[0] >= 2**31:
        raise ValueError(f"slab {tuple(slab.shape)} exceeds the kernel's int32 row ids")
    n = rows.shape[0]
    lib = build.load("scatter_dma", _SIGNATURES)
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream(slab.device).cuda_stream
        err = lib.rectpu_set_rows(rows.data_ptr(), vals.data_ptr(), slab.data_ptr(), n,
                                  v_valid, slab.shape[1] * slab.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows_dma kernel launch failed: cudaError {err}")
    launches.add()
    return slab


def set_rows(slab: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
             v_valid: int) -> torch.Tensor:
    """``slab[rows[i]] = vals[i]`` in place for ``0 <= rows[i] < v_valid``
    (valid rows unique); returns the slab. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if slab.device.type == "cpu" and rows.device.type == "cpu" and vals.device.type == "cpu":
        return scatter_rows_dma_plain(slab, rows, vals, v_valid=v_valid)
    return scatter_rows_dma_cuda(slab, rows, vals, v_valid=v_valid)


def scatter_rows_dma(slab: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, *,
                     v_valid: int | None = None) -> torch.Tensor:
    """``slab.at[rows].set(vals)`` in place for sorted rows unique below
    ``v_valid`` (default ``Vp - 256``); rows at or past it are dropped. The
    slab's rows must be a multiple of 8 and at least 8 of them must lie past
    ``v_valid``, as rectpu asserts."""
    if slab.shape[0] % WROWS:
        raise ValueError(f"the slab's row count must be a multiple of {WROWS}, got "
                         f"{tuple(slab.shape)}")
    n = rows.shape[0]
    if v_valid is None:
        v_valid = slab.shape[0] - 256
    pad_rows = slab.shape[0] - v_valid
    # rectpu's asserts, raised so that they hold under ``python -O`` too
    if pad_rows < WROWS:
        raise AssertionError(f"need >= {WROWS} pad rows past v_valid={v_valid} for "
                             f"sentinel windows, slab has {pad_rows}")
    if tuple(vals.shape) != (n, slab.shape[1]):
        raise AssertionError(f"vals {tuple(vals.shape)} for {n} rows of width {slab.shape[1]}")
    return set_rows(slab, rows, vals, v_valid)
