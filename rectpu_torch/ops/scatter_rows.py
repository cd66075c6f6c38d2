"""Dense row scatter-add: the port of ``rectpu/ops/scatter_rows.py``.

    scatter_rows_dense(ids, updates, v_rows) == zeros([v_rows, W]).index_add(ids, updates)

with every collision sum taken in fp32 and rounded once to ``out_dtype``. It
builds the dense table cotangent of every embedding backward in the port,
and so stands for three TPU kernels that compute this one function:
``_scatter_tile_kernel`` and ``_scatter_tile_kernel_resident``
(``rectpu/ops/scatter_rows.py:78``, ``:123``, the flat-layout backward with
``scatter_impl="mxu"``) and ``_bwd_kernel`` (``rectpu/ops/embedding.py:81``,
the backward of ``lookup_pallas``).

  - On CUDA tensors: the hand-written kernels of ``kernels/csrc/scatter_rows.cu``:
    a stable LSD radix sort of the ids (8-bit digits, ``sort_passes(v_rows)``
    passes; rectpu sorts outside its Pallas call too), then the sums of the
    sorted stream in pieces of ``chunk`` positions. It is deterministic: two
    launches give the same bits.
  - On CPU tensors: the plain version ``scatter_rows_plain``, an fp32
    ``index_add_``.

Ids outside ``[0, v_rows)`` contribute nothing: ``DROP_SENTINEL``, negative
ids, and ids past the table (the one-hot rule of ``_bwd_kernel``).

``segment_sum`` runs the same kernel on an already sorted stream whose ids
are segment ordinals: the compact ``[num_out, W]`` per-unique-row sums of
the sparse fast step's ``dedupe_rows`` (rectpu's ``jax.ops.segment_sum``,
``rectpu/train/sparse.py:104``), in a fixed order, so two launches give the
same bits (an fp32 ``index_add_`` on the card sums duplicates with atomics).

The piece length ``chunk`` (positions of the sorted stream a warp sums) is
the kernel's launch geometry (rectpu's tile geometry, ``_AUTO_TILE`` /
``set_auto_tile``, :65-75): ``scatter_rows_dense`` takes the pin
``_AUTO_CHUNK`` that the autotuner sets through ``set_auto_chunk``;
``segment_sum`` keeps ``CHUNK``. Each run of equal ids is summed in
position order within a piece, and a run that crosses piece edges adds its
pieces' fp32 partials in piece order. Another chunk groups the partials
differently, so the bits may differ between chunks, never between two
launches at one chunk.

One difference from rectpu: when a tile of its sorted stream holds more than
``capacity`` updates, rectpu's ``lax.cond`` fallback scatters with XLA and
accumulates in ``out_dtype`` (``scatter_rows.py:309-317``), so a bf16
cotangent then sums collisions in bf16. The port always accumulates in fp32,
the contract of rectpu's Pallas path, whatever the data.
"""

from __future__ import annotations

import ctypes

import torch

from rectpu_torch.kernels import LaunchCount, build

# out-of-range id that callers mask dropped rows to (rectpu's value)
DROP_SENTINEL = 2**31 // 2 - 1
# positions of the sorted stream a warp sums (a piece)
CHUNK = 32
# the radix sort: bits a pass and positions a tile (kRadixBits, kRadixTile)
RADIX_BITS = 8
RADIX_TILE = 4096
# the chunk scatter_rows_dense launches with (the autotuner's pick)
_AUTO_CHUNK = {"chunk": CHUNK}

launches = LaunchCount("scatter_rows")
segment_launches = LaunchCount("segment_sum")

_DTYPES = (torch.float32, torch.bfloat16)
_SIGNATURES = {
    "rectpu_scatter_rows": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "rectpu_segment_sum": (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def scatter_rows_plain(ids: torch.Tensor, updates: torch.Tensor, v_rows: int,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: ids [R] integer, updates [R, W] -> [v_rows, W] in
    ``out_dtype`` (default the updates' dtype), summed in fp32."""
    ids = ids.reshape(-1).long()
    keep = (ids >= 0) & (ids < v_rows)
    out = torch.zeros(v_rows, updates.shape[1], dtype=torch.float32, device=updates.device)
    out.index_add_(0, ids[keep], updates[keep].float())
    return out.to(out_dtype or updates.dtype)


def set_auto_chunk(chunk: int) -> None:
    """Pin the chunk length ``scatter_rows_dense`` launches with."""
    if int(chunk) < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    _AUTO_CHUNK["chunk"] = int(chunk)


def sort_passes(v_rows: int) -> int:
    """8-bit radix passes the sort needs for keys 0..v_rows (an id outside
    [0, v_rows) takes the key v_rows, which sorts last): 2 at ml-100k's 6,144
    rows, 3 at the flagship's 311,296. A function of the table's size only."""
    return max(1, -(-int(v_rows).bit_length() // RADIX_BITS))


def sort_state_words(n: int, v_rows: int) -> int:
    """int32 words of the sort's state: per pass 256 digit counts, a tile
    ticket and 256 look-back words a 4,096-position tile. A function of the
    stream's length and the table's size only."""
    passes = sort_passes(v_rows)
    return passes * (1 + 256 * (1 + -(-n // RADIX_TILE)))


def scatter_rows_cuda(ids: torch.Tensor, updates: torch.Tensor, v_rows: int,
                      out_dtype: torch.dtype | None = None,
                      chunk: int = CHUNK) -> torch.Tensor:
    """Sort the ids and sum the updates by the kernels of scatter_rows.cu:
    ids [R] int32, updates [R, W] fp32 or bf16, both contiguous on one card;
    ``out_dtype`` fp32 or bf16; ``chunk`` positions a warp sums. Raises on
    anything the kernels do not take."""
    if not (ids.is_cuda and updates.is_cuda and ids.device == updates.device):
        raise ValueError(f"scatter_rows_cuda needs ids and updates on one CUDA device, got "
                         f"{ids.device} and {updates.device}")
    out_dtype = out_dtype or updates.dtype
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be 1-D int32, got {tuple(ids.shape)} {ids.dtype}")
    if updates.dim() != 2 or updates.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"updates must be [R, W] float32 or bfloat16 and out_dtype one of "
                         f"those, got {tuple(updates.shape)} {updates.dtype} -> {out_dtype}")
    if updates.shape[0] != ids.shape[0]:
        raise ValueError(f"{ids.shape[0]} ids for {updates.shape[0]} update rows")
    if not (ids.is_contiguous() and updates.is_contiguous()):
        raise ValueError("scatter_rows_cuda needs contiguous ids and updates")
    n, w = updates.shape
    if max(n, v_rows, w) >= 2**31 or v_rows < 0 or n >= 2**30:
        raise ValueError(f"{n} updates of width {w} into {v_rows} rows exceed the kernel's "
                         "extents (R < 2^30, rows and width < 2^31)")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    out = torch.empty(v_rows, w, dtype=out_dtype, device=updates.device)
    if out.numel() == 0:
        return out
    dev = updates.device
    sorted_pairs = torch.empty(4, n, dtype=torch.int32, device=dev)  # keys, positions x 2
    state = torch.empty(sort_state_words(n, v_rows), dtype=torch.int32, device=dev)
    n_pieces = -(-n // chunk)
    part_first = torch.empty(n_pieces, w, dtype=torch.float32, device=dev)
    part_last = torch.empty(n_pieces, w, dtype=torch.float32, device=dev)
    lib = build.load("scatter_rows", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rectpu_scatter_rows(
            ids.data_ptr(), updates.data_ptr(), out.data_ptr(), sorted_pairs.data_ptr(),
            state.data_ptr(), part_first.data_ptr(), part_last.data_ptr(), n, v_rows, w,
            chunk, sort_passes(v_rows), int(updates.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError {err}")
    launches.add()
    return out


def scatter_rows_dense(ids: torch.Tensor, updates: torch.Tensor, v_rows: int,
                       out_dtype: torch.dtype | None = None,
                       chunk: int | None = None) -> torch.Tensor:
    """``zeros([v_rows, W], out_dtype).index_add(ids, updates)`` with fp32
    collision sums; ids outside [0, v_rows) are dropped. CPU tensors take the
    plain version, CUDA tensors the kernel, with ``chunk`` (default the
    pinned ``_AUTO_CHUNK``)."""
    if ids.device.type == "cpu" and updates.device.type == "cpu":
        return scatter_rows_plain(ids, updates, v_rows, out_dtype)
    return scatter_rows_cuda(ids, updates, v_rows, out_dtype,
                             _AUTO_CHUNK["chunk"] if chunk is None else chunk)


def segment_sum_plain(seg: torch.Tensor, order: torch.Tensor, updates: torch.Tensor,
                      num_out: int) -> torch.Tensor:
    """Plain version: ``out[s] = sum of updates[order[r]] over r with seg[r]
    == s`` -> [num_out, W] fp32, summed in the order of r; segments at or
    past ``num_out`` are dropped."""
    seg = seg.long()
    keep = seg < num_out
    out = torch.zeros(num_out, updates.shape[1], dtype=torch.float32, device=updates.device)
    out.index_add_(0, seg[keep], updates[order[keep]].float())
    return out


def segment_sum_cuda(seg: torch.Tensor, order: torch.Tensor, updates: torch.Tensor,
                     num_out: int) -> torch.Tensor:
    """Sum a sorted stream by the scatter's sum kernels: seg [R] int32
    nondecreasing (segment ordinals), order [R] int64 (the row of
    ``updates`` at each position), updates [n, W] fp32 or bf16, all
    contiguous on one card -> [num_out, W] fp32. Raises on anything the
    kernel does not take."""
    if not (seg.is_cuda and order.is_cuda and updates.is_cuda
            and seg.device == order.device == updates.device):
        raise ValueError(f"segment_sum_cuda needs seg, order and updates on one CUDA device, "
                         f"got {seg.device}, {order.device}, {updates.device}")
    if seg.dim() != 1 or seg.dtype != torch.int32 or order.dtype != torch.int64 \
            or order.shape != seg.shape:
        raise ValueError(f"seg must be [R] int32 and order [R] int64, got {tuple(seg.shape)} "
                         f"{seg.dtype} and {tuple(order.shape)} {order.dtype}")
    if updates.dim() != 2 or updates.dtype not in _DTYPES:
        raise ValueError(f"updates must be [n, W] float32 or bfloat16, got "
                         f"{tuple(updates.shape)} {updates.dtype}")
    if not (seg.is_contiguous() and order.is_contiguous() and updates.is_contiguous()):
        raise ValueError("segment_sum_cuda needs contiguous seg, order and updates")
    n, w = seg.shape[0], updates.shape[1]
    if max(n, num_out, w) >= 2**31 or num_out < 0:
        raise ValueError(f"{n} positions of width {w} into {num_out} segments exceed the "
                         "kernel's int32 extents")
    out = torch.empty(num_out, w, dtype=torch.float32, device=updates.device)
    if out.numel() == 0:
        return out
    n_pieces = -(-n // CHUNK)
    part_first = torch.empty(n_pieces, w, dtype=torch.float32, device=updates.device)
    part_last = torch.empty(n_pieces, w, dtype=torch.float32, device=updates.device)
    lib = build.load("scatter_rows", _SIGNATURES)
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        err = lib.rectpu_segment_sum(
            seg.data_ptr(), order.data_ptr(), updates.data_ptr(), out.data_ptr(),
            part_first.data_ptr(), part_last.data_ptr(), n, num_out, w, CHUNK,
            int(updates.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {err}")
    segment_launches.add()
    return out


def segment_sum(seg: torch.Tensor, order: torch.Tensor, updates: torch.Tensor,
                num_out: int) -> torch.Tensor:
    """Per-segment fp32 sums of a sorted stream -> [num_out, W] (see
    ``segment_sum_plain``). CPU tensors take the plain version, CUDA tensors
    the kernel."""
    if updates.device.type == "cpu" and seg.device.type == "cpu":
        return segment_sum_plain(seg, order, updates, num_out)
    return segment_sum_cuda(seg, order, updates, num_out)
