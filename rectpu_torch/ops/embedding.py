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
to the table's dtype. For an fp32 table and a bf16 ``gather_dtype`` the
kernel rounds the gathered rows itself (``out_dtype``), which is bitwise the
cast then the gather and spares the pass over the whole table. Ids outside
``[0, V)`` give a zero row and receive no gradient, as the Pallas one-hot
kernels do.

``dequant_gather`` is the gather's int8 mode for quantized serving tables
(``serve/quant.py``): int8 rows q [V, W] and fp32 scales s [V] give
``float(q[id]) * s[id]`` in fp32 or rounded once to bf16, a zero row for an
id outside the table; on CPU tensors its plain version ``dequant_take``. It
is rectpu's ``dequant_lookup`` (``rectpu/serve/quant.py:53-62``, XLA there)
followed by ``lookup_fields``' cast, bit for bit; one launch where plain
PyTorch takes two gathers, a cast and a multiply with an fp32 [B, F, W]
intermediate. Serving only: it has no backward.

``lookup_plan`` is the kernel's launch plan (its path, the rows a tile or
the lanes a row, the blocks), pure Python so that the CPU tests check it.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from rectpu_torch.kernels import LaunchCount, build
from rectpu_torch.ops.scatter_rows import scatter_rows_dense

IMPLS = ("auto", "take", "onehot", "pallas", "split")

launches = LaunchCount("embedding_lookup")
int8_launches = LaunchCount("embedding_lookup_int8")

_DTYPE_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_SIGNATURES = {
    "rectpu_lookup_rows": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "rectpu_lookup_rows_int8": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}

# the kernel's launch shape (embedding_lookup.cu): threads a block; on the
# vector path the rows a lane group copies at once; on the tile path the
# columns a thread gathers from a row, the (row, chunk) pairs a thread takes
# in a tile and the shared memory a tile may take
LOOKUP_THREADS = 256
VEC_ROWS = 2
TILE_COLS = 8
TILE_PAIRS = 2
TILE_SMEM_MAX = 48 * 1024
PATHS = ("vector", "tile", "rows")


@dataclass(frozen=True)
class LookupPlan:
    """``path``: "vector" (16-byte copies), "tile" (tiles of rows staged in
    shared memory, each written as one span), "rows" (a warp a row, for an
    unaligned row too wide for a tile). ``param``: the lanes a row (vector)
    or the rows a tile (tile). ``blocks``: the grid (the tile path launches
    at most what the card holds at once); ``smem_bytes``: a tile block's
    shared memory."""

    path: str
    param: int
    blocks: int
    smem_bytes: int


def lookup_plan(n_ids: int, width: int, in_bytes: int, out_bytes: int, aligned: bool = True,
                n_sms: int = 132) -> LookupPlan:
    """The gather's plan for ``n_ids`` rows of ``width`` elements, read
    ``in_bytes`` and written ``out_bytes`` an element; ``aligned``: the
    table's first byte is 16-byte aligned (the output's always is)."""
    warps_per_block = LOOKUP_THREADS // 32
    if aligned and (width * in_bytes) % 16 == 0 and (width * out_bytes) % 16 == 0:
        chunks = width * out_bytes // 16
        lanes = min(32, 1 << max(chunks - 1, 0).bit_length())
        rows_per_block = 32 // lanes * VEC_ROWS * warps_per_block
        return LookupPlan("vector", lanes, -(-n_ids // rows_per_block), 0)
    q = 16 // math.gcd(width * out_bytes, 16)  # rows whose output is a 16-byte multiple

    def smem(rows: int) -> int:
        return -(-rows * 4 // 16) * 16 + rows * width * out_bytes

    # TILE_PAIRS (row, TILE_COLS-column chunk) pairs a thread; at most a
    # thread a row's id; no fewer than four tiles an SM where the ids allow
    rows = TILE_PAIRS * LOOKUP_THREADS // -(-width // TILE_COLS)
    rows = max(q, min(rows, LOOKUP_THREADS) // q * q)
    rows = min(rows, max(q, -(-n_ids // (4 * n_sms * q)) * q))
    while rows > q and smem(rows) > TILE_SMEM_MAX:
        rows -= q
    if smem(rows) <= TILE_SMEM_MAX:
        return LookupPlan("tile", rows, -(-n_ids // rows), smem(rows))
    return LookupPlan("rows", 0, max(1, min(-(-n_ids // warps_per_block), n_sms * 16)), 0)


def lookup_take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: table [V, W], ids [...] integer -> [..., W]; rows of
    out-of-range ids are zero."""
    v = table.shape[0]
    ids = ids.long()
    valid = (ids >= 0) & (ids < v)
    rows = table[ids.clamp(0, max(v - 1, 0))]
    return torch.where(valid.unsqueeze(-1), rows, torch.zeros((), dtype=table.dtype,
                                                              device=table.device))


def _out_dtype(table: torch.Tensor, out_dtype: torch.dtype | None) -> torch.dtype:
    if out_dtype is None or out_dtype == table.dtype:
        return table.dtype
    if table.dtype == torch.float32 and out_dtype == torch.bfloat16:
        return out_dtype
    raise ValueError(f"the gather converts float32 rows to bfloat16 only, not {table.dtype} "
                     f"to {out_dtype}")


def lookup_cuda(table: torch.Tensor, ids: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the gather kernel: table [V, W] fp32 or bf16, contiguous; ids
    [...] int32, contiguous, on the same card -> [..., W] in ``out_dtype``
    (default the table's; an fp32 table may be gathered as bf16, each element
    rounded to nearest even). Raises on anything else."""
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
    out_dtype = _out_dtype(table, out_dtype)
    v, w = table.shape
    if v >= 2**31 or w >= 2**31:
        raise ValueError(f"table {tuple(table.shape)} exceeds the kernel's int32 extents")
    out = torch.empty(*ids.shape, w, dtype=out_dtype, device=table.device)
    if out.numel() == 0:
        return out
    in_bytes, out_bytes = _DTYPE_BYTES[table.dtype], _DTYPE_BYTES[out_dtype]
    plan = lookup_plan(ids.numel(), w, in_bytes, out_bytes, aligned=table.data_ptr() % 16 == 0,
                       n_sms=_sm_count(table.device))
    lib = build.load("embedding_lookup", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.rectpu_lookup_rows(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                                     ids.numel(), v, w, in_bytes, out_bytes,
                                     PATHS.index(plan.path), plan.param, plan.blocks,
                                     plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"embedding_lookup kernel launch failed: cudaError {err}")
    launches.add()
    return out


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``table[ids]`` outside autograd (zero rows for out-of-range ids), in
    ``out_dtype`` (default the table's; float32 -> bfloat16 is the one
    conversion): the plain version for CPU tensors, the gather kernel for CUDA
    tensors."""
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return lookup_take(table, ids).to(_out_dtype(table, out_dtype))
    return lookup_cuda(table, ids, out_dtype)


def dequant_take(q: torch.Tensor, s: torch.Tensor, ids: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the int8 gather: ``(q[ids].float() * s[ids, None])``
    in ``out_dtype``; rows of out-of-range ids are zero."""
    return (lookup_take(q, ids).float() * lookup_take(s[:, None], ids)).to(out_dtype)


def dequant_lookup_cuda(q: torch.Tensor, s: torch.Tensor, ids: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the gather's int8 mode: q [V, W] int8 and s [V] fp32,
    contiguous; ids [...] int32, contiguous, on the same card -> [..., W] in
    ``out_dtype`` (fp32, or bf16 rounded to nearest even). Raises on
    anything else."""
    if not (q.is_cuda and s.device == q.device and ids.device == q.device):
        raise ValueError(f"dequant_lookup_cuda needs q, s and ids on one CUDA device, got "
                         f"{q.device}, {s.device} and {ids.device}")
    if (q.dim() != 2 or q.dtype != torch.int8 or s.shape != (q.shape[0],)
            or s.dtype != torch.float32):
        raise ValueError(f"q must be 2-D int8 and s its fp32 row scales, got {tuple(q.shape)} "
                         f"{q.dtype} and {tuple(s.shape)} {s.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if out_dtype not in _DTYPE_BYTES:
        raise ValueError(f"the int8 gather writes float32 or bfloat16, not {out_dtype}")
    if not (q.is_contiguous() and s.is_contiguous() and ids.is_contiguous()):
        raise ValueError("dequant_lookup_cuda needs contiguous q, s and ids")
    v, w = q.shape
    if v >= 2**31 or w >= 2**31:
        raise ValueError(f"table {tuple(q.shape)} exceeds the kernel's int32 extents")
    out = torch.empty(*ids.shape, w, dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    # int8 rows never take the vector path, which moves 16-byte chunks as they are
    plan = lookup_plan(ids.numel(), w, 1, _DTYPE_BYTES[out_dtype], aligned=False,
                       n_sms=_sm_count(q.device))
    lib = build.load("embedding_lookup", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rectpu_lookup_rows_int8(q.data_ptr(), s.data_ptr(), ids.data_ptr(),
                                          out.data_ptr(), ids.numel(), v, w,
                                          _DTYPE_BYTES[out_dtype], PATHS.index(plan.path),
                                          plan.param, plan.blocks, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"embedding_lookup int8 kernel launch failed: cudaError {err}")
    int8_launches.add()
    return out


def dequant_gather(q: torch.Tensor, s: torch.Tensor, ids: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(q[ids].float() * s[ids, None]).to(out_dtype)``: the plain version
    for CPU tensors, the gather kernel's int8 mode for CUDA tensors."""
    if q.device.type == "cpu" and ids.device.type == "cpu":
        return dequant_take(q, s, ids, out_dtype)
    return dequant_lookup_cuda(q, s, ids, out_dtype)


@torch.library.custom_op("rectpu_torch::gather", mutates_args=())
def gather_op(table: torch.Tensor, ids: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``gather_rows`` as a registered op: what a serialized program
    (``serve/export.py``) records for the lookup, and runs as the kernel on
    CUDA tensors and the plain version on CPU tensors."""
    return gather_rows(table.contiguous(), ids, out_dtype)


@gather_op.register_fake
def _(table, ids, out_dtype):
    return table.new_empty((*ids.shape, table.shape[1]), dtype=out_dtype)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, gather_dtype, grad_dtype):
        ctx.save_for_backward(ids)
        ctx.table_meta = (table.shape[0], table.dtype, grad_dtype)
        if gather_dtype is None or gather_dtype == table.dtype:
            return gather_rows(table.contiguous(), ids)
        if table.dtype == torch.float32 and gather_dtype == torch.bfloat16:
            return gather_rows(table.contiguous(), ids, gather_dtype)  # rounded in the gather
        return gather_rows(table.to(gather_dtype).contiguous(), ids)

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
    function. ``gather_dtype`` casts the table before the gather (float32 to
    bfloat16 inside the gather: the same bits);
    ``grad_dtype`` is the dtype the dense cotangent is rounded to before the
    cast back to the table's dtype (None: fp32). CPU tensors take the plain
    versions, CUDA tensors the kernels (which raise on what they do not
    take). While ``torch.export`` traces, it records the registered op
    ``rectpu_torch::gather`` instead (``gather_op``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown embedding_impl {impl!r} (expected one of {IMPLS})")
    if torch.compiler.is_exporting():
        # the serialized program records the registered op (forward only)
        if gather_dtype is not None and gather_dtype != table.dtype and not (
                table.dtype == torch.float32 and gather_dtype == torch.bfloat16):
            table = table.to(gather_dtype)
        return gather_op(table, ids, gather_dtype or table.dtype)
    return _Lookup.apply(table, ids, gather_dtype, grad_dtype)
