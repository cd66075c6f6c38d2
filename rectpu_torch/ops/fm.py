"""Factorization-machine interaction: the port of ``rectpu/ops/fm.py``.

    fm[b] = 0.5 * sum_k((sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2)
    dv[b, f, k] = g[b] * (S[b,k] - v[b,f,k]),   S = sum_f v

rectpu's ``fm_impl`` values ("auto", "xla", "pallas", "matmul") are TPU
choices; in the port each one runs this module's ``fm_cross``, a
``torch.autograd.Function``:

  - on CUDA tensors, the hand-written kernels of ``kernels/csrc/fm.cu``: the
    forward (the port of the Pallas ``_fm_fwd_kernel``,
    ``rectpu/ops/fm.py:271``; three kernels, one a mode of ``fm_fwd_plan``,
    with one order of sums, which ``fm_fwd_in_order`` reproduces) and the
    backward (``_fm_bwd_kernel``, :281);
  - on CPU tensors, their plain versions ``fm_cross_xla`` and
    ``fm_cross_bwd_xla``.

Both follow the Pallas kernels' contract: fp32 sums and fp32 backward math;
the forward's result in v's type unless ``out_dtype`` asks for fp32, and the
backward's in v's type. (For fp32 input that is also rectpu's XLA form; for
bf16 input rectpu's XLA form rounds its intermediates to bf16 and the Pallas
kernels do not.) ``out_dtype=torch.float32`` on bf16 input is the flat
layout's FM logit (``fm_cross_flat``, :108-114), which is not rounded to
bf16. The
order-3 term ``fm_cross3_xla`` has no Pallas kernel in rectpu and stays plain
PyTorch, differentiated by autograd.

The lane-packed flat FM on v2 [B, F*K] has rectpu's two routes, chosen by
``fm_cross_flat_dispatch`` through the ``_FLAT_AUTO`` pin that the autotuner
sets (``set_flat_auto_impl``; rectpu :254-268):

  - "xla", ``fm_cross_flat``: ``fm_cross`` on the [B, F, K] view with an fp32
    result, whose backward keeps the forward's fp32 S (rectpu's XLA form
    rounds S and its backward math to v2's dtype: a documented deviation);
  - "pallas", ``fm_cross_flat_pallas``: the flat kernels of ``fm.cu``, the
    port of ``_fm_flat_fwd_kernel`` (:146) and ``_fm_flat_bwd_kernel`` (:156),
    on CUDA tensors, and their plain versions ``fm_cross_flat_plain`` /
    ``fm_cross_flat_bwd_plain`` on CPU tensors. The forward returns the fp32
    logit and S in v2's dtype; the backward reads that stored S, as rectpu's
    Pallas pair does.

As in rectpu, "pallas" with ``F*K % 128 != 0`` takes the "xla" route, so the
same inputs choose the same function (the kernels themselves take any F*K).
Only the autotuner reaches the dispatcher: it times both routes through it
and pins the faster. The flat-layout DeepFM calls ``fm_cross`` directly, as
rectpu's ``_apply_flat`` calls ``fm_cross_flat``.

``fm_cross_op`` (``rectpu_torch::fm_cross``) registers the forward as a
``torch.library`` op with a fake shape, which ``fm_cross`` calls only while
``torch.export`` traces: a serialized serving program (``serve/export.py``)
records it and runs the kernel (CUDA) or the plain version (CPU).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from rectpu_torch.device import device_key
from rectpu_torch.kernels import LaunchCount, build

IMPLS = ("auto", "xla", "pallas", "matmul")

launches = LaunchCount("fm_cross")
bwd_launches = LaunchCount("fm_cross_bwd")
flat_launches = LaunchCount("fm_cross_flat")
flat_bwd_launches = LaunchCount("fm_cross_flat_bwd")

# the route "auto" takes in fm_cross_flat_dispatch, by device type (rectpu
# keys "tpu" / "other")
_FLAT_AUTO = {"cuda": "xla", "cpu": "xla"}

_SIGNATURES = {
    "rectpu_fm_cross": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
    "rectpu_fm_cross_bwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
    "rectpu_fm_cross_flat": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
    "rectpu_fm_cross_flat_bwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def _out_dtype(v: torch.Tensor, out_dtype) -> torch.dtype:
    if out_dtype is None or out_dtype == v.dtype:
        return v.dtype
    if out_dtype == torch.float32:
        return out_dtype
    raise ValueError(f"out_dtype must be v's dtype or float32, got {out_dtype} for {v.dtype}")


def fm_cross_xla(v: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: v [B, F, K] -> [B] in ``out_dtype`` (default v's
    dtype), sums in fp32."""
    v32 = v.float()
    s = v32.sum(dim=1)
    square_sum = (v32 * v32).sum(dim=1)
    return (0.5 * (s * s - square_sum).sum(dim=-1)).to(_out_dtype(v, out_dtype))


def fm_fwd_in_order(v: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch (``fm.cu``'s header),
    so its bits on finite inputs: for each (b, k), S and Q summed over f = 0
    .. F-1 one fp32 add at a time from 0, the term S*S - Q; partial j of 32
    adds the terms k = j, j+32, ... in order from 0; the partials are added
    in halves (16, 8, 4, 2, 1: the kernel's xor shuffles); 0.5 times the sum
    is rounded once to ``out_dtype`` (default v's dtype)."""
    b, f, k = v.shape
    s = torch.zeros(b, k, dtype=torch.float32, device=v.device)
    q = torch.zeros_like(s)
    for i in range(f):
        x = v[:, i, :].float()
        s = s + x
        q = q + x * x
    terms = s * s - q
    p = torch.zeros(b, 32, dtype=torch.float32, device=v.device)
    for k0 in range(0, k, 32):
        chunk = terms[:, k0:k0 + 32]
        p[:, :chunk.shape[1]] = p[:, :chunk.shape[1]] + chunk
    for half in (16, 8, 4, 2, 1):
        p = p[:, :half] + p[:, half:2 * half]
    return (0.5 * p[:, 0]).to(_out_dtype(v, out_dtype))


def fm_cross_bwd_xla(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain backward: v [B, F, K], g [B] -> dv = g*(S - v) [B, F, K] in v's
    dtype, fp32 math."""
    v32 = v.float()
    s = v32.sum(dim=1, keepdim=True)
    return (g.float()[:, None, None] * (s - v32)).to(v.dtype)


def fm_cross3_xla(v: torch.Tensor) -> torch.Tensor:
    """Order-3 FM logit (elementary symmetric e3 over fields, summed over k):
    v [B, F, K] -> [B] fp32 (``rectpu/ops/fm.py:395``)."""
    v32 = v.float()
    p1 = v32.sum(dim=1)
    p2 = (v32 * v32).sum(dim=1)
    p3 = (v32 * (v32 * v32)).sum(dim=1)
    e3 = (p1 * (p1 * p1) - 3.0 * p1 * p2 + 2.0 * p3) / 6.0
    return e3.sum(dim=-1)


def _lanes_per_row(k: int) -> int:
    """Lanes that share one batch row in the kernels: K rounded up to a power
    of two, at most a warp."""
    g = 1
    while g < min(k, 32):
        g *= 2
    return g


def _check_v(v: torch.Tensor, who: str) -> None:
    if not v.is_cuda:
        raise ValueError(f"{who} needs a CUDA tensor, got {v.device}")
    if v.dim() != 3 or v.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"v must be [B, F, K] float32 or bfloat16, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if v.shape[2] > 1 and v.stride(2) != 1:
        raise ValueError(f"v's innermost stride must be 1, got strides {v.stride()}")
    if max(v.shape) >= 2**31 or v.shape[1] * v.shape[2] >= 2**31:
        raise ValueError(f"v of shape {tuple(v.shape)} strides {v.stride()} is outside "
                         "the kernel's extents")


def fm_cross_cuda(v: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the FM forward on v [B, F, K], fp32 or bf16, on a CUDA device;
    the result in v's dtype or fp32.

    v may be a strided view (``looked[..., :K]`` of the fused gather): the
    batch and field strides go to the kernel that ``fm_fwd_plan`` picks for
    them, with its plan, and only the innermost stride must be 1. Raises on
    anything the kernels do not take."""
    _check_v(v, "fm_cross_cuda")
    out_dtype = _out_dtype(v, out_dtype)
    b, f, k = v.shape
    out = torch.empty(b, dtype=out_dtype, device=v.device)
    if b == 0:
        return out
    plan = fm_fwd_plan(b, f, k, v.stride(0), v.stride(1), v.element_size(),
                       v.data_ptr() % 16 == 0,
                       torch.cuda.get_device_properties(v.device).multi_processor_count)
    lib = build.load("fm", _SIGNATURES)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.rectpu_fm_cross(v.data_ptr(), out.data_ptr(), b, f, k, plan.stride_b,
                                  plan.stride_f, int(v.dtype == torch.bfloat16),
                                  int(out_dtype == torch.float32), FWD_MODES.index(plan.mode),
                                  plan.rows_per_tile, plan.stage_bytes, plan.slot_bytes,
                                  plan.smem_bytes, plan.group, plan.blocks, stream)
    if err != 0:
        raise RuntimeError(f"fm_cross kernel launch failed: cudaError {err}")
    launches.add()
    return out


# The forward kernel's plan (fm.cu). The staged modes: a block of
# FWD_THREADS threads takes tiles of rows_per_tile rows in turn through one
# stage; its shared memory holds the mbarrier, the stage and the terms
# [TB, K] in fp32. A tile is at most FWD_TILE_BYTES and as large as
# leaves a tile for each of FWD_BLOCKS_PER_SM blocks an SM, so that every SM
# has several tiles' copies in flight at once even at B=512 (the values timed
# best of those tried on an H100, PERF.md §6). The "fields" and "direct"
# modes read device memory straight, FWD_DIRECT_THREADS threads a block,
# `group` lanes a row.
FWD_THREADS = 256
FWD_DIRECT_THREADS = 64
FWD_BARRIER_BYTES = 128
FWD_TILE_BYTES = 32 * 1024
FWD_BLOCKS_PER_SM = 8
FWD_MAX_ROWS = 64
FWD_MODES = ("span", "rows", "fields", "direct")  # fm.cu's FwdMode, in order
H100_SMS = 132


@dataclass(frozen=True)
class FmFwdPlan:
    """How the forward kernels read v [B, F, K] (strides in elements,
    normalised as in ``fm_bwd_plan``).

    ``mode``: "span" and "rows" stage tiles in shared memory as the backward
    does (one copy a tile, or one a row); "fields" reads each (row, field)
    run of K values in 16-byte vectors straight from device memory (v, both
    strides and a run 16-byte multiples, a run at most 32 vectors) and
    reads no pad; "direct" reads single values straight from device memory
    (a row wider than any stage, or no fields or columns). ``blocks``: the
    grid (staged: block j takes tiles j, j + blocks, ...; else a block takes
    FWD_DIRECT_THREADS / group rows)."""

    mode: str
    rows_per_tile: int
    stage_bytes: int
    slot_bytes: int
    smem_bytes: int
    stride_b: int
    stride_f: int
    n_tiles: int
    blocks: int
    group: int


@functools.lru_cache(maxsize=256)
def fm_fwd_plan(b: int, f: int, k: int, stride_b: int, stride_f: int, elem_bytes: int,
                aligned: bool, sms: int = H100_SMS) -> FmFwdPlan:
    """The plan for v [b, f, k] with the given batch and field strides
    (elements), element size, whether v starts on 16 bytes, and the card's
    SM count: pure Python, mirrored by the kernels."""
    if f == 1:
        stride_f = k
    if b == 1:
        stride_b = f * stride_f
    es = elem_bytes

    def unstaged(mode: str, group: int) -> FmFwdPlan:
        rows = FWD_DIRECT_THREADS // group
        return FmFwdPlan(mode, 1, 0, 0, 0, stride_b, stride_f, b, -(-b // rows), group)

    if b == 0 or f == 0 or k == 0:
        return unstaged("direct", _lanes_per_row(k))
    row_bytes = ((f - 1) * stride_f + k) * es  # one row's elements, first to last
    sb = stride_b * es
    span = stride_b == f * stride_f and stride_f >= k
    vec = 16 // es  # a vector's columns
    if (aligned and (k * es) % 16 == 0 and (stride_f * es) % 16 == 0 and sb % 16 == 0
            and k // vec <= 32 and not (span and stride_f == k)):
        # aligned runs with pad between fields: 16-byte vectors, no pad read
        return unstaged("fields", max(32 // vec, _lanes_per_row(k // vec)))
    mode = "span" if span else "rows"
    slot = _align16(row_bytes + 15) if mode == "rows" else 0

    def stage_bytes(tb: int) -> int:
        if mode == "span":  # a window widened to 16-byte boundaries adds at most 15 bytes
            return _align16((tb - 1) * sb + row_bytes + 15)
        return tb * slot

    def smem(tb: int) -> int:
        return FWD_BARRIER_BYTES + stage_bytes(tb) + 4 * tb * k

    want = FWD_BLOCKS_PER_SM * sms
    tb = 1
    while (tb < min(b, FWD_MAX_ROWS) and stage_bytes(tb + 1) <= FWD_TILE_BYTES
           and -(-b // (tb + 1)) >= want):
        tb += 1
    if smem(tb) > BWD_SMEM_MAX:
        return unstaged("direct", _lanes_per_row(k))
    n_tiles = -(-b // tb)
    return FmFwdPlan(mode, tb, stage_bytes(tb), slot, _align16(smem(tb)), stride_b, stride_f,
                     n_tiles, min(n_tiles, want), 0)


# The backward kernel's tile plan (fm.cu, fm_bwd_kernel). A block has
# BWD_THREADS threads and, for two blocks an SM, at most BWD_SMEM_TWO bytes of
# shared memory: its mbarriers, BWD_STAGES stages of staged rows, S [TB, K]
# and g [TB] in fp32. A plan that does not fit two an SM may take the whole
# BWD_SMEM_MAX of one block; a row that fits neither is not staged.
BWD_THREADS = 256
BWD_STAGES = 2
BWD_BARRIER_BYTES = 128
BWD_SMEM_TWO = 115_200  # (232,448 - 2 x 1 KB reserved) / 2 on an H100 SM
BWD_SMEM_MAX = 232_448  # the most one block may have
BWD_MAX_ROWS = 64  # rows a tile at most


@dataclass(frozen=True)
class FmBwdPlan:
    """How ``fm_bwd_kernel`` stages v [B, F, K] (strides in elements, already
    normalised: a size-1 dimension takes the stride of a packed layout).

    ``mode``: "span" copies a tile's rows in one window (stride_b == F *
    stride_f, stride_f >= K), "rows" one window a row, "direct" stages
    nothing (a row wider than a stage). ``vec``: 1 when every store writes
    16 bytes (tiles of rows_per_tile * F * K elements are then 16-byte
    multiples)."""

    mode: str
    rows_per_tile: int
    stages: int
    stage_bytes: int
    slot_bytes: int
    smem_bytes: int
    vec: int
    stride_b: int
    stride_f: int
    n_tiles: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def fm_bwd_plan(b: int, f: int, k: int, stride_b: int, stride_f: int,
                elem_bytes: int) -> FmBwdPlan:
    """The tile plan for v [b, f, k] with the given batch and field strides
    (elements) and element size: pure Python, mirrored by the kernel."""
    if f == 1:
        stride_f = k
    if b == 1:
        stride_b = f * stride_f
    row_bytes = ((f - 1) * stride_f + k) * elem_bytes  # one row's elements, first to last
    sb = stride_b * elem_bytes
    span = stride_b == f * stride_f and stride_f >= k
    q = 16 // elem_bytes  # rows_per_tile a multiple of q: tiles of 16-byte multiples
    slot = _align16(row_bytes + 15)  # a row's widest window, 16-byte aligned

    def stage_bytes(tb: int) -> int:
        # a window widened to 16-byte boundaries adds at most 15 bytes in all
        return _align16((tb - 1) * sb + row_bytes + 15) if span else tb * slot

    def smem(tb: int) -> int:
        return BWD_BARRIER_BYTES + BWD_STAGES * stage_bytes(tb) + 4 * tb * (k + 1)

    for budget in (BWD_SMEM_TWO, BWD_SMEM_MAX):
        fits = [tb for tb in range(1, min(BWD_MAX_ROWS, max(b, 1)) + 1) if smem(tb) <= budget]
        if not fits:
            continue
        aligned = [tb for tb in fits if tb % q == 0 or (tb * f * k * elem_bytes) % 16 == 0]
        tb = max(aligned) if aligned else max(fits)
        vec = int((tb * f * k * elem_bytes) % 16 == 0)
        return FmBwdPlan("span" if span else "rows", tb, BWD_STAGES, stage_bytes(tb),
                         0 if span else slot, _align16(smem(tb)), vec, stride_b, stride_f,
                         -(-b // tb))
    return FmBwdPlan("direct", 1, 0, 0, 0, 0, 0, stride_b, stride_f, b)


def fm_bwd_windows(plan: FmBwdPlan | FmFwdPlan, b: int, f: int, k: int, elem_bytes: int,
                   addr: int) -> list[list[tuple[int, int, int]]]:
    """For each tile, the bulk copies a staged plan makes for v at byte
    address ``addr``: (first byte, bytes, offset in the stage). Both kernels
    compute the same windows from the same formulas (fm.cu, ``copy_rows``);
    the forward's "fields" and "direct" modes, like the backward's "direct",
    stage nothing."""
    if plan.mode not in ("span", "rows"):
        return []
    sb = plan.stride_b * elem_bytes
    row_bytes = ((f - 1) * plan.stride_f + k) * elem_bytes
    tiles = []
    for t in range(plan.n_tiles):
        b0 = t * plan.rows_per_tile
        rows = min(plan.rows_per_tile, b - b0)
        first = addr + b0 * sb
        if plan.mode == "span":
            lo, hi = first // 16 * 16, _align16(first + (rows - 1) * sb + row_bytes)
            tiles.append([(lo, hi - lo, 0)])
        else:
            tiles.append([((first + r * sb) // 16 * 16,
                           _align16(first + r * sb + row_bytes) - (first + r * sb) // 16 * 16,
                           r * plan.slot_bytes) for r in range(rows)])
    return tiles


def fm_cross_bwd_cuda(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the FM backward kernel: v [B, F, K] (strided as for the
    forward), g [B] of any float dtype on the same card -> dv [B, F, K]
    contiguous in v's dtype."""
    _check_v(v, "fm_cross_bwd_cuda")
    if g.device != v.device or g.shape != (v.shape[0],) or not g.is_floating_point():
        raise ValueError(f"g must be [{v.shape[0]}] floating on {v.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    b, f, k = v.shape
    dv = torch.empty(b, f, k, dtype=v.dtype, device=v.device)
    if dv.numel() == 0:
        return dv
    g32 = g.float().contiguous()
    plan = fm_bwd_plan(b, f, k, v.stride(0), v.stride(1), v.element_size())
    mode = ("span", "rows", "direct").index(plan.mode)
    lib = build.load("fm", _SIGNATURES)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.rectpu_fm_cross_bwd(v.data_ptr(), g32.data_ptr(), dv.data_ptr(), b, f, k,
                                      plan.stride_b, plan.stride_f,
                                      int(v.dtype == torch.bfloat16), mode, plan.rows_per_tile,
                                      plan.stages, plan.stage_bytes, plan.slot_bytes,
                                      plan.smem_bytes, plan.vec, stream)
    if err != 0:
        raise RuntimeError(f"fm_cross backward kernel launch failed: cudaError {err}")
    bwd_launches.add()
    return dv


class _FmCross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, out_dtype):
        ctx.save_for_backward(v)
        if v.device.type == "cpu":
            return fm_cross_xla(v, out_dtype)
        return fm_cross_cuda(v, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        if v.device.type == "cpu":
            return fm_cross_bwd_xla(v, g), None
        return fm_cross_bwd_cuda(v, g), None


@torch.library.custom_op("rectpu_torch::fm_cross", mutates_args=())
def fm_cross_op(v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The FM forward as a registered op, for serialized programs: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if v.device.type == "cpu":
        return fm_cross_xla(v, out_dtype)
    return fm_cross_cuda(v, out_dtype)


@fm_cross_op.register_fake
def _(v, out_dtype):
    return v.new_empty((v.shape[0],), dtype=out_dtype)


def fm_cross(v: torch.Tensor, impl: str = "auto",
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """FM second-order logit from field embeddings v [B, F, K] -> [B] in v's
    dtype (or ``out_dtype=torch.float32``), differentiable in v. ``impl`` is
    the recorded ``fm_impl``; every value runs the same function. While
    ``torch.export`` traces, it records ``rectpu_torch::fm_cross``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fm_impl {impl!r} (expected one of {IMPLS})")
    if torch.compiler.is_exporting():
        return fm_cross_op(v, _out_dtype(v, out_dtype))
    return _FmCross.apply(v, out_dtype)


# --- the lane-packed flat FM ---------------------------------------------------


def _check_flat(v2: torch.Tensor, f: int, k: int) -> None:
    if v2.dim() != 2 or v2.shape[1] != f * k:
        raise ValueError(f"v2 must be [B, {f}*{k}], got {tuple(v2.shape)}")


def fm_cross_flat_plain(v2: torch.Tensor, f: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flat forward: v2 [B, F*K] -> (out [B] fp32, S
    [B, K] in v2's dtype), S = sum over fields in fp32."""
    _check_flat(v2, f, k)
    v32 = v2.float()
    s = v32.reshape(-1, f, k).sum(dim=1)
    out = 0.5 * ((s * s).sum(dim=-1) - (v32 * v32).sum(dim=-1))
    return out, s.to(v2.dtype)


def fm_cross_flat_bwd_plain(v2: torch.Tensor, s: torch.Tensor, g: torch.Tensor, f: int,
                            k: int) -> torch.Tensor:
    """Plain version of the flat backward: dv2 = g * (S tiled over the F
    fields - v2) in fp32 on the stored S, in v2's dtype."""
    _check_flat(v2, f, k)
    s_tiled = s.float().repeat(1, f)
    return (g.float()[:, None] * (s_tiled - v2.float())).to(v2.dtype)


def _flat_layout(v2: torch.Tensor, k: int, *others: torch.Tensor) -> tuple[int, int]:
    """(vec, group) for the flat kernels: 16-byte vectors when K, the row
    stride and every pointer allow them, and the lanes per row."""
    width = 16 // v2.element_size()
    vec = int(k % width == 0 and v2.stride(0) % width == 0
              and all(t.data_ptr() % 16 == 0 for t in (v2, *others)))
    return vec, _lanes_per_row(k // width if vec else k)


def _check_flat_cuda(v2: torch.Tensor, f: int, k: int, who: str) -> None:
    if not v2.is_cuda:
        raise ValueError(f"{who} needs a CUDA tensor, got {v2.device}")
    _check_flat(v2, f, k)
    if v2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"v2 must be float32 or bfloat16, got {v2.dtype}")
    if f * k > 1 and v2.stride(1) != 1:
        raise ValueError(f"v2's innermost stride must be 1, got strides {v2.stride()}")
    if v2.shape[0] >= 2**31 or f * k >= 2**31:
        raise ValueError(f"v2 of shape {tuple(v2.shape)} is outside the kernel's extents")


def fm_cross_flat_cuda(v2: torch.Tensor, f: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the flat forward kernel on v2 [B, F*K], fp32 or bf16, rows of
    any stride, on a CUDA device -> (out [B] fp32, S [B, K] in v2's dtype).
    Raises on anything the kernel does not take."""
    _check_flat_cuda(v2, f, k, "fm_cross_flat_cuda")
    b = v2.shape[0]
    out = torch.empty(b, dtype=torch.float32, device=v2.device)
    s = torch.empty(b, k, dtype=v2.dtype, device=v2.device)
    if b == 0:
        return out, s
    vec, group = _flat_layout(v2, k, s)
    lib = build.load("fm", _SIGNATURES)
    with torch.cuda.device(v2.device):
        stream = torch.cuda.current_stream(v2.device).cuda_stream
        err = lib.rectpu_fm_cross_flat(v2.data_ptr(), out.data_ptr(), s.data_ptr(), b, f, k,
                                       v2.stride(0), group, int(v2.dtype == torch.bfloat16),
                                       vec, stream)
    if err != 0:
        raise RuntimeError(f"fm_cross_flat kernel launch failed: cudaError {err}")
    flat_launches.add()
    return out, s


def fm_cross_flat_bwd_cuda(v2: torch.Tensor, s: torch.Tensor, g: torch.Tensor, f: int,
                           k: int) -> torch.Tensor:
    """Launch the flat backward kernel: v2 [B, F*K] (as for the forward), S
    [B, K] contiguous in v2's dtype, g [B] of any float dtype, all on one card
    -> dv2 [B, F*K] contiguous in v2's dtype."""
    _check_flat_cuda(v2, f, k, "fm_cross_flat_bwd_cuda")
    b = v2.shape[0]
    if s.device != v2.device or s.shape != (b, k) or s.dtype != v2.dtype \
            or not s.is_contiguous():
        raise ValueError(f"S must be [{b}, {k}] {v2.dtype} contiguous on {v2.device}, got "
                         f"{tuple(s.shape)} {s.dtype} on {s.device}")
    if g.device != v2.device or g.shape != (b,) or not g.is_floating_point():
        raise ValueError(f"g must be [{b}] floating on {v2.device}, got {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")
    dv = torch.empty(b, f * k, dtype=v2.dtype, device=v2.device)
    if dv.numel() == 0:
        return dv
    g32 = g.float().contiguous()
    vec, group = _flat_layout(v2, k, s, dv)
    lib = build.load("fm", _SIGNATURES)
    with torch.cuda.device(v2.device):
        stream = torch.cuda.current_stream(v2.device).cuda_stream
        err = lib.rectpu_fm_cross_flat_bwd(v2.data_ptr(), s.data_ptr(), g32.data_ptr(),
                                           dv.data_ptr(), b, f, k, v2.stride(0), group,
                                           int(v2.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"fm_cross_flat backward kernel launch failed: cudaError {err}")
    flat_bwd_launches.add()
    return dv


class _FmCrossFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v2, f, k):
        if v2.device.type == "cpu":
            out, s = fm_cross_flat_plain(v2, f, k)
        else:
            out, s = fm_cross_flat_cuda(v2, f, k)
        ctx.save_for_backward(v2, s)  # the backward reads the stored S
        ctx.fk = (f, k)
        return out

    @staticmethod
    def backward(ctx, g):
        v2, s = ctx.saved_tensors
        f, k = ctx.fk
        if v2.device.type == "cpu":
            return fm_cross_flat_bwd_plain(v2, s, g, f, k), None, None
        return fm_cross_flat_bwd_cuda(v2, s, g, f, k), None, None


def fm_cross_flat_pallas(v2: torch.Tensor, f: int, k: int) -> torch.Tensor:
    """rectpu's "pallas" flat route: v2 [B, F*K] -> [B] fp32 through the flat
    kernels (plain versions on the CPU), differentiable in v2."""
    return _FmCrossFlat.apply(v2, f, k)


def fm_cross_flat(v2: torch.Tensor, f: int, k: int) -> torch.Tensor:
    """rectpu's "xla" flat route: ``fm_cross`` on the [B, F, K] view of v2
    [B, F*K] -> [B] fp32, differentiable in v2."""
    _check_flat(v2, f, k)
    return fm_cross(v2.reshape(v2.shape[0], f, k), out_dtype=torch.float32)


def set_flat_auto_impl(name: str, device_type: str = "cuda") -> None:
    """Pin the route "auto" takes in ``fm_cross_flat_dispatch`` (the
    autotuner's pick)."""
    if name not in ("xla", "pallas"):
        raise ValueError(f"flat FM impl must be 'xla' or 'pallas', got {name!r}")
    _FLAT_AUTO[device_key(device_type)] = name


def fm_cross_flat_dispatch(v2: torch.Tensor, f: int, k: int,
                           impl: str = "auto") -> torch.Tensor:
    """The flat FM entry point: "auto" resolves to the pin for v2's device;
    "pallas" needs F*K % 128 == 0, as in rectpu, and takes the "xla" route
    otherwise."""
    if impl == "auto":
        impl = _FLAT_AUTO[device_key(v2)]
    if impl == "pallas" and v2.shape[1] % 128 == 0:
        return fm_cross_flat_pallas(v2, f, k)
    return fm_cross_flat(v2, f, k)
