"""The CIN core (xDeepFM's Compressed Interaction Network): the port of
``rectpu/ops/cin.py``.

    out[b, o, k] = sum_{h, m} w[h, m, o] * x[b, h, k] * y[b, m, k]

Numerics of every rectpu form (``cin_core_xla``, both Pallas variants): each
product x*y is rounded to x's dtype, the products times w (cast to x's dtype)
are summed in fp32, and the result is rounded to x's dtype. The gradients are
rectpu's ``_cin_bwd`` (:220-236): g is cast to x's dtype, and

    dx = cin(g, y, w.permute(2, 1, 0))     dy = cin(g, x, w.permute(2, 0, 1))
    dw[h, m, o] = sum_{b, k} round(x*y)[b, h, m, k] * g[b, o, k]   (fp32, cast to w's dtype)

so no [B, H, M, K] expansion and no cotangent of it is ever formed.

``cin_core`` ([B, *, K] operands) and ``cin_core_kmajor`` ([B, K, *]
operands, rectpu :264-303) compute the same function and run the same two
kernels of ``kernels/csrc/cin.cu`` on CUDA tensors, with the layout passed as
strides: the contraction (the port of the Pallas ``_cin_fwd_kernel``, :70,
and ``_cin_fwd_kernel_mloop``, :88) for the forward, dx and dy, and the
weight gradient (``_cin_dw_kernel``, :101). Both run on ``mma.sync`` with the
A operand built in registers from x and y: in bf16 with W packed here by
``pack_weight`` as ``contraction_plan`` lays it out, and dw's operands laid
out for 16-byte staging by ``dw_operands``; in fp32 as three TF32 products
(3xTF32), with W split and packed here by ``pack_weight_tf32`` as
``contraction_plan_tf32`` lays it out. A contraction with M > 64 takes the
first design's tile kernel in either type. On CPU tensors they run the
plain versions ``cin_plain`` and ``cin_dw_plain``, which form the expansion
and are meant for small CPU shapes only.

The fp32 numerics: each product x*y is rounded to fp32, exactly as rectpu
rounds it; its product with w (or g) is formed by 3xTF32: each fp32 factor v
is split as hi = tf32(v), lo = tf32(v - hi) (``tf32_round``: round to
nearest, ties away from zero), so v = hi + lo within 2^-22 |v|, and lo*hi +
hi*lo + hi*hi (each exact in fp32) is within about 3 * 2^-22 of the fp32
product; the sums are fp32 (the tensor cores', which truncate, so dw sums
each 64-row chunk from zero and adds the chunks rounded to nearest).

rectpu pins its "auto" to "xla" even on the TPU (:199), a speed choice; the
port has no XLA and no counterpart of that pin: on a CUDA tensor it always
launches the kernels.

``cin_op`` (``rectpu_torch::cin``) registers the contraction as a
``torch.library`` op with a fake shape, which ``cin_core`` and
``cin_core_kmajor`` call only while ``torch.export`` traces: a serialized
serving program (``serve/export.py``) records it.
"""

from __future__ import annotations

import ctypes

import torch

from rectpu_torch.kernels import LaunchCount, build

LAYOUTS = ("legacy", "kmajor")

launches = LaunchCount("cin")  # bf16 contractions
launches_fp32 = LaunchCount("cin_fp32")
dw_launches = LaunchCount("cin_dw")  # bf16 weight gradients
dw_launches_fp32 = LaunchCount("cin_dw_fp32")

_LL = ctypes.c_longlong
_SIGNATURES = {
    "rectpu_cin": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [_LL] * 9
        + [ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "rectpu_cin_dw": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [_LL] * 9
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_SIGNATURES["rectpu_cin_mma"] = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [_LL] * 9 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    ctypes.c_int,
)
_SIGNATURES["rectpu_cin_tf32"] = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [_LL] * 9 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    ctypes.c_int,
)
_DW_SLICE_ROWS = 4096  # rows (b, k) per dw partial: fixed, so the sum order is too
_DW_MAX_SLICES = 128
# the bf16 contraction's shared memory: the packed W slice of a column group
# and, for each of 8 warps, two x tiles of its 32 rows and its rounded output
_SMEM_MAX = 227 * 1024
_WARPS, _ROWS, _W_PAD, _OUT_PITCH = 8, 32, 8, 40
_TF32_STAGES = 4  # the fp32 contraction's ring of W (and x) stages, one h a stage


def _bok(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A [B, *, K] view of an operand in ``layout``."""
    return t if layout == "legacy" else t.transpose(1, 2)


def _expand(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """round(x*y) in x's dtype, [B, H, M, K], from [B, *, K] operands."""
    return x[:, :, None, :] * y.to(x.dtype)[:, None, :, :]


def cin_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              layout: str = "legacy") -> torch.Tensor:
    """Plain version of the contraction in ``layout`` ("legacy": [B, H, K] x
    [B, M, K] -> [B, O, K]; "kmajor": [B, K, H] x [B, K, M] -> [B, K, O])."""
    z = _expand(_bok(x, layout), _bok(y, layout))
    out = torch.einsum("bhmk,hmo->bok", z.float(), w.to(x.dtype).float()).to(x.dtype)
    return _bok(out, layout).contiguous()


def cin_dw_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                 layout: str = "legacy") -> torch.Tensor:
    """Plain version of the weight gradient: [H, M, O] fp32."""
    z = _expand(_bok(x, layout), _bok(y, layout))
    return torch.einsum("bhmk,bok->hmo", z.float(), _bok(g, layout).to(x.dtype).float())


def _check_operands(who: str, layout: str, *ts: torch.Tensor) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{who} needs its operands on one CUDA device, got {t.device}")
        if t.dim() != 3 or t.dtype != ts[0].dtype or t.dtype not in (torch.float32,
                                                                      torch.bfloat16):
            raise ValueError(f"{who}: operands must be 3-D float32 or bfloat16 of one dtype, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if max(t.shape) >= 2**31:
            raise ValueError(f"{who}: {tuple(t.shape)} is outside the kernel's extents")
    b, k = ts[0].shape[0], _bok(ts[0], layout).shape[2]
    for t in ts:
        if t.shape[0] != b or _bok(t, layout).shape[2] != k:
            raise ValueError(f"{who}: batch and K must agree, got "
                             f"{[tuple(u.shape) for u in ts]} ({layout})")


def _strides(t: torch.Tensor, layout: str) -> list[int]:
    """(batch, field, k) strides in elements of an operand in ``layout``."""
    return list(_bok(t, layout).stride())


def contraction_smem(h: int, mp: int, nt: int) -> int:
    """Bytes of shared memory the bf16 contraction kernel takes (cin.cu's
    cin_mma_smem): the W slice of 8 nt columns, [8 nt][h * mp + 8] bf16
    rounded up to 128 bytes, and for each of 8 warps two x tiles [h][32] and
    the rounded output tile [8 nt][40], bf16."""
    w_bytes = -(-8 * nt * (h * mp + _W_PAD) * 2 // 128) * 128
    return w_bytes + _WARPS * (2 * h * _ROWS + 8 * nt * _OUT_PITCH) * 2


def contraction_plan(h: int, m: int, o: int) -> tuple[int, int, int] | None:
    """(mp, nt, groups) of the bf16 contraction on mma.sync for w [h, m, o]:
    m padded to mp (32 or 64) inside each h, the o columns in ``groups``
    groups of 8 nt (nt in 1, 2, 4, 8), the widest group whose W slice fits in
    shared memory beside the x tiles; None where m > 64 or no group fits
    (the shape then takes the tile kernel). A function of the shape only."""
    if m > 64 or h < 1 or o < 1:
        return None
    mp = 32 if m <= 32 else 64
    n8 = -(-o // 8)
    nt = 8
    while nt > 1 and nt // 2 >= n8:
        nt //= 2
    while contraction_smem(h, mp, nt) > _SMEM_MAX:
        if nt == 1:
            return None
        nt //= 2
    return mp, nt, -(-n8 // nt)


def pack_weight(w: torch.Tensor, mp: int, nt: int, groups: int) -> torch.Tensor:
    """w [h, m, o] (any strides) -> [groups, 8 nt, h * mp] in w's dtype,
    contiguous: wp[g, c, hh * mp + mm] = w[hh, mm, 8 nt g + c], zero for mm >=
    m and for columns past o (the B operand of the bf16 contraction, one
    group's slice a block)."""
    h, m, o = w.shape
    wp = torch.zeros(groups * 8 * nt, h, mp, dtype=w.dtype, device=w.device)
    wp[:o, :, :m] = w.permute(2, 0, 1)
    return wp.reshape(groups, 8 * nt, h * mp)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to TF32 (10 explicit mantissa bits; the low 13 bits
    of the fp32 pattern zero), to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds; non-finite values pass unchanged."""
    bits = t.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 ``t``: hi = tf32(t), lo = tf32(t - hi), so t = hi +
    lo within 2^-22 |t| (t - hi is exact in fp32)."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def contraction_smem_tf32(mp: int, nt: int) -> int:
    """Bytes of shared memory the fp32 contraction kernel takes (cin.cu's
    cin_tf32_smem): 4 ring stages, each the split W of one h, [8 nt][2 mp +
    16] fp32, and x of the block's 256 rows."""
    return _TF32_STAGES * (8 * nt * (2 * mp + 16) + _WARPS * _ROWS) * 4


def contraction_plan_tf32(h: int, m: int, o: int) -> tuple[int, int, int] | None:
    """(mp, nt, groups) of the fp32 contraction on mma.sync for w [h, m, o]:
    m padded to mp (32 or 64) inside each h, the o columns in ``groups``
    groups of 8 nt (nt in 1, 2, 4, 8: the narrowest that holds all of o up
    to 64); W is streamed by h, so a stage's size does not depend on h and
    every plan fits in shared memory. None where m > 64 (the shape then
    takes the tile kernel). A function of the shape only."""
    if m > 64 or h < 1 or o < 1:
        return None
    n8 = -(-o // 8)
    nt = 8
    while nt > 1 and nt // 2 >= n8:
        nt //= 2
    return (32 if m <= 32 else 64), nt, -(-n8 // nt)


def swap_tf32(h: int, m: int) -> bool:
    """Whether the fp32 contraction takes y as its x and x as its y (w
    permuted to [m, h, o]): x*y rounds the same either way, and the kernel
    pads m, not h, so where both have a plan the order with the fewer padded
    products, h * mp, is taken ((64, 26) runs as (26, 64): 1,664 in place of
    2,048 a row)."""
    def padded(a: int, b: int) -> int:
        return a * (32 if b <= 32 else 64)
    return h <= 64 and m <= 64 and padded(m, h) < padded(h, m)


def pack_weight_tf32(w: torch.Tensor, mp: int, nt: int, groups: int) -> torch.Tensor:
    """fp32 w [h, m, o] (any strides) -> [groups, h, 8 nt, mp / 2, 4] fp32,
    contiguous: for column c of group g and m = 2j, 2j + 1, the last axis
    holds hi(w[h, 2j, o]), hi(w[h, 2j + 1, o]), lo(w[h, 2j, o]), lo(w[h, 2j +
    1, o]) (``split_tf32``; o = 8 nt g + c), zero for m >= M and for columns
    past o (the B operand of the fp32 contraction, one h a ring stage)."""
    h, m, o = w.shape
    wz = torch.zeros(groups * 8 * nt, h, mp, dtype=torch.float32, device=w.device)
    wz[:o, :, :m] = w.permute(2, 0, 1)
    hi, lo = split_tf32(wz)
    pairs = torch.stack([hi.reshape(-1, h, mp // 2, 2), lo.reshape(-1, h, mp // 2, 2)], dim=3)
    return pairs.reshape(groups, 8 * nt, h, mp // 2, 4).transpose(1, 2).contiguous()


def contraction_operand(x: torch.Tensor, layout: str) -> tuple[torch.Tensor, bool]:
    """The bf16 contraction's x as a [B, H, K] tensor, and whether the
    kernel stages it with 16-byte copies: when K is a multiple of 32 (a
    warp's 32 rows then lie in one batch row), after copying x into a
    contiguous tensor if its 8-row runs are not 16 bytes, aligned (the
    model's x0 = looked[..., :K], rows K+1 apart; K-major memory). The copy
    reads and writes x once; otherwise the kernel stages x with element
    loads, in place. y needs no copy: it is loaded into registers once a
    row tile, with element loads. The fp32 kernel stages x by 4-byte
    copies, in place."""
    v = _bok(x, layout)
    if x.dtype != torch.bfloat16 or v.shape[2] % _ROWS:
        return v, False
    return (v if _runs_aligned(v) else v.contiguous()), True


def cin_cuda(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
             layout: str = "legacy") -> torch.Tensor:
    """Launch the contraction kernel: x, y of one dtype (fp32 or bf16) in
    ``layout``, any strides, on one card; w [H, M, O] (cast to x's dtype, and
    packed for the mma.sync kernel of its type where the plan has one: by
    ``pack_weight`` for ``contraction_plan`` in bf16, split and packed by
    ``pack_weight_tf32`` for ``contraction_plan_tf32`` in fp32, x and y in
    the order of ``swap_tf32``; else made contiguous for the tile kernel: it
    is small). Returns a contiguous tensor in x's dtype and ``layout``."""
    _check_operands("cin_cuda", layout, x, y)
    b, h, k = _bok(x, layout).shape
    m = _bok(y, layout).shape[1]
    if w.dim() != 3 or tuple(w.shape[:2]) != (h, m):
        raise ValueError(f"w must be [{h}, {m}, O], got {tuple(w.shape)}")
    o = w.shape[2]
    w2 = w.to(device=x.device, dtype=x.dtype).contiguous()
    shape = (b, o, k) if layout == "legacy" else (b, k, o)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if h * m >= 2**31 or b * k >= 2**31:
        raise ValueError(f"cin_cuda: B*K={b * k} or H*M={h * m} exceeds the kernel's extents")
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and swap_tf32(h, m):
        x, y, w2, h, m = y, x, w2.permute(1, 0, 2), m, h
    plan = contraction_plan(h, m, o) if bf16 else contraction_plan_tf32(h, m, o)
    lib = build.load("cin", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        strides = (*_strides(x, layout), *_strides(y, layout), *_strides(out, layout))
        if plan is not None and not bf16:
            wp = pack_weight_tf32(w2, *plan)
            err = lib.rectpu_cin_tf32(x.data_ptr(), y.data_ptr(), wp.data_ptr(), out.data_ptr(),
                                      b, h, m, o, k, *strides, *plan, stream)
        elif plan is not None:
            wp = pack_weight(w2, *plan)
            xv, copies = contraction_operand(x, layout)
            err = lib.rectpu_cin_mma(xv.data_ptr(), y.data_ptr(), wp.data_ptr(), out.data_ptr(),
                                     b, h, m, o, k, *xv.stride(), *strides[3:], *plan,
                                     int(copies), stream)
        else:
            err = lib.rectpu_cin(x.data_ptr(), y.data_ptr(), w2.data_ptr(), out.data_ptr(),
                                 b, h, m, o, k, *strides, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"cin kernel launch failed: cudaError {err}")
    (launches if bf16 else launches_fp32).add()
    return out


def dw_slices(rows: int) -> tuple[int, int]:
    """(slices, rows per slice) of the dw reduction over ``rows`` = B*K:
    a function of the shape only, so two launches sum in the same order."""
    slices = max(1, min(_DW_MAX_SLICES, -(-rows // _DW_SLICE_ROWS)))
    per = -(-rows // slices)
    return slices, -(-per // 32) * 32


def _runs_aligned(t: torch.Tensor) -> bool:
    """Whether every run of 16 bytes of rows (b, k) of a [B, *, K] operand
    (8 rows in bf16, 4 in fp32) is aligned, so a kernel can stage it with
    16-byte copies."""
    run = 16 // t.element_size()
    sb, sf, sk = t.stride()
    return sk == 1 and sb % run == 0 and sf % run == 0 and t.data_ptr() % 16 == 0


def dw_operands(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                layout: str) -> tuple[list[torch.Tensor], bool]:
    """The weight-gradient kernel's operands as [B, *, K] tensors, and
    whether it stages them with 16-byte copies: when K is a multiple of the
    rows in 16 bytes (8 in bf16, 4 in fp32), after copying each operand whose
    runs are not aligned into a contiguous tensor (the model's y =
    looked[..., :K], rows K+1 apart; a K-major operand), once for an operand
    passed twice (x = y = x0 in the first layer). The copy reads and writes
    the operand once; element copies inside the kernel stall its tensor
    cores. Otherwise the kernel stages every operand with element copies, in
    place."""
    views = [_bok(t, layout) for t in (x, y, g)]
    if views[0].shape[2] % (16 // x.element_size()):
        return views, False
    out: list[torch.Tensor] = []
    for v in views:
        if not _runs_aligned(v):
            key = (v.data_ptr(), v.shape, v.stride())
            done = [o for w, o in zip(views, out) if (w.data_ptr(), w.shape, w.stride()) == key]
            v = done[0] if done else v.contiguous()
        out.append(v)
    return out, True


def cin_dw_cuda(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                layout: str = "legacy") -> torch.Tensor:
    """Launch the weight-gradient kernel: x [B, H, K], y [B, M, K], g [B, O, K]
    (or the K-major forms), one dtype, any strides, on one card -> dw [H, M, O]
    fp32, bitwise equal across launches."""
    _check_operands("cin_dw_cuda", layout, x, y, g)
    b, h, k = _bok(x, layout).shape
    m = _bok(y, layout).shape[1]
    o = _bok(g, layout).shape[1]
    dw = torch.empty(h, m, o, dtype=torch.float32, device=x.device)
    if dw.numel() == 0:
        return dw
    if b * k == 0:
        return dw.zero_()
    if h * m * o >= 2**31 or b * k >= 2**31:
        raise ValueError(f"cin_dw_cuda: [{h}, {m}, {o}] or B*K={b * k} exceeds the kernel's "
                         "extents")
    slices, per = dw_slices(b * k)
    partial = torch.empty(slices, o, h * m, dtype=torch.float32, device=x.device)
    (xb, yb, gb), copies = dw_operands(x, y, g, layout)
    bf16 = x.dtype == torch.bfloat16
    lib = build.load("cin", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rectpu_cin_dw(xb.data_ptr(), yb.data_ptr(), gb.data_ptr(), partial.data_ptr(),
                                dw.data_ptr(), b, h, m, o, k, *xb.stride(), *yb.stride(),
                                *gb.stride(), slices, per, int(copies), int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"cin dw kernel launch failed: cudaError {err}")
    (dw_launches if bf16 else dw_launches_fp32).add()
    return dw


def _contract(x, y, w, layout):
    if x.device.type == "cpu":
        return cin_plain(x, y, w, layout)
    return cin_cuda(x, y, w, layout)


def _weight_grad(x, y, g, layout):
    if x.device.type == "cpu":
        return cin_dw_plain(x, y, g, layout)
    return cin_dw_cuda(x, y, g, layout)


@torch.library.custom_op("rectpu_torch::cin", mutates_args=())
def cin_op(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, layout: str) -> torch.Tensor:
    """The contraction as a registered op, for serialized programs: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    return _contract(x, y, w, layout)


@cin_op.register_fake
def _(x, y, w, layout):
    b, o = x.shape[0], w.shape[2]
    shape = (b, o, x.shape[2]) if layout == "legacy" else (b, x.shape[1], o)
    return x.new_empty(shape)


def _core(x, y, w, layout):
    if torch.compiler.is_exporting():
        return cin_op(x, y, w, layout)
    return _CinCore.apply(x, y, w, layout)


class _CinCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, w, layout):
        ctx.save_for_backward(x, y, w)
        ctx.layout = layout
        return _contract(x, y, w, layout)

    @staticmethod
    def backward(ctx, g):
        x, y, w = ctx.saved_tensors
        layout = ctx.layout
        g = g.to(x.dtype)
        dx = dy = dw = None
        if ctx.needs_input_grad[0]:
            dx = _contract(g, y, w.permute(2, 1, 0), layout)
        if ctx.needs_input_grad[1]:
            dy = _contract(g, x, w.permute(2, 0, 1), layout).to(y.dtype)
        if ctx.needs_input_grad[2]:
            dw = _weight_grad(x, y, g, layout).to(w.dtype)
        return dx, dy, dw, None


def cin_core(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b,o,k] = sum_{h,m} w[h,m,o] x[b,h,k] y[b,m,k], differentiable:
    x [B, H, K], y [B, M, K], w [H, M, O] -> [B, O, K] in x's dtype."""
    return _core(x, y, w, "legacy")


def cin_core_kmajor(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in K-major layout: x [B, K, H], y [B, K, M], w
    [H, M, O] -> [B, K, O], differentiable."""
    return _core(x, y, w, "kmajor")
