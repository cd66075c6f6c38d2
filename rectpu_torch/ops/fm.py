"""Factorization-machine interaction: the port of ``rectpu/ops/fm.py``.

    fm[b] = 0.5 * sum_k((sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2)
    dv[b, f, k] = g[b] * (S[b,k] - v[b,f,k]),   S = sum_f v

rectpu's ``fm_impl`` values ("auto", "xla", "pallas", "matmul") and its
lane-packed ``fm_cross_flat`` are TPU choices; in the port each one runs this
module's ``fm_cross``, a ``torch.autograd.Function``:

  - on CUDA tensors, the hand-written kernels of ``kernels/csrc/fm.cu``: the
    forward (the port of the Pallas ``_fm_fwd_kernel``,
    ``rectpu/ops/fm.py:271``) and the backward (``_fm_bwd_kernel``, :281);
  - on CPU tensors, their plain versions ``fm_cross_xla`` and
    ``fm_cross_bwd_xla``.

Both follow the Pallas kernels' contract: fp32 sums and fp32 backward math;
the forward's result in v's type unless ``out_dtype`` asks for fp32, and the
backward's in v's type. (For fp32 input that is also rectpu's XLA form; for
bf16 input rectpu's XLA form rounds its intermediates to bf16 and the Pallas
kernels do not.) ``out_dtype=torch.float32`` on bf16 input is the flat
layout's FM logit (``fm_cross_flat``, :108-114), which is not rounded to
bf16. The order-3 term ``fm_cross3_xla`` has no Pallas kernel in rectpu and
stays plain PyTorch, differentiated by autograd.
"""

from __future__ import annotations

import ctypes

import torch

from rectpu_torch.kernels import LaunchCount, build

IMPLS = ("auto", "xla", "pallas", "matmul")

launches = LaunchCount("fm_cross")
bwd_launches = LaunchCount("fm_cross_bwd")

_SIGNATURES = {
    "rectpu_fm_cross": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
    "rectpu_fm_cross_bwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
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
    """Launch the FM forward kernel on v [B, F, K], fp32 or bf16, on a CUDA
    device; the result in v's dtype or fp32.

    v may be a strided view (``looked[..., :K]`` of the fused gather): the
    batch and field strides go to the kernel, and only the innermost stride
    must be 1. Raises on anything the kernel does not take."""
    _check_v(v, "fm_cross_cuda")
    out_dtype = _out_dtype(v, out_dtype)
    b, f, k = v.shape
    out = torch.empty(b, dtype=out_dtype, device=v.device)
    if b == 0:
        return out
    lib = build.load("fm", _SIGNATURES)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.rectpu_fm_cross(v.data_ptr(), out.data_ptr(), b, f, k, v.stride(0),
                                  v.stride(1), _lanes_per_row(k),
                                  int(v.dtype == torch.bfloat16),
                                  int(out_dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"fm_cross kernel launch failed: cudaError {err}")
    launches.add()
    return out


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
    lib = build.load("fm", _SIGNATURES)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.rectpu_fm_cross_bwd(v.data_ptr(), g32.data_ptr(), dv.data_ptr(), b, f, k,
                                      v.stride(0), v.stride(1), _lanes_per_row(k),
                                      int(v.dtype == torch.bfloat16), stream)
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


def fm_cross(v: torch.Tensor, impl: str = "auto",
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """FM second-order logit from field embeddings v [B, F, K] -> [B] in v's
    dtype (or ``out_dtype=torch.float32``), differentiable in v. ``impl`` is
    the recorded ``fm_impl``; every value runs the same function."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fm_impl {impl!r} (expected one of {IMPLS})")
    return _FmCross.apply(v, out_dtype)
