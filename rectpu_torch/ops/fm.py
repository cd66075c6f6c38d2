"""Factorization-machine interaction: the port of ``rectpu/ops/fm.py``'s forward.

    fm[b] = 0.5 * sum_k((sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2)

rectpu's ``fm_impl`` values ("auto", "xla", "pallas", "matmul") are TPU
choices; in the port each one runs this module's ``fm_cross``:

  - on a CUDA tensor, the hand-written kernel (``kernels/csrc/fm.cu``, the
    port of the Pallas ``_fm_fwd_kernel`` at ``rectpu/ops/fm.py:271``);
  - on a CPU tensor, its plain PyTorch version ``fm_cross_xla``.

Both follow the Pallas kernel's contract: fp32 sums, result in v's type. (For
fp32 input that is also rectpu's XLA form; for bf16 input rectpu's XLA form
rounds its intermediates to bf16 and the Pallas kernel does not.) The order-3
term ``fm_cross3_xla`` has no Pallas kernel in rectpu and stays plain here.
The backward kernel comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from rectpu_torch.kernels import LaunchCount, build

IMPLS = ("auto", "xla", "pallas", "matmul")

launches = LaunchCount("fm_cross")

_SIGNATURES = {
    "rectpu_fm_cross": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def fm_cross_xla(v: torch.Tensor) -> torch.Tensor:
    """Plain version: v [B, F, K] -> [B] in v's dtype, sums in fp32."""
    v32 = v.float()
    s = v32.sum(dim=1)
    square_sum = (v32 * v32).sum(dim=1)
    return (0.5 * (s * s - square_sum).sum(dim=-1)).to(v.dtype)


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
    """Lanes that share one batch row in the kernel: K rounded up to a power
    of two, at most a warp."""
    g = 1
    while g < min(k, 32):
        g *= 2
    return g


def fm_cross_cuda(v: torch.Tensor) -> torch.Tensor:
    """Launch the FM kernel on v [B, F, K], fp32 or bf16, on a CUDA device.

    v may be a strided view (``looked[..., :K]`` of the fused gather): the
    batch and field strides go to the kernel, and only the innermost stride
    must be 1. Raises on anything the kernel does not take."""
    if not v.is_cuda:
        raise ValueError(f"fm_cross_cuda needs a CUDA tensor, got {v.device}")
    if v.dim() != 3 or v.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"v must be [B, F, K] float32 or bfloat16, got "
                         f"{tuple(v.shape)} {v.dtype}")
    b, f, k = v.shape
    if k > 1 and v.stride(2) != 1:
        raise ValueError(f"v's innermost stride must be 1, got strides {v.stride()}")
    if max(b, f, k) >= 2**31:
        raise ValueError(f"v of shape {tuple(v.shape)} strides {v.stride()} is outside "
                         "the kernel's extents")
    out = torch.empty(b, dtype=v.dtype, device=v.device)
    if b == 0:
        return out
    lib = build.load("fm", _SIGNATURES)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.rectpu_fm_cross(v.data_ptr(), out.data_ptr(), b, f, k, v.stride(0),
                                  v.stride(1), _lanes_per_row(k),
                                  int(v.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fm_cross kernel launch failed: cudaError {err}")
    launches.add()
    return out


def fm_cross(v: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """FM second-order logit from field embeddings v [B, F, K] -> [B] in v's
    dtype. ``impl`` is the export's recorded ``fm_impl``; every value runs the
    same function."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fm_impl {impl!r} (expected one of {IMPLS})")
    if v.device.type == "cpu":
        return fm_cross_xla(v)
    return fm_cross_cuda(v)
