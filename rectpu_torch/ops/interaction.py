"""Pairwise-dot feature interactions (the DLRM block): the port of
``rectpu/ops/interaction.py``.

    out[b, p] = sum_k v[b, i_p, k] * v[b, j_p, k],   v = flat[b].reshape(n, K)

over the upper triangle of the n x n dot matrix in ``np.triu_indices`` order,
the diagonal included only when ``itself``; [B, n*K] in, [B, P] fp32 out.

``interact_flat`` is a ``torch.autograd.Function`` whose forward is:

  - on CUDA tensors, the hand-written kernel of ``kernels/csrc/interaction.cu``,
    the port of the Pallas ``_fwd_kernel`` (:55, exact products) and
    ``_fwd_kernel_mxu`` (:77, each product rounded to the input's type before
    the fp32 sum), one kernel with a ``round_products`` flag;
  - on CPU tensors, its plain version ``interact_plain``.

Its backward is rectpu's ``_interact_bwd_xla`` (:111-146): g cast to the input
dtype, the symmetric pair-cotangent matrix C gathered from it (the diagonal
doubled when ``itself``), then one batched product dE_b = C_b E_b with fp32
accumulation, cast to the input dtype. rectpu left that product to XLA; here
it is ``torch.bmm``.

``impl`` takes rectpu's names, and on a CUDA tensor every one of them
launches the kernel. "auto" resolves through the pin ``_INTERACT_AUTO``,
keyed by device type, which the autotuner sets (``set_interact_auto_impl``,
rectpu :238-243). Its default is rectpu's accelerator pin "pallas-mxu",
rounded products, on both devices, so the CPU runs the card's function;
"pallas" computes exact products, and so do "xla" and "xla-autodiff", whose
rectpu forms (a batched matmul forming the full z, :246-269) compute the same
exact-product function. The 3D form of the model (``interact``, rectpu's
``DLRMModel._interact``: the einsum with exact products) runs the kernel with
exact products.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rectpu_torch.device import device_key
from rectpu_torch.kernels import LaunchCount, build

IMPLS = ("auto", "xla", "pallas", "pallas-mxu", "xla-autodiff")

launches = LaunchCount("interaction")

# what "auto" resolves to, keyed "cuda" / "cpu" (rectpu: "tpu" / "other")
_INTERACT_AUTO = {"cuda": "pallas-mxu", "cpu": "pallas-mxu"}

_SIGNATURES = {
    "rectpu_interact": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_TABLES: dict = {}


def pairs(n: int, itself: bool) -> tuple[np.ndarray, np.ndarray]:
    """(i, j) of the upper triangle in the DLRM gather order (row-major)."""
    return np.triu_indices(n, k=0 if itself else 1)


def num_pairs(n: int, itself: bool) -> int:
    return n * (n - 1) // 2 + (n if itself else 0)


def _split(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    if flat.dim() != 2 or flat.shape[1] != n * k:
        raise ValueError(f"flat must be [B, {n}*{k}], got {tuple(flat.shape)}")
    return flat.reshape(flat.shape[0], n, k)


def interact_plain(flat: torch.Tensor, n: int, k: int, itself: bool = False,
                   round_products: bool = False) -> torch.Tensor:
    """Plain version of the kernel: each pair's K products in fp32 (rounded
    to flat's dtype when ``round_products``), summed in fp32 -> [B, P]."""
    v = _split(flat, n, k)
    iu, ju = pairs(n, itself)
    prod = v[:, iu, :].float() * v[:, ju, :].float()
    if round_products:
        prod = prod.to(flat.dtype).float()
    return prod.sum(dim=-1)


def _table(kind: str, n: int, itself: bool, device) -> torch.Tensor:
    """A constant index table on ``device``, built once per (kind, n,
    itself, device), so that a call copies nothing from the host (a pageable
    copy would wait for the stream): "pairs" packs (i << 16 | j) for the
    kernel, "inverse" maps each flat [n*n] position to its pair column (both
    triangles; P = zero slot)."""
    key = (kind, n, itself, str(device))
    table = _TABLES.get(key)
    if table is None:
        iu, ju = pairs(n, itself)
        if kind == "pairs":
            arr = (iu << 16 | ju).astype(np.int32)
        else:
            arr = np.full(n * n, len(iu), dtype=np.int64)
            arr[iu * n + ju] = np.arange(len(iu))
            arr[ju * n + iu] = np.arange(len(iu))  # symmetric: C[j, i] = C[i, j]
        table = _TABLES[key] = torch.from_numpy(arr).to(device)
    return table


def interact_bwd(flat: torch.Tensor, g: torch.Tensor, n: int, k: int,
                 itself: bool) -> torch.Tensor:
    """rectpu's ``_interact_bwd_xla``: dflat = (C_b E_b) in flat's dtype."""
    b = flat.shape[0]
    g = g.to(flat.dtype)
    gz = torch.cat([g, torch.zeros(b, 1, dtype=g.dtype, device=g.device)], dim=1)
    c = gz[:, _table("inverse", n, itself, g.device)].reshape(b, n, n)
    if itself:
        eye = torch.eye(n, dtype=c.dtype, device=c.device)
        c = c + c * eye  # d(e.e)/de = 2e: the diagonal counts twice
    dv = torch.bmm(c.float(), _split(flat, n, k).float())
    return dv.to(flat.dtype).reshape(b, n * k)


def interact_cuda(flat: torch.Tensor, n: int, k: int, itself: bool = False,
                  round_products: bool = False) -> torch.Tensor:
    """Launch the pair-dot kernel on flat [B, n*K], fp32 or bf16, contiguous,
    on a CUDA device -> [B, P] fp32. Raises on anything the kernel does not
    take."""
    if not flat.is_cuda:
        raise ValueError(f"interact_cuda needs a CUDA tensor, got {flat.device}")
    if flat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flat must be float32 or bfloat16, got {flat.dtype}")
    _split(flat, n, k)
    if not flat.is_contiguous():
        raise ValueError(f"interact_cuda needs a contiguous flat, got strides {flat.stride()}")
    if n > 0xFFFF or flat.shape[0] >= 2**31 or flat.numel() >= 2**62:
        raise ValueError(f"flat {tuple(flat.shape)} is outside the kernel's extents")
    p = num_pairs(n, itself)
    out = torch.empty(flat.shape[0], p, dtype=torch.float32, device=flat.device)
    if out.numel() == 0:
        return out
    table = _table("pairs", n, itself, flat.device)
    lib = build.load("interaction", _SIGNATURES)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.rectpu_interact(flat.data_ptr(), table.data_ptr(), out.data_ptr(),
                                  flat.shape[0], n, k, p, int(flat.dtype == torch.bfloat16),
                                  int(round_products), stream)
    if err != 0:
        raise RuntimeError(f"interaction kernel launch failed: cudaError {err}")
    launches.add()
    return out


class _Interact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, n, k, itself, round_products):
        ctx.save_for_backward(flat)
        ctx.meta = (n, k, itself)
        if flat.device.type == "cpu":
            return interact_plain(flat, n, k, itself, round_products)
        return interact_cuda(flat, n, k, itself, round_products)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        n, k, itself = ctx.meta
        return interact_bwd(flat, g, n, k, itself), None, None, None, None


def set_interact_auto_impl(name: str, device_type: str = "cuda") -> None:
    """Pin what "auto" resolves to (the autotuner's pick)."""
    if name not in ("xla", "pallas", "pallas-mxu"):
        raise ValueError(f"interaction impl must be 'xla', 'pallas' or 'pallas-mxu', got "
                         f"{name!r}")
    _INTERACT_AUTO[device_key(device_type)] = name


def interact_flat(flat: torch.Tensor, num_fields: int, k: int, itself: bool = False,
                  impl: str = "auto") -> torch.Tensor:
    """Pairwise-dot interactions from the flat [B, n*K] activation -> [B, P]
    fp32, differentiable in ``flat`` (see the module docstring for ``impl``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown interaction_impl {impl!r} (expected one of {IMPLS})")
    if impl == "auto":
        impl = _INTERACT_AUTO[device_key(flat)]
    rounded = impl == "pallas-mxu"
    return _Interact.apply(flat.contiguous(), num_fields, k, itself, rounded)


def interact(vectors: torch.Tensor, itself: bool = False) -> torch.Tensor:
    """The 3D form: vectors [B, n, K] -> [B, P] fp32 with exact products
    (rectpu's einsum ``DLRMModel._interact``), through the same kernel."""
    b, n, k = vectors.shape
    return _Interact.apply(vectors.reshape(b, n * k).contiguous(), n, k, itself, False)
