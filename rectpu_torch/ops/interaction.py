"""Pairwise-dot feature interactions (the DLRM block): the port of
``rectpu/ops/interaction.py``.

    out[b, p] = sum_k v[b, i_p, k] * v[b, j_p, k],   v = flat[b].reshape(n, K)

over the upper triangle of the n x n dot matrix in ``np.triu_indices`` order,
the diagonal included only when ``itself``; [B, n*K] in, [B, P] fp32 out.

``interact_flat`` is a ``torch.autograd.Function`` whose forward is:

  - on CUDA tensors, the hand-written kernel of ``kernels/csrc/interaction.cu``,
    the port of the Pallas ``_fwd_kernel`` (:55, exact products) and
    ``_fwd_kernel_mxu`` (:77, each product rounded to the input's type before
    the fp32 sum), one kernel with a ``round_products`` flag, whose launch
    plan (``plan``: the compute path, the padded tile a row is staged in,
    the rows a group) and its units of work (``units``) are built here, once
    per shape, where the CPU tests can hold them;
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

``interact_op`` (``rectpu_torch::interact``) registers the forward as a
``torch.library`` op with a fake shape, which ``interact`` and
``interact_flat`` call only while ``torch.export`` traces: a serialized
serving program (``serve/export.py``) records it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

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
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_TABLES: dict = {}

# the kernel's shared memory: one block's limit on the H100, and the share a
# group of rows may take so that two blocks fit an SM
_SMEM_LIMIT = 227 * 1024
_GROUP_SMEM = 110 * 1024
_MAX_GROUP_ROWS = 8
# compute path -> (rows, columns) of the dot-matrix tiles it walks, and the
# tiles of one row of tiles that a unit of work takes, from its first
UNIT = {"gram": (16, 8, 4), "ones": (4, 4, 4), "tile": (4, 4, 1)}


@dataclass(frozen=True)
class Plan:
    """How the kernel walks one call (``kernels/csrc/interaction.cu``): the
    compute path, the padded tile a batch row is staged in, the rows a group
    and the shared memory it takes."""

    path: str  # "gram" (bf16 exact), "ones" (bf16 rounded) or "tile" (fp32)
    n_pad: int  # n rounded up to 16
    k_pad: int  # K rounded up to 16
    ld: int  # elements from one staged vector to the next: k_pad and a pad (see plan)
    rs: int  # elements from one staged batch row to the next: n_pad * ld + 16 bytes
    rows: int  # batch rows a group
    n_items: int  # units of work a batch row
    smem: int  # bytes: two group buffers and the group's outputs


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


def tiles(n: int, itself: bool, ti: int, tj: int) -> list[tuple[int, int]]:
    """Origins (i0, j0) of the ti x tj tiles of the dot matrix, padded to a
    multiple of 16, that hold at least one pair: the rest lie wholly below
    the diagonal or past n, and the kernel skips them."""
    n_pad = -(-n // 16) * 16
    out = []
    for i0 in range(0, n_pad, ti):
        for j0 in range(0, n_pad, tj):
            i_lo, j_hi = i0, min(j0 + tj, n) - 1
            if i_lo < n and j0 < n and (j_hi >= i_lo if itself else j_hi > i_lo):
                out.append((i0, j0))
    return out


def units(n: int, itself: bool, path: str) -> list[tuple[int, int, int]]:
    """The path's units of work, (i0, j0, tiles): in every row of tiles, the
    tiles that hold a pair (they run from the diagonal to the last tile left
    of n) in runs of up to ``UNIT[path][2]``, each from its first tile."""
    ti, tj, per = UNIT[path]
    by_row: dict[int, list[int]] = {}
    for i0, j0 in tiles(n, itself, ti, tj):
        by_row.setdefault(i0, []).append(j0)
    return [(i0, row[s], len(row[s:s + per])) for i0, row in by_row.items()
            for s in range(0, len(row), per)]


@functools.lru_cache(maxsize=None)
def plan(n: int, k: int, itself: bool, dtype: torch.dtype, round_products: bool) -> Plan:
    """The kernel's launch plan for [B, n*K] in ``dtype``; raises a
    ValueError when one batch row's staging does not fit a block's shared
    memory (at K=64 with the diagonal: n > 272 bf16 exact, 256 bf16 rounded,
    225 fp32)."""
    es = 2 if dtype == torch.bfloat16 else 4
    if es == 4:
        path = "tile"
    else:
        path = "ones" if round_products else "gram"
    n_pad, k_pad = -(-n // 16) * 16, -(-k // 16) * 16
    # vectors 16 bytes apart modulo 32 (ldmatrix reads 8 of them without a
    # bank conflict), on the ones path 64 modulo 128 (a quarter warp's 16-byte
    # loads of 2 neighbouring vectors then fill one 128-byte wavefront); batch
    # rows 16 modulo 128 (the tile path's 8 neighbouring threads read 8 rows)
    ld_bytes = k_pad * es + (((64 - k_pad * es) % 128) if path == "ones" else 16)
    ld = ld_bytes // es
    rs = n_pad * ld + 16 // es
    p = num_pairs(n, itself)
    per_row = 2 * rs * es + 4 * p
    if per_row > _SMEM_LIMIT:
        raise ValueError(f"interaction kernel: n={n}, K={k} in {dtype} needs {per_row} bytes "
                         f"of shared memory a row (two staged [{n_pad}, {ld}] tiles and {p} "
                         f"fp32 outputs), beyond the {_SMEM_LIMIT}-byte limit of one block")
    rows = max(1, min(_MAX_GROUP_ROWS, _GROUP_SMEM // per_row))
    return Plan(path, n_pad, k_pad, ld, rs, rows, len(units(n, itself, path)), rows * per_row)


def _table(kind: str, n: int, itself: bool, device) -> torch.Tensor:
    """A constant index table on ``device``, built once per (kind, n,
    itself, device), so that a call copies nothing from the host (a pageable
    copy would wait for the stream): "gram", "ones" and "tile" pack their
    paths' units (i0 << 16 | j0 << 3 | tiles), and "inverse" maps each
    flat [n*n] position to its pair column (both triangles; P = zero slot)
    for the backward."""
    key = (kind, n, itself, str(device))
    table = _TABLES.get(key)
    if table is None:
        iu, ju = pairs(n, itself)
        if kind in UNIT:
            arr = np.array([i0 << 16 | j0 << 3 | t for i0, j0, t in units(n, itself, kind)],
                           dtype=np.int32)
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
    pl = plan(n, k, itself, flat.dtype, round_products)
    out = torch.empty(flat.shape[0], p, dtype=torch.float32, device=flat.device)
    if out.numel() == 0:
        return out
    table = _table(pl.path, n, itself, flat.device)
    lib = build.load("interaction", _SIGNATURES)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.rectpu_interact(flat.data_ptr(), table.data_ptr(), out.data_ptr(),
                                  flat.shape[0], n, k, p, int(itself), pl.n_pad, pl.k_pad,
                                  pl.ld, pl.rs, pl.rows, pl.n_items,
                                  ("gram", "ones", "tile").index(pl.path),
                                  int(flat.dtype == torch.bfloat16), int(round_products),
                                  pl.smem, stream)
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


@torch.library.custom_op("rectpu_torch::interact", mutates_args=())
def interact_op(flat: torch.Tensor, n: int, k: int, itself: bool,
                round_products: bool) -> torch.Tensor:
    """The pair-dot forward as a registered op, for serialized programs: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if flat.device.type == "cpu":
        return interact_plain(flat, n, k, itself, round_products)
    return interact_cuda(flat.contiguous(), n, k, itself, round_products)


@interact_op.register_fake
def _(flat, n, k, itself, round_products):
    return flat.new_empty((flat.shape[0], num_pairs(n, itself)), dtype=torch.float32)


def _interact(flat: torch.Tensor, n: int, k: int, itself: bool, rounded: bool) -> torch.Tensor:
    if torch.compiler.is_exporting():
        return interact_op(flat, n, k, itself, rounded)
    return _Interact.apply(flat, n, k, itself, rounded)


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
    return _interact(flat.contiguous(), num_fields, k, itself, rounded)


def interact(vectors: torch.Tensor, itself: bool = False) -> torch.Tensor:
    """The 3D form: vectors [B, n, K] -> [B, P] fp32 with exact products
    (rectpu's einsum ``DLRMModel._interact``), through the same kernel."""
    b, n, k = vectors.shape
    return _interact(vectors.reshape(b, n * k).contiguous(), n, k, itself, False)
