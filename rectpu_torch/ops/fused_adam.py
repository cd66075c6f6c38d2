"""One Adam sweep over a [V, W] table: the port of ``rectpu/ops/fused_adam.py``.

``fused_adam_table(p, m, v, g, t, lr=...)`` computes exactly the tree-map
update of ``optimizers.adam`` for one leaf (``rectpu/train/optimizers.py:192-224``):
TF's eps placement outside the bias-corrected square root, fp32 math, the
slots stored first and the parameter step taken from the stored (down-cast)
slots, stochastic rounding keyed on the flat index ``row*W + col`` and
seeded with ``t`` (a bf16 parameter with ``t + 2**30``). A table shard
(``index``, a ``utils.hash32.GlobalIndex`` of its rows) keys each element on
its index in the global table, as rectpu's update of the sharded table does
(its ``iota`` runs over the global array).

``t`` and ``lr_t`` (default: ``adam_lr_t`` of ``t``) are host numbers or 0-d
tensors on the parameters' device (int64 ``t``, fp32 ``lr_t``): a step
captured in a CUDA graph reads them from device memory, and both forms give
the same bits.

  - On CUDA tensors: the hand-written kernel ``kernels/csrc/fused_adam.cu``
    (the port of ``_adam_tile_kernel``, ``rectpu/ops/fused_adam.py:51``),
    which updates p, m and v IN PLACE (rectpu aliases them too,
    ``input_output_aliases``) and returns them.
  - On CPU tensors: the plain version ``fused_adam_plain``, which returns new
    tensors.

The two agree bit for bit: the kernel rounds every operation separately, as
the plain version's elementwise ops do (see the note in the source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rectpu_torch.kernels import LaunchCount, build
from rectpu_torch.utils.hash32 import MASK32, GlobalIndex, counter_hash, global_index

launches = LaunchCount("fused_adam")

_F32, _BF16, _BF16_SR = 0, 1, 2
_SIGNATURES = {
    "rectpu_fused_adam": (
        [ctypes.c_void_p] * 4
        + [ctypes.c_longlong] + [ctypes.c_float] * 6
        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_DTYPES = (torch.float32, torch.bfloat16)


def stochastic_round_bf16(x: torch.Tensor, seed, index: GlobalIndex | None = None
                          ) -> torch.Tensor:
    """Unbiased fp32 -> bf16 downcast, bit for bit rectpu's
    (``optimizers.stochastic_round_bf16``, :47, and ``_sr_bits`` here, :37):
    the low 16 bits of the counter hash of (flat element index, seed mod
    2**32) are added to the fp32 bit pattern, which is then truncated.
    ``seed``: a Python int or a 0-d int64 tensor on x's device. ``index``:
    where x sits in the global array it is a shard of (``GlobalIndex``), so
    that each element keys on its global flat index; None for a whole array."""
    if x.dtype != torch.float32:
        raise ValueError(f"stochastic rounding takes float32, got {x.dtype}")
    xi = x.contiguous().view(torch.int32).to(torch.int64) & MASK32
    h = counter_hash(global_index(x.shape, x.device, index), seed)
    xi = (xi + (h & 0xFFFF)) & 0xFFFF0000
    rounded = torch.where(xi >= 2**31, xi - 2**32, xi).to(torch.int32).view(torch.float32)
    return rounded.to(torch.bfloat16)


def adam_lr_t(t: int, lr: float, beta1: float, beta2: float) -> torch.Tensor:
    """lr_t = lr*sqrt(1-b2^t)/(1-b1^t) in fp32 tensor math, as
    ``rectpu/train/optimizers.py:193-194`` computes it; on the CPU, so the
    kernel, the plain version and the tree-map update share one value."""
    tf_ = torch.tensor(float(t), dtype=torch.float32)
    return lr * torch.sqrt(1.0 - beta2 ** tf_) / (1.0 - beta1 ** tf_)


LR_T_CHUNK = 15  # below twice any CPU vector width of fp32 (8 or 16 lanes)


def adam_lr_t_values(ts, lr: float, beta1: float, beta2: float) -> list:
    """``adam_lr_t`` of every t of ``ts`` as Python floats, bit for bit, in
    a few tensor ops: the values go through the same ops in vectors of at
    most LR_T_CHUNK, which PyTorch's CPU elementwise kernels run on their
    scalar path (the one a 0-d tensor takes) below twice the vector width;
    a longer vector would take the vector ``pow``, whose last bit differs."""
    b1, b2, one = _fp32_constants(beta1, beta2, 1.0)
    out = []
    for i in range(0, len(ts), LR_T_CHUNK):
        tf_ = torch.tensor([float(t) for t in ts[i:i + LR_T_CHUNK]], dtype=torch.float32)
        out += (lr * torch.sqrt(one - b2 ** tf_) / (one - b1 ** tf_)).tolist()
    return out


@functools.lru_cache(maxsize=64)
def _fp32_constants(*values: float) -> tuple:
    """0-d fp32 tensors of ``values``: the operands ``adam_lr_t``'s Python
    floats become, made once (fewer host ops a loop)."""
    return tuple(torch.tensor(v, dtype=torch.float32) for v in values)


def _store(x: torch.Tensor, dtype: torch.dtype, sr: bool, seed: int, index) -> torch.Tensor:
    if sr:
        return stochastic_round_bf16(x, seed, index)
    return x.to(dtype)


def _lr_t(t, lr_t, lr: float, beta1: float, beta2: float):
    if lr_t is not None:
        return lr_t
    if isinstance(t, torch.Tensor):
        raise ValueError("a tensor t needs its lr_t (adam_lr_t on the host)")
    return float(adam_lr_t(t, lr, beta1, beta2))  # exactly its fp32 value


def fused_adam_plain(p, m, v, g, t, *, lr: float, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8, m_sr: bool = False,
                     v_sr: bool = False, lr_t=None, index: GlobalIndex | None = None):
    """Plain version: returns new (p', m', v') in p's, m's and v's dtypes."""
    lr_t = _lr_t(t, lr_t, lr, beta1, beta2)
    g32 = g.float()
    m_new = _store(beta1 * m.float() + (1.0 - beta1) * g32, m.dtype, m_sr, t, index)
    v_new = _store(beta2 * v.float() + (1.0 - beta2) * g32 * g32, v.dtype, v_sr, t, index)
    p32 = p.float() - lr_t * m_new.float() / (torch.sqrt(v_new.float()) + eps)
    p_new = _store(p32, p.dtype, p.dtype == torch.bfloat16, (t + (1 << 30)) & MASK32, index)
    return p_new, m_new, v_new


def index_base(shape, index: GlobalIndex | None) -> int:
    """The kernel's index base: the global flat index (mod 2**32) of element
    0 of a row shard, whose elements then follow in order; 0 for a whole
    array. A shard cut by columns has no such base and raises."""
    if index is None:
        return 0
    cols = 1
    for d in tuple(shape)[1:]:
        cols *= int(d)
    if index.col0 != 0 or index.width != cols:
        raise ValueError(f"the fused Adam kernel keys a row shard on its first row; got {index} "
                         f"for a local width of {cols}")
    return (int(index.row0) * cols) & MASK32


def _device_scalar(x, dtype: torch.dtype, device, name: str) -> int:
    """The address of a 0-d ``dtype`` tensor on ``device`` (0 for a host number)."""
    if not isinstance(x, torch.Tensor):
        return 0
    if x.dim() != 0 or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name} must be a 0-d {dtype} tensor on {device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return x.data_ptr()


def fused_adam_cuda(p, m, v, g, t, *, lr: float, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8, m_sr: bool = False,
                    v_sr: bool = False, lr_t=None, index: GlobalIndex | None = None):
    """Launch the fused Adam kernel, updating p, m and v in place: [V, W]
    tensors, contiguous, fp32 or bf16, on one card. ``t`` / ``lr_t``: host
    numbers, or 0-d int64 / fp32 tensors on the card that the kernel reads.
    ``index``: the rows of the global table this shard holds (``index_base``).
    Returns (p, m, v)."""
    tensors = (p, m, v, g)
    if not all(x.is_cuda and x.device == p.device for x in tensors):
        raise ValueError("fused_adam_cuda needs p, m, v and g on one CUDA device")
    if any(x.dtype not in _DTYPES for x in tensors):
        raise ValueError(f"p, m, v, g must be float32 or bfloat16, got "
                         f"{[x.dtype for x in tensors]}")
    if any(x.shape != p.shape for x in tensors) or not all(x.is_contiguous() for x in tensors):
        raise ValueError("fused_adam_cuda needs contiguous p, m, v and g of one shape")
    if (m_sr and m.dtype != torch.bfloat16) or (v_sr and v.dtype != torch.bfloat16):
        raise ValueError("stochastic rounding stores a bfloat16 slot")
    base = index_base(p.shape, index)
    lr_t = _lr_t(t, lr_t, lr, beta1, beta2)
    t_dev = _device_scalar(t, torch.int64, p.device, "t")
    lr_dev = _device_scalar(lr_t, torch.float32, p.device, "lr_t")

    def kind(x, sr):
        return _F32 if x.dtype == torch.float32 else (_BF16_SR if sr else _BF16)

    lib = build.load("fused_adam", _SIGNATURES)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.rectpu_fused_adam(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), p.numel(),
            0.0 if lr_dev else lr_t, beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
            0 if t_dev else t & MASK32, base, lr_dev or None, t_dev or None,
            kind(p, True), kind(m, m_sr), kind(v, v_sr), int(g.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: cudaError {err}")
    launches.add()
    return p, m, v


def fused_adam_table(p, m, v, g, t, **kwargs):
    """Adam step for a [V, W] table; ``t`` is the step counter after its
    increment (and ``lr_t``, when given, its rate). CPU tensors take the
    plain version (new tensors), CUDA tensors the kernel (in place)."""
    if all(x.device.type == "cpu" for x in (p, m, v, g)):
        return fused_adam_plain(p, m, v, g, t, **kwargs)
    return fused_adam_cuda(p, m, v, g, t, **kwargs)
