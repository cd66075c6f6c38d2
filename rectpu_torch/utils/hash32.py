"""The uint32 counter hash that rectpu's stochastic rounding and hash dropout
share (``rectpu/train/optimizers.py:64-69``, ``rectpu/models/base.py:114-134``).

PyTorch on the CPU has no uint32 add, right shift or compare, so the hash runs
on int64 tensors that hold uint32 values, masked to 32 bits after each step.
``mul32`` multiplies by a 32-bit constant in two 16-bit halves, so no product
leaves int64's range and every bit equals rectpu's uint32 arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    ``c`` in [0, 2**32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def mul_u32(x, c: int):
    """``(x * c) mod 2**32`` for a uint32 value ``x`` held as a Python int or
    as an int64 tensor (``mul32``), so a seed computes the same bits either
    way."""
    if isinstance(x, torch.Tensor):
        return mul32(x, c)
    return (x * c) & MASK32


def counter_hash(idx: torch.Tensor, seed) -> torch.Tensor:
    """rectpu's murmur-style hash of (element index, seed), as int64 in
    [0, 2**32): ``h = idx*2654435761 + seed*0x9E3779B9``, then
    ``h ^= h >> 16; h *= 0x85EBCA6B; h ^= h >> 13`` in uint32. ``seed`` is a
    Python int or a 0-d int64 tensor (a step's seed read on the device)."""
    h = (mul32(idx, 2654435761) + mul_u32(seed & MASK32, 0x9E3779B9)) & MASK32
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def flat_index(shape, device, start: int = 0) -> torch.Tensor:
    """``iota(uint32, n).reshape(shape)`` as int64 (mod 2**32), counted from
    ``start`` (the elements of a slice of a larger array)."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device) + int(start)
    return (idx & MASK32).reshape(tuple(shape))


class GlobalIndex(NamedTuple):
    """Where a local array sits in the global array it is a shard of, viewed
    as [shape[0], the rest flattened] (a 1-D array as one column): its first
    row ``row0``, its first column ``col0`` and the global array's
    ``width`` (its columns). A row shard has col0 0 and the local width."""

    row0: int
    col0: int
    width: int


def global_index(shape, device, index: GlobalIndex | None = None) -> torch.Tensor:
    """The flat index of each element of a local array of ``shape`` in its
    global array (``iota`` over the global array, mod 2**32), as int64;
    ``index`` None: the local array is the whole array (``flat_index``)."""
    if index is None:
        return flat_index(shape, device)
    shape = tuple(int(d) for d in shape)
    rows = shape[0] if shape else 1
    cols = 1
    for d in shape[1:]:
        cols *= d
    r = torch.arange(rows, dtype=torch.int64, device=device) + int(index.row0)
    c = torch.arange(cols, dtype=torch.int64, device=device) + int(index.col0)
    return ((r[:, None] * int(index.width) + c[None, :]) & MASK32).reshape(shape)
