"""Weights from the seed, made on the device in a few large calls.

A family's reference (``portbench/reference/<family>.py``) names its leaves
in ``param_specs``: {key path: (shape, init)}, where init is
``("trunc_normal", stddev)`` (the 2-sigma truncated normal of TF's
embedding_column), ``("glorot", fan_in, fan_out)`` (glorot uniform over that
fan) or ``("zeros",)``. Those are the model's own initialisers; the values
are the benchmark's, drawn here, and handed to both the program and the
reference.

A leaf is made in blocks of ``BLOCK`` rows, block b from its own generator,
so that any block can be made again later without keeping the first copy
(``leaf_block``): the check reads a table's change from its start that way.
"""

from __future__ import annotations

import math

import torch

from portbench.generate import sub_seed

BLOCK = 1 << 20  # rows a generator call makes


def _key_salt(key: str) -> int:
    h = 0
    for ch in key.encode():
        h = (h * 131 + ch) & 0xFFFFFFFF
    return h


def leaf_block(spec, key: str, seed: int, b: int, device) -> torch.Tensor:
    """Rows [b * BLOCK, (b + 1) * BLOCK) of leaf ``key`` (fp32)."""
    shape, init = tuple(spec[0]), spec[1]
    rows = shape[0] if shape else 1
    lo, hi = b * BLOCK, min((b + 1) * BLOCK, rows)
    bshape = (hi - lo,) + shape[1:] if shape else ()
    if init[0] == "zeros":
        return torch.zeros(bshape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 7, _key_salt(key), b))
    u = torch.rand(bshape, generator=gen, device=device, dtype=torch.float32)
    if init[0] == "glorot":
        limit = math.sqrt(6.0 / (init[1] + init[2]))
        return u.mul_(2.0 * limit).sub_(limit)
    if init[0] == "trunc_normal":
        lo_p = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        hi_p = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
        z = u.mul_(2.0 * (hi_p - lo_p)).add_(2.0 * lo_p - 1.0).erfinv_().mul_(math.sqrt(2.0))
        return z.clamp_(-2.0, 2.0).mul_(init[1])
    raise ValueError(f"unknown init {init!r} for {key}")


def num_blocks(spec) -> int:
    shape = tuple(spec[0])
    return max(1, -(-(shape[0] if shape else 1) // BLOCK))


def make_leaf(spec, key: str, seed: int, device) -> torch.Tensor:
    shape = tuple(spec[0])
    if not shape:
        return leaf_block(spec, key, seed, 0, device)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    for b in range(num_blocks(spec)):
        out[b * BLOCK:(b + 1) * BLOCK] = leaf_block(spec, key, seed, b, device)
    return out


def make_rows(spec, key: str, seed: int, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of leaf ``key``: a rank's shard of a row-sharded table,
    the same values as those rows of ``make_leaf``."""
    shape = tuple(spec[0])
    out = torch.empty((hi - lo,) + shape[1:], dtype=torch.float32, device=device)
    for b in range(lo // BLOCK, -(-hi // BLOCK)):
        a, z = max(lo, b * BLOCK), min(hi, (b + 1) * BLOCK)
        out[a - lo:z - lo] = leaf_block(spec, key, seed, b, device)[a - b * BLOCK:z - b * BLOCK]
    return out


def make_flat(specs: dict, seed: int, device, shard: dict | None = None) -> dict:
    """{key path: fp32 tensor} of every leaf; ``shard`` {key: (lo, hi)}
    makes only those rows of the leaves it names."""
    shard = shard or {}
    return {key: (make_rows(spec, key, seed, *shard[key], device) if key in shard
                  else make_leaf(spec, key, seed, device)) for key, spec in specs.items()}


def nest(flat: dict) -> dict:
    """{"a/0/b": x} -> {"a": [{"b": x}]}: the tree the program's
    ``convert.load_params`` takes (a numeric path part makes a list)."""
    tree: dict = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = tree
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(tree)


def rows_of(spec, key: str, seed: int, rows: torch.Tensor, device) -> torch.Tensor:
    """The start values of rows ``rows`` (sorted, int64, on ``device``) of
    leaf ``key``, made again block by block."""
    out = []
    for b in range(num_blocks(spec)):
        lo, hi = b * BLOCK, (b + 1) * BLOCK
        sel = rows[(rows >= lo) & (rows < hi)]
        if sel.numel():
            out.append(leaf_block(spec, key, seed, b, device)[sel - lo])
    return torch.cat(out)
