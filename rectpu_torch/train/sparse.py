"""Sparse (lazy) row updates for embedding tables: the port of
``rectpu/train/sparse.py``.

TF's sparse optimizer kernels (``_apply_sparse``) update only the rows a batch
touched; the sparse fast step (``train/fast_step.py``) wires these in:

  - ``dedupe_rows``: a stable sort of the batch ids and an fp32 segment sum
    of their gradients into ``[num_out, W]`` per-unique-row sums, unused
    slots carrying ``num_rows`` (out of range, dropped by the row set). The
    sum runs ``ops.scatter_rows.segment_sum``: the plain version on the CPU,
    the deterministic scatter kernel on the card.
  - ``sparse_adam_rows`` / ``sparse_adam_rows_packed``: TF-style lazy Adam on
    exactly those rows (untouched rows keep stale m/v and take no step). The
    rows are gathered with the lookup kernel (``ops.embedding.gather_rows``)
    and written back with the row set (``ops.scatter_dma``).

Unlike rectpu's functional updates, the port's write the parameter and slot
tensors in place and return them.
"""

from __future__ import annotations

import numpy as np
import torch

from rectpu_torch.ops.embedding import gather_rows
from rectpu_torch.ops.fused_adam import adam_lr_t as _adam_lr_t
from rectpu_torch.ops.fused_adam import stochastic_round_bf16
from rectpu_torch.ops.scatter_dma import scatter_rows_dma, set_rows
from rectpu_torch.ops.scatter_rows import segment_sum


def unique_capacity(field_sizes, batch: int, total: int, align: int = 512) -> int:
    """Static upper bound on the distinct ids of a [batch, F] id matrix:
    per field at most min(size_f, batch), summed over the fields' disjoint
    ranges, align-rounded and clamped to ``total`` (R). ``dedupe_rows`` packs
    the uniques into its first slots, so an output of this many rows is exact
    as long as every id of column f lies in its field's range
    (``check_ids_in_field_ranges`` guards that precondition)."""
    c = sum(min(int(s), batch) for s in field_sizes)
    return min(int(total), -(-c // align) * align)


def check_ids_in_field_ranges(ids, offsets, field_sizes):
    """Raise if any id in column f of the [batch, F] matrix falls outside
    [offset_f, offset_f + size_f): the ``unique_capacity`` precondition.
    Host-side (numpy); for tests and validation paths."""
    ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
    for f, (off, size) in enumerate(zip(offsets, field_sizes)):
        col = ids[..., f]
        bad = (col < off) | (col >= off + size)
        if bad.any():
            i = np.argwhere(bad)[0]
            raise ValueError(
                f"field {f}: id {col[tuple(i)]} outside [{off}, {off + size}) "
                f"at batch index {tuple(i)} — violates the unique_capacity "
                "slice contract (rows past the bound would be silently dropped)"
            )


def dedupe_rows(ids: torch.Tensor, grads: torch.Tensor, num_rows: int,
                num_out: int | None = None):
    """Sum the gradients of duplicate ids.

    ids [R] int32 (duplicates allowed), grads [R, W] -> (rows [num_out],
    row_grads [num_out, W] fp32): rows[i] is the i-th unique id in sorted
    order for i < U (the number of uniques) and ``num_rows`` for i >= U;
    row_grads[i] is the summed gradient of rows[i] (zeros past U). Uniques
    past ``num_out`` (default R) are dropped. The sum of each id runs in the
    order of its positions in ``ids`` (a stable sort), as rectpu's
    ``segment_sum`` over its stable ``argsort``; on the CPU the plain
    version adds them one after another in that order."""
    r = ids.shape[0]
    n_out = r if num_out is None else min(int(num_out), r)
    sorted_ids, order = torch.sort(ids, stable=True)
    new_run = torch.ones(r, dtype=torch.bool, device=ids.device)
    new_run[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(new_run, 0, dtype=torch.int32) - 1  # [R] in [0, U), nondecreasing
    row_grads = segment_sum(seg, order, grads.contiguous(), n_out)
    # slot n_out collects the uniques past the output; each other slot takes
    # the one id of its segment (every write to it carries the same value)
    rows = torch.full((n_out + 1,), num_rows, dtype=ids.dtype, device=ids.device)
    rows.scatter_(0, seg.clamp(max=n_out).long(), sorted_ids)
    return rows[:n_out], row_grads


def sparse_adam_rows(params: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     rows: torch.Tensor, row_grads: torch.Tensor, lr_t: float,
                     beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8):
    """Lazy Adam on ``params[rows]`` with separate [V, W] slots, in place
    (out-of-range rows dropped); returns (params, m, v). ``lr_t`` is the
    bias-corrected rate of the step (``adam_lr_t``)."""
    g = row_grads.to(params.dtype)
    m_rows = gather_rows(m, rows) * beta1 + g * (1 - beta1)
    v_rows = gather_rows(v, rows) * beta2 + torch.square(g) * (1 - beta2)
    p_rows = gather_rows(params, rows) - lr_t * m_rows / (torch.sqrt(v_rows) + epsilon)
    for slab, new in ((m, m_rows), (v, v_rows), (params, p_rows)):
        set_rows(slab, rows, new, slab.shape[0])
    return params, m, v


def sparse_adam_rows_packed(params: torch.Tensor, mv: torch.Tensor, rows: torch.Tensor,
                            row_grads: torch.Tensor, lr_t: float, beta1: float = 0.9,
                            beta2: float = 0.999, epsilon: float = 1e-8,
                            sorted_rows: bool = True, scatter_backend: str = "xla",
                            v_valid: int | None = None, sr_seed=None):
    """``sparse_adam_rows`` with m and v packed as one slab, in place;
    returns (params, mv).

    ``params`` is [V, W] or [V] (a fused linear weight); ``mv`` is [V, 2*wp]
    with m in columns [0, W) and v in [wp, wp + W) (``wp`` > W is the
    lane-padded layout, zeros in the pad). A bf16 slab does the row math in
    fp32 and stores m as plain bf16 and v stochastically rounded, seeded with
    ``sr_seed`` (the step t, a host int or a 0-d int64 device tensor) over
    the [rows, W] array, as rectpu does. ``lr_t`` likewise: a float or a 0-d
    fp32 tensor.

    ``scatter_backend`` "dma" writes through ``scatter_rows_dma`` (sentinels
    at or past ``v_valid``, default V - 256, at least 8 pad rows); "xla" is
    rectpu's ``.at[].set(mode="drop")``, here the same row set with every
    row below V valid. Both run the row-set kernel on the card."""
    vec = params.dim() == 1
    p2 = params[:, None] if vec else params
    w = p2.shape[1]
    g = (row_grads[:, None] if vec else row_grads).to(p2.dtype)
    wp = mv.shape[1] // 2
    bf16_slots = mv.dtype == torch.bfloat16
    mv_rows = gather_rows(mv, rows)
    if bf16_slots:
        mv_rows = mv_rows.float()
        if sr_seed is None:
            raise ValueError("bf16 m|v slab needs sr_seed (the step counter)")
    g = g.to(mv_rows.dtype)
    m_rows = mv_rows[:, :w] * beta1 + g * (1 - beta1)
    v_rows = mv_rows[:, wp:wp + w] * beta2 + torch.square(g) * (1 - beta2)
    p_rows = gather_rows(p2, rows) - lr_t * m_rows / (torch.sqrt(v_rows) + epsilon)
    if bf16_slots:
        m_store = m_rows.to(torch.bfloat16)
        v_store = stochastic_round_bf16(v_rows, sr_seed)
    else:
        m_store, v_store = m_rows, v_rows
    if wp == w:
        mv_new = torch.cat([m_store, v_store], dim=1)
    else:
        mv_new = torch.zeros(m_store.shape[0], 2 * wp, dtype=mv.dtype, device=mv.device)
        mv_new[:, :w] = m_store
        mv_new[:, wp:wp + w] = v_store
    p_rows = p_rows.to(p2.dtype)
    if scatter_backend == "dma" and not vec and sorted_rows:
        vv = v_valid if v_valid is not None else p2.shape[0] - 256
        scatter_rows_dma(mv, rows, mv_new, v_valid=vv)
        scatter_rows_dma(p2, rows, p_rows, v_valid=vv)
    else:
        set_rows(mv, rows, mv_new, mv.shape[0])
        set_rows(p2, rows, p_rows, p2.shape[0])
    return params, mv


def adam_lr_t(learning_rate: float, t: int, beta1: float = 0.9, beta2: float = 0.999) -> float:
    """lr*sqrt(1-b2^t)/(1-b1^t), computed in fp32 as rectpu does; returned as
    a Python float holding that fp32 value exactly."""
    return float(_adam_lr_t(int(t), learning_rate, beta1, beta2))
