"""EP (embedding-parallel) lookups of row-sharded tables: the port of
``rectpu/parallel/embedding_ep.py``.

The unified table [V, W] is row-sharded over the 'model' axis: the rank at
model index m holds rows [m*V/M, (m+1)*V/M). Every lookup here runs on one
rank, with that rank's table shard and its batch slice of GLOBAL row ids,
and exchanges with its peers through ``parallel/collectives.py``. Three
exchanges, as in rectpu:

  - ``make_ep_lookup`` (1d): masked local gather, then ``psum`` over
    'model'; the batch is sharded over 'data' only and the towers are
    replicated over 'model'.
  - ``make_ep_lookup_2d``: ``all_gather`` of the ids over 'model', masked
    local gather, ``psum_scatter`` of the rows back to each rank's slice;
    the batch is sharded over every rank.
  - ``make_ep_lookup_dedup``: each rank dedups its ids, asks each owner for
    its unique rows through static [M, C] request slots (``all_to_all`` of
    the ids), the owners gather, and the rows ride ``all_to_all`` back.
    Ids past a peer's capacity C are DROPPED to zero rows and receive no
    gradient (the MoE contract); the default C = min(N, V/M) is lossless.

Each has a flat variant (``lookup(table, ids, has_lin) -> (emb_flat [B,
F*K], lin [B] or None)``), the lane-packed layout of the flat towers, whose
lin is the sum of the packed linear column over the fields.

Kernels: each masked local gather is ``ops.embedding.lookup`` on shard-local
ids, with ids outside the shard set out of range, which the gather kernel
(``embedding_lookup.cu``) returns as zero rows, the same function as
rectpu's ``jnp.take`` followed by the mask; its backward is the scatter
(``scatter_rows.cu``). ``scatter_impl="mxu"`` replaces that backward by a
dedup (``train/sparse.dedupe_rows``, the scatter's segment sums) and the
dense scatter of the unique rows (``ops.scatter_rows.scatter_rows_dense``),
as rectpu's ``_mxu_shard_cotangent`` and ``_owner_gather_mxu`` call
``scatter_rows_dense``. The dedup exchange expands its unique rows with
the gather kernel and transposes the expansion with the segment sums and
the scatter.

Wire formats (``comm_compress``): None; "bf16" (rows and their cotangents
ride as bf16); "int8" (dedup only: per-row symmetric int8 with an fp32
scale forward, bf16 cotangents backward). A ``psum_scatter`` in bf16 sums
one nonzero per element (the owner's row; peers contribute zeros), so its
only error is the first rounding to bf16.
"""

from __future__ import annotations

import torch

from rectpu_torch.ops.embedding import gather_rows, lookup
from rectpu_torch.ops.scatter_rows import DROP_SENTINEL, scatter_rows_dense, segment_sum
from rectpu_torch.parallel.collectives import (all_to_all, psum, psum_scatter,
                                               raw_all_gather, raw_all_to_all, raw_psum,
                                               raw_psum_scatter)
from rectpu_torch.parallel.mesh import Axis, Mesh
from rectpu_torch.train.sparse import dedupe_rows

COMM_COMPRESS_MODES = (None, "bf16", "int8")


def _quantize_rows_int8(x: torch.Tensor):
    """Per-row symmetric int8 quantization: [..., K] -> (int8 q, fp32 scale [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale).to(torch.int8)
    return q, scale


class _RowAllToAll(torch.autograd.Function):
    """``all_to_all`` of [M, C, W] rows on a lossy wire: "bf16" or "int8"
    forward, bf16 cotangents backward (rectpu's ``_make_row_all_to_all``)."""

    @staticmethod
    def forward(ctx, x, axis, mode):
        ctx.axis = axis
        if mode == "bf16":
            return raw_all_to_all(x.to(torch.bfloat16), axis).to(x.dtype)
        q, scale = _quantize_rows_int8(x)
        qb = raw_all_to_all(q, axis)
        sb = raw_all_to_all(scale, axis)
        return (qb.float() * sb).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        gb = raw_all_to_all(g.to(torch.bfloat16).contiguous(), ctx.axis)
        return gb.to(g.dtype), None, None


def _row_all_to_all(x: torch.Tensor, axis: Axis, comm_compress):
    if comm_compress is None:
        return all_to_all(x, axis)
    if comm_compress not in COMM_COMPRESS_MODES:
        raise ValueError(f"comm_compress must be one of {COMM_COMPRESS_MODES}")
    return _RowAllToAll.apply(x, axis, comm_compress)


def _check_rs_compress(comm_compress):
    if comm_compress not in (None, "bf16"):
        raise ValueError(
            "reduce_scatter exchanges support comm_compress in (None, 'bf16'); "
            "int8 rows cannot be summed across shards with per-shard scales — "
            "use ep_mode='dedup' for int8")


def _compressed_psum_scatter(x: torch.Tensor, axis: Axis, comm_compress):
    """``psum_scatter`` over 'model', riding bf16 when asked (see the module
    docstring for why the sum stays exact)."""
    if comm_compress == "bf16" and x.dtype != torch.bfloat16:
        return psum_scatter(x.to(torch.bfloat16), axis).to(x.dtype)
    return psum_scatter(x, axis)


def _shard_local(ids: torch.Tensor, mi: int, v_shard: int) -> torch.Tensor:
    """Shard-local row ids, with ids outside the shard set to -1 (out of
    range: the gather gives a zero row and the scatter drops it)."""
    local = ids.to(torch.int32) - mi * v_shard
    return torch.where((local >= 0) & (local < v_shard), local, torch.full_like(local, -1))


def _masked_lookup(table_shard, ids, mi):
    """[..., W] rows of the ids this shard owns, zero rows for the others;
    differentiable in the shard (gather kernel forward, scatter backward)."""
    return lookup(table_shard, _shard_local(ids, mi, table_shard.shape[0]))


def _flat_pieces(looked: torch.Tensor, k: int, has_lin: bool):
    """[B, F, W] rows -> (emb_flat [B, F*K], lin [B] fp32): the flat layout
    and the packed linear column summed over the fields."""
    b, f, _ = looked.shape
    emb_flat = looked[..., :k].reshape(b, f * k)
    lin = (looked[..., k].float().sum(dim=-1) if has_lin
           else torch.zeros(b, dtype=torch.float32, device=looked.device))
    return emb_flat, lin


def mxu_shard_cotangent(ids_full, d_emb_full, d_lin_full, mi, v_shard, k, table_dtype):
    """A shard's [V/M, W] table cotangent from flat cotangents (rectpu's
    ``_mxu_shard_cotangent``): every (field, example) cotangent row masked to
    the shard's rows, field-major, deduplicated with fp32 sums
    (``dedupe_rows``) and scattered once per unique row
    (``scatter_rows_dense``). ``ids_full`` [B, F] global ids; ``d_emb_full``
    [B, F*K]; ``d_lin_full`` [B] or None."""
    b, f_total = ids_full.shape
    g = d_emb_full.reshape(b, f_total, k).float()
    if d_lin_full is not None:
        g = torch.cat([g, d_lin_full.float()[:, None, None].expand(b, f_total, 1)], dim=2)
    local = ids_full.to(torch.int32) - mi * v_shard
    owned = (local >= 0) & (local < v_shard)
    ids_fm = torch.where(owned, local, torch.full_like(local, DROP_SENTINEL)).t().reshape(-1)
    g_fm = torch.where(owned[..., None], g, torch.zeros((), device=g.device))
    g_fm = g_fm.transpose(0, 1).reshape(-1, g.shape[2])
    rows, row_g = dedupe_rows(ids_fm, g_fm, DROP_SENTINEL)
    return scatter_rows_dense(rows, row_g, v_shard, out_dtype=torch.float32).to(table_dtype)


def make_ep_lookup(mesh: Mesh):
    """1d: ``lookup(table_shard, ids) -> [B/D, F, W]`` over a batch sharded
    on 'data' alone (every model rank of a data row holds the same slice)."""
    model = mesh.model

    def ep_lookup(table_shard, ids):
        return psum(_masked_lookup(table_shard, ids, model.index), model)

    return ep_lookup


class _Flat1dMXU(torch.autograd.Function):
    """1d flat exchange with the MXU-style shard cotangent. The cotangent of
    the psum'd output is whole on every model rank (``psum``'s transpose)."""

    @staticmethod
    def forward(ctx, table_shard, ids, model, has_lin, k):
        ctx.save_for_backward(ids)
        ctx.meta = (model.index, table_shard.shape[0], k, table_shard.dtype, has_lin)
        looked = gather_rows(table_shard.contiguous(),
                             _shard_local(ids, model.index, table_shard.shape[0]))
        emb_flat, lin = _flat_pieces(looked, k, has_lin)
        emb_flat = raw_psum(emb_flat, model)
        if has_lin:
            lin = raw_psum(lin, model)
        return emb_flat, lin

    @staticmethod
    def backward(ctx, d_emb, d_lin):
        (ids,) = ctx.saved_tensors
        mi, v_shard, k, dtype, has_lin = ctx.meta
        dtable = mxu_shard_cotangent(ids, d_emb, d_lin if has_lin else None, mi, v_shard,
                                     k, dtype)
        return dtable, None, None, None, None


def make_ep_lookup_flat(mesh: Mesh, scatter_impl: str = "xla"):
    """1d exchange in the flat layout: ``lookup(table_shard, ids, has_lin=True)
    -> (emb_flat [B/D, F*K], lin [B/D] or None)``; K is the table width less
    the linear column when ``has_lin``."""
    model = mesh.model

    def ep_lookup_flat(table_shard, ids, has_lin=True):
        k = table_shard.shape[1] - (1 if has_lin else 0)
        if scatter_impl == "mxu":
            emb_flat, lin = _Flat1dMXU.apply(table_shard, ids, model, has_lin, k)
            return emb_flat, (lin if has_lin else None)
        emb_flat, lin = _flat_pieces(_masked_lookup(table_shard, ids, model.index), k,
                                     has_lin)
        emb_flat = psum(emb_flat, model)
        return emb_flat, (psum(lin, model) if has_lin else None)

    return ep_lookup_flat


def make_ep_lookup_2d(mesh: Mesh, comm_compress: str | None = None):
    """2d: ``lookup(table_shard, ids) -> [B/(D*M), F, W]`` over a batch
    sharded on every rank: ids all_gathered over 'model', masked local
    gather, rows psum_scattered back."""
    _check_rs_compress(comm_compress)
    model = mesh.model

    def ep_lookup_2d(table_shard, ids):
        ids_full = raw_all_gather(ids.to(torch.int32), model)
        emb = _masked_lookup(table_shard, ids_full, model.index)
        return _compressed_psum_scatter(emb, model, comm_compress)

    return ep_lookup_2d


class _Flat2dMXU(torch.autograd.Function):
    """2d flat exchange with the MXU-style shard cotangent: the cotangents
    all_gather back over 'model' (the transpose of the tiled psum_scatter,
    in bf16 when the forward wire was)."""

    @staticmethod
    def forward(ctx, table_shard, ids, model, has_lin, k, comm_compress):
        ctx.save_for_backward(ids)
        ctx.meta = (model, table_shard.shape[0], k, table_shard.dtype, has_lin,
                    comm_compress)
        ids_full = raw_all_gather(ids.to(torch.int32), model)
        looked = gather_rows(table_shard.contiguous(),
                             _shard_local(ids_full, model.index, table_shard.shape[0]))
        emb_flat, lin = _flat_pieces(looked, k, has_lin)
        if comm_compress == "bf16" and emb_flat.dtype != torch.bfloat16:
            emb_flat = raw_psum_scatter(emb_flat.to(torch.bfloat16), model).to(emb_flat.dtype)
        else:
            emb_flat = raw_psum_scatter(emb_flat, model)
        if has_lin:
            lin = raw_psum_scatter(lin, model)
        else:
            lin = torch.zeros(ids.shape[0], dtype=torch.float32, device=ids.device)
        return emb_flat, lin

    @staticmethod
    def backward(ctx, d_emb, d_lin):
        (ids,) = ctx.saved_tensors
        model, v_shard, k, dtype, has_lin, comm_compress = ctx.meta
        if comm_compress == "bf16" and d_emb.dtype != torch.bfloat16:
            d_emb_full = raw_all_gather(d_emb.to(torch.bfloat16), model).to(d_emb.dtype)
        else:
            d_emb_full = raw_all_gather(d_emb.contiguous(), model)
        ids_full = raw_all_gather(ids.to(torch.int32), model)
        d_lin_full = raw_all_gather(d_lin.contiguous(), model) if has_lin else None
        dtable = mxu_shard_cotangent(ids_full, d_emb_full, d_lin_full, model.index, v_shard,
                                     k, dtype)
        return dtable, None, None, None, None, None


def make_ep_lookup_2d_flat(mesh: Mesh, comm_compress: str | None = None,
                           scatter_impl: str = "xla"):
    """2d exchange in the flat layout: ``lookup(table_shard, ids, has_lin=True)
    -> (emb_flat [B/(D*M), F*K], lin or None)``."""
    _check_rs_compress(comm_compress)
    model = mesh.model

    def ep_lookup_2d_flat(table_shard, ids, has_lin=True):
        k = table_shard.shape[1] - (1 if has_lin else 0)
        if scatter_impl == "mxu":
            emb_flat, lin = _Flat2dMXU.apply(table_shard, ids, model, has_lin, k,
                                             comm_compress)
            return emb_flat, (lin if has_lin else None)
        ids_full = raw_all_gather(ids.to(torch.int32), model)
        emb_flat, lin = _flat_pieces(_masked_lookup(table_shard, ids_full, model.index), k,
                                     has_lin)
        emb_flat = _compressed_psum_scatter(emb_flat, model, comm_compress)
        return emb_flat, (psum_scatter(lin, model) if has_lin else None)

    return ep_lookup_2d_flat


class _OwnerGatherMXU(torch.autograd.Function):
    """The dedup exchange's owner-side masked gather, its transpose a dedup
    across senders and one dense scatter (rectpu's ``_owner_gather_mxu``)."""

    @staticmethod
    def forward(ctx, table_shard, local):
        ctx.save_for_backward(local)
        ctx.meta = (table_shard.shape[0], table_shard.dtype)
        return gather_rows(table_shard.contiguous(), local)

    @staticmethod
    def backward(ctx, g):
        (local,) = ctx.saved_tensors
        v_shard, dtype = ctx.meta
        ok = local >= 0
        ids = torch.where(ok, local, torch.full_like(local, DROP_SENTINEL)).reshape(-1)
        gm = torch.where(ok[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
        rows, rg = dedupe_rows(ids, gm.reshape(-1, g.shape[-1]).float(), DROP_SENTINEL)
        dtable = scatter_rows_dense(rows, rg, v_shard, out_dtype=torch.float32)
        return dtable.to(dtype), None


class _Expand(torch.autograd.Function):
    """Unique rows -> every lookup position: a gather of the returned rows
    (zero rows for dropped lookups); its transpose reuses the forward's sort
    (segment sums over the unique slots, then one write a buffer slot)."""

    @staticmethod
    def forward(ctx, rb, addr_lk, order, uslot, addr_slot):
        ctx.save_for_backward(order, uslot, addr_slot)
        ctx.rows = rb.shape[0]
        return gather_rows(rb.contiguous(), addr_lk)

    @staticmethod
    def backward(ctx, g):
        order, uslot, addr_slot = ctx.saved_tensors
        d_unique = segment_sum(uslot, order, g.contiguous(), g.shape[0])
        return scatter_rows_dense(addr_slot, d_unique, ctx.rows, out_dtype=g.dtype), \
            None, None, None, None


def owner_slots(ids, valid, v_shard: int, m_count: int, cap: int):
    """Bucket [n] global row ids by owning shard into static [M, cap] send
    slots: (addr, ok), with addr = owner * cap + the id's place among the
    ids bound for that owner (in order), and ok false for ids that are not
    ``valid``, lie past the table, or overflow their owner's ``cap``."""
    peer = torch.where(valid, ids // v_shard, torch.full_like(ids, m_count)).long()
    onehot = peer[:, None] == torch.arange(m_count, device=ids.device)[None, :]
    pos = torch.where(onehot, torch.cumsum(onehot.long(), 0) - 1,
                      torch.zeros((), dtype=torch.long, device=ids.device)).sum(dim=1)
    return peer * cap + pos, valid & (peer < m_count) & (pos < cap)


def dedup_exchange(table_shard, flat_ids, model: Axis, peer_capacity=None,
                   comm_compress=None, scatter_impl="xla"):
    """The dedup all_to_all core (rectpu's ``_dedup_exchange``): [n] GLOBAL
    ids -> [n, W] rows in the caller's order."""
    m_count = model.size
    v_shard = table_shard.shape[0]
    n = flat_ids.shape[0]
    dev = flat_ids.device
    cap = peer_capacity if peer_capacity is not None else min(n, v_shard)

    flat = flat_ids.to(torch.int32)
    sorted_ids, order = torch.sort(flat, stable=True)
    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    uslot = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_unique = uslot[-1] + 1
    unique_ids = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(0, uslot.long(),
                                                                        sorted_ids)
    slot = torch.arange(n, device=dev)
    slot_valid = slot < n_unique
    inv = torch.empty(n, dtype=torch.int64, device=dev).scatter_(0, order, uslot.long())

    addr, valid_send = owner_slots(unique_ids, slot_valid, v_shard, m_count, cap)
    mc = m_count * cap
    addr_safe = torch.where(valid_send, addr, torch.full_like(addr, mc))
    # one spare slot takes every dropped write (rectpu's mode="drop")
    requests = torch.full((mc + 1,), -1, dtype=torch.int32, device=dev)
    requests.scatter_(0, addr_safe, unique_ids)
    req_recv = raw_all_to_all(requests[:mc].reshape(m_count, cap), model)

    local = req_recv - model.index * v_shard
    ok = (local >= 0) & (local < v_shard)
    local = torch.where(ok, local, torch.full_like(local, -1))
    if scatter_impl == "mxu":
        resp = _OwnerGatherMXU.apply(table_shard, local)
    else:
        resp = lookup(table_shard, local)  # [M, C, W]
    resp_back = _row_all_to_all(resp, model, comm_compress).reshape(mc, -1)

    valid_lk = valid_send[inv]
    addr_lk = torch.where(valid_lk, addr[inv], torch.full_like(addr, -1)).to(torch.int32)
    return _Expand.apply(resp_back, addr_lk, order, uslot, addr_safe.to(torch.int32))


def make_ep_lookup_dedup(mesh: Mesh, peer_capacity: int | None = None,
                         comm_compress: str | None = None, scatter_impl: str = "xla"):
    """dedup: ``lookup(table_shard, ids) -> [B/(D*M), F, W]`` over a batch
    sharded on every rank, exchanging unique rows (``dedup_exchange``)."""
    if comm_compress not in COMM_COMPRESS_MODES:
        raise ValueError(f"comm_compress must be one of {COMM_COMPRESS_MODES}")
    model = mesh.model

    def ep_lookup_dedup(table_shard, ids):
        b, f = ids.shape
        emb = dedup_exchange(table_shard, ids.reshape(-1), model, peer_capacity,
                             comm_compress, scatter_impl)
        return emb.reshape(b, f, -1)

    return ep_lookup_dedup


def make_ep_lookup_dedup_flat(mesh: Mesh, peer_capacity: int | None = None,
                              comm_compress: str | None = None, scatter_impl: str = "xla"):
    """The dedup exchange in the flat layout; the ids flatten field-major,
    as rectpu's, so the capacity contract drops the same lookups."""
    if comm_compress not in COMM_COMPRESS_MODES:
        raise ValueError(f"comm_compress must be one of {COMM_COMPRESS_MODES}")
    model = mesh.model

    def ep_lookup_dedup_flat(table_shard, ids, has_lin=True):
        b, f = ids.shape
        k = table_shard.shape[1] - (1 if has_lin else 0)
        rows = dedup_exchange(table_shard, ids.t().reshape(-1), model, peer_capacity,
                              comm_compress, scatter_impl)
        looked = rows.reshape(f, b, -1).transpose(0, 1)
        emb_flat, lin = _flat_pieces(looked, k, has_lin)
        return emb_flat, (lin if has_lin else None)

    return ep_lookup_dedup_flat
