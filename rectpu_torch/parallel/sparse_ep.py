"""Sparse (lazy-Adam) updates of EP row-sharded tables: the port of
``rectpu/parallel/sparse_ep.py``.

A sharded table past the dense-sweep crossover needs both EP and the sparse
fast step (``train/fast_step.py``): only the touched rows may move. Per
rank, the steps of rectpu's ``shard_map``:

  1. dedup the local [B_loc, F] (id, cotangent row) pairs
     (``train/sparse.dedupe_rows``: a stable sort and the scatter kernel's
     fp32 segment sums);
  2. [2d/dedup batch] bucket the unique rows by owning shard and
     ``all_to_all`` ids and fp32 sums to their owners over 'model';
  3. ``all_gather`` the received lists over 'data', so every 'data' replica
     of a shard applies the same update;
  4. dedup-sum again (cross-source collisions) and apply the TF-style
     lazy-Adam rows to the shard in place through the single-card fast
     step's ``train/sparse.sparse_adam_rows_packed`` (the gather kernel
     reads the touched table and m|v rows, the row-set kernel writes them;
     untouched rows keep stale m/v and take no step, as
     ``tf.train.AdamOptimizer._apply_sparse``).

Only small per-row tensors cross the exchange; the [V/M, W] state is
written in place. Rows this shard does not own carry the out-of-range local
id V/M: they gather zero rows and their writes drop. The row writes are
rectpu's ``.at[].set(mode="drop")`` (``scatter_backend="xla"``) whatever
the fast step's backend, as in rectpu.
The all_to_all capacity defaults to the lossless min(n_local, V/M): an
optimizer update is never dropped unless the caller sets a capacity.
"""

from __future__ import annotations

import torch

from rectpu_torch.parallel.collectives import raw_all_gather, raw_all_to_all
from rectpu_torch.parallel.embedding_ep import owner_slots
from rectpu_torch.parallel.mesh import Mesh
from rectpu_torch.train.sparse import dedupe_rows, sparse_adam_rows_packed, unique_capacity


def make_sparse_rows_ep(mesh: Mesh, batch_2d: bool, peer_capacity: int | None = None,
                        beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8,
                        field_sizes=None):
    """Build ``update(table, mv, ids, dlooked, lr_t)``, which writes the
    lazy-Adam step of the touched rows into this rank's shards in place.

    ``table``: the [V/M, W] shard; ``mv``: its packed [V/M, 2*wp] m|v slab
    (m in [0, W), v in [wp, wp+W)); ``ids``: the rank's [B_loc, F] global
    ids; ``dlooked``: [B_loc, F, W] cotangents of the looked-up rows;
    ``lr_t``: the step's bias-corrected rate. ``batch_2d``: the batch is
    sharded over every rank (2d/dedup), else over 'data' alone (1d).
    ``field_sizes`` (the per-field vocab sizes) cut the deduped lists to
    ``unique_capacity`` at both dedupes (ids must lie in their fields)."""
    n_model = mesh.num_model
    n_data = mesh.num_data
    model, data = mesh.model, mesh.data

    def update(table, mv, ids, dlooked, lr_t):
        v_shard, w = table.shape
        v_total = v_shard * n_model
        dev = table.device
        flat_ids = ids.reshape(-1).to(torch.int32)
        flat_g = dlooked.reshape(-1, w).float()
        cap1 = (unique_capacity(field_sizes, ids.shape[0], flat_ids.shape[0])
                if field_sizes is not None else None)
        rows, grads = dedupe_rows(flat_ids, flat_g, v_total, num_out=cap1)
        n = rows.shape[0]

        if batch_2d and n_model > 1:
            cap = peer_capacity if peer_capacity is not None else min(n, v_shard)
            addr, ok = owner_slots(rows, rows < v_total, v_shard, n_model, cap)
            mc = n_model * cap
            addr = torch.where(ok, addr, torch.full_like(addr, mc))
            # one spare slot takes every dropped write
            send_ids = torch.full((mc + 1,), v_total, dtype=torch.int32, device=dev)
            send_ids.scatter_(0, addr, rows)
            send_g = torch.zeros(mc + 1, w, dtype=torch.float32, device=dev)
            send_g.index_copy_(0, addr, grads)
            rows = raw_all_to_all(send_ids[:mc].reshape(n_model, cap), model).reshape(-1)
            grads = raw_all_to_all(send_g[:mc].reshape(n_model, cap, w), model).reshape(-1, w)

        # every 'data' replica of this shard applies the same update
        rows = raw_all_gather(rows, data)
        grads = raw_all_gather(grads, data)
        b_total = ids.shape[0] * n_data * (n_model if batch_2d else 1)
        cap2 = (unique_capacity(field_sizes, b_total, rows.shape[0])
                if field_sizes is not None else None)
        rows, grads = dedupe_rows(rows, grads, v_total, num_out=cap2)

        # rows this shard does not own take the out-of-range id V/M: they
        # gather zero rows and their writes drop
        local = rows - model.index * v_shard
        owned = (rows < v_total) & (local >= 0) & (local < v_shard)
        local = torch.where(owned, local, torch.full_like(local, v_shard))
        return sparse_adam_rows_packed(table, mv, local, grads, lr_t, beta1, beta2,
                                       epsilon, scatter_backend="xla")

    return update
