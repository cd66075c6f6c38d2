"""Frequency-aware embedding-row placement (RecShard, arXiv:2201.10095): the
port's copy of ``rectpu/parallel/placement.py`` (pure numpy, kept as its own
copy so that the port imports nothing of rectpu; the CPU tests hold it
against rectpu's bit for bit).

The unified table is row-sharded into ``n_shards`` equal contiguous blocks on
the 'model' axis. Real CTR id traffic is power-law skewed, so the hash-order
placement can put the hot rows of a field on one shard, which then owns most
of every batch's unique rows: capacity drops in the dedup EP exchange
(``parallel/embedding_ep.py``) and load imbalance. ``frequency_permutation``
deals each field's rows, hottest first, across the shards the field's range
intersects, and only WITHIN the field's block ``[offset, offset + size)``,
which keeps every layout invariant of the lookups and the scatter.

The permutation is a relabeling: applied to the ids once (``CsvDataset.
apply_row_permutation``) and carried through checkpoints and exports, a
permuted run equals an unpermuted one whose init table rows were relabeled
the same way.
"""

from __future__ import annotations

import numpy as np


def count_row_frequencies(cat_ids: np.ndarray, total_rows: int) -> np.ndarray:
    """Lookup counts per global row id from encoded [N, F] ids."""
    return np.bincount(
        np.asarray(cat_ids, dtype=np.int64).reshape(-1), minlength=total_rows
    ).astype(np.int64)


def frequency_permutation(
    counts: np.ndarray,
    field_info: tuple[tuple[int, ...], tuple[int, ...]],
    n_shards: int,
    padded_rows: int,
) -> np.ndarray:
    """Build perm with ``perm[old_id] = new_id`` (a bijection on
    [0, padded_rows); identity outside the field ranges, e.g. padding rows).

    Per field: sort rows by descending lookup count, then place in three
    stages — exact least-loaded greedy (LPT) for the hottest 64*m rows,
    mass-based water-filling of each shard toward the perfect-balance level
    (vectorized, O(m) searchsorteds), and a snake deal of the mass-light
    remainder. Measured within ~4% of the single-row lower bound from 512 to
    6M rows, in seconds (a pure per-row LPT loop would stall startup for
    minutes at production vocab sizes). Load is tracked across fields, so a
    later field's hot rows avoid the shards earlier fields loaded up.
    """
    counts = np.asarray(counts, dtype=np.float64)
    offsets, sizes = field_info
    if padded_rows % n_shards != 0:
        raise ValueError(f"padded_rows={padded_rows} not divisible by n_shards={n_shards}")
    shard_size = padded_rows // n_shards
    perm = np.arange(padded_rows, dtype=np.int32)
    load = np.zeros(n_shards, dtype=np.float64)
    for off, size in zip(offsets, sizes):
        off, size = int(off), int(size)
        rows = np.arange(off, off + size, dtype=np.int64)
        row_counts = counts[rows] if off + size <= counts.shape[0] else np.zeros(size)
        order = np.argsort(-row_counts, kind="stable")
        shard_of = rows // shard_size
        shards = [int(s) for s in np.unique(shard_of)]
        slot_lists = {s: rows[shard_of == s] for s in shards}
        next_free = {s: 0 for s in shards}

        # exact greedy (LPT) for the head — the rows whose counts actually
        # differ enough to matter; per-row Python for the whole table would
        # stall startup for minutes at production vocab sizes
        head_n = min(size, 64 * len(shards))
        for idx in order[:head_n]:
            open_shards = [s for s in shards if next_free[s] < len(slot_lists[s])]
            s = min(open_shards, key=lambda s_: load[s_])
            perm[rows[idx]] = slot_lists[s][next_free[s]]
            next_free[s] += 1
            load[s] += row_counts[idx]

        # vectorized tail, two phases. A dealt equal-share tail is NOT
        # load-aware: the shard holding the #1 row would still receive a full
        # 1/m of the tail mass (measured 34% over-load on a 6M-row zipf).
        #
        # Phase A — water-filling by MASS: top up each shard toward the
        # perfect-balance level W with a CONTIGUOUS run of the heaviest
        # remaining rows (cumsum + one searchsorted per shard; contiguity is
        # fine — only mass matters), capped by the shard's free slots.
        tail_idx = order[head_n:]
        tail_counts = row_counts[tail_idx]
        csum = np.concatenate([[0.0], np.cumsum(tail_counts)])
        m = len(shards)
        if len(tail_idx):
            water = (sum(load[s] for s in shards) + csum[-1]) / m
            pos = 0
            for s in sorted(shards, key=lambda s_: load[s_]):
                cap_s = len(slot_lists[s]) - next_free[s]
                need = water - load[s]
                if need <= 0 or cap_s == 0 or pos >= len(tail_idx):
                    continue
                n = int(np.searchsorted(csum[pos + 1:] - csum[pos], need)) + 1
                n = min(n, cap_s, len(tail_idx) - pos)
                taken = tail_idx[pos:pos + n]
                perm[rows[taken]] = slot_lists[s][next_free[s]:next_free[s] + n]
                next_free[s] += n
                load[s] += csum[pos + n] - csum[pos]
                pos += n
            tail_idx = tail_idx[pos:]

        # Phase B — SNAKE-deal the (mass-light) remainder over the remaining
        # slots, least-loaded first; alternating direction each cycle cancels
        # the within-cycle bias of a straight round-robin.
        if len(tail_idx):
            by_load = sorted(shards, key=lambda s_: load[s_])
            rem = [slot_lists[s][next_free[s]:] for s in by_load]
            lens = np.array([len(r) for r in rem])
            gidx = np.repeat(np.arange(m), lens)
            ranks = np.concatenate([np.arange(n) for n in lens]) if lens.size else np.array([], np.int64)
            allslots = np.concatenate(rem) if lens.size else np.array([], np.int64)
            snake = np.where(ranks % 2 == 0, gidx, m - 1 - gidx)
            deal = np.lexsort((snake, ranks))
            perm[rows[tail_idx]] = allslots[deal].astype(np.int32)
            load_add = np.bincount(gidx[deal], weights=row_counts[tail_idx],
                                   minlength=m)
            for i, s in enumerate(by_load):
                load[s] += load_add[i]
    return perm


def shard_load(counts: np.ndarray, perm: np.ndarray, n_shards: int) -> np.ndarray:
    """Per-shard total lookup traffic under a placement (diagnostics/tests)."""
    counts = np.asarray(counts, dtype=np.int64)
    padded_rows = perm.shape[0]
    shard_size = padded_rows // n_shards
    new_pos = np.asarray(perm[: counts.shape[0]], dtype=np.int64)
    return np.bincount(new_pos // shard_size, weights=counts, minlength=n_shards)


def suggest_peer_capacity(
    counts: np.ndarray,
    n_shards: int,
    padded_rows: int,
    lookups_per_instance: int,
    safety: float = 1.5,
) -> int:
    """Data-driven peer capacity for the dedup EP exchange (MoE contract,
    embedding_ep.make_ep_lookup_dedup): the expected number of UNIQUE rows a
    batch slice of ``lookups_per_instance`` id draws requests from the
    busiest shard, times a safety factor, rounded up to a multiple of 8.

    E[unique rows of shard s] = sum over rows r in s of 1 - (1 - p_r)^n with
    p_r the row's empirical lookup probability — exact for iid draws, a
    usable upper-ballpark for real batches (within-batch correlation only
    lowers the unique count). ``counts`` must reflect the id labels actually
    used in training (i.e. count AFTER any row placement remap).
    """
    counts = np.asarray(counts, dtype=np.float64)
    if counts.sum() <= 0:
        raise ValueError("counts are empty")
    p = np.zeros(padded_rows)
    p[: counts.shape[0]] = counts / counts.sum()
    shard_size = padded_rows // n_shards
    e_unique = 1.0 - (1.0 - p) ** float(lookups_per_instance)
    per_shard = e_unique.reshape(n_shards, shard_size).sum(axis=1)
    cap = int(np.ceil(per_shard.max() * safety))
    cap = max(8, -(-cap // 8) * 8)
    # never exceed the provably-lossless bound — capacity above it is waste
    return min(cap, min(lookups_per_instance, shard_size))


def relabel_table_rows(table: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Move row i of ``table`` to row ``perm[i]`` — the table-side relabeling
    that makes a permuted run bitwise-equal to an unpermuted one."""
    out = np.empty_like(np.asarray(table))
    out[np.asarray(perm)] = np.asarray(table)
    return out
