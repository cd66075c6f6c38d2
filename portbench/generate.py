"""Traffic: a closed training set drawn from the seed, and the order the
program's loader reads it in.

A traffic file (``portbench/traffic/<name>.json``) is data: its
``"generator"`` names a file ``portbench/generators/<generator>.py`` whose
``make_dataset(traffic, field_rows, num_dense, seed, device)`` draws the
set from the file's parameters, on the device. A new mix of an existing
generator is one new data file; a new kind of traffic adds a generator file
beside it, and neither edits a file that is there.

``batch_rows`` works out which rows of the set each train step reads: the
order of the program's loader (one permutation of the set an epoch from
``numpy.random.SeedSequence([seed, epoch])``), written again here so that
the reference and the metrics need nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

MASK63 = (1 << 63) - 1


def sub_seed(seed: int, *salt: int) -> int:
    """A generator seed for one purpose, mixed from the run's seed (any
    non-negative integer, wider than 32 bits too) and a salt."""
    h = seed & MASK63
    for s in salt:
        h = (h * 6364136223846793005 + 1442695040888963407 + s * 0x9E3779B97F4A7C15) & MASK63
        h ^= h >> 29
    return h


def gen(device, seed: int, *salt: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one purpose of the run's seed."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *salt))


def make_dataset(traffic: dict, field_rows, num_dense: int, seed: int, device,
                 root=None) -> dict:
    """The training set on ``device``, by the traffic's generator: cat_ids
    [N, F] int32 global rows (field f's rows start at the sum of the sizes
    before it), num_vals [N, num_dense] fp32, labels [N] fp32."""
    from portbench import spec

    n = int(traffic["rows"])
    if n % int(traffic["batch_size"]):
        raise ValueError("rows must be a multiple of batch_size (no epoch carry)")
    mod = spec.generator(traffic["generator"], *(() if root is None else (root,)))
    data = mod.make_dataset(traffic, field_rows, num_dense, seed, device)
    want = {"cat_ids": (n, len(field_rows)), "num_vals": (n, num_dense), "labels": (n,)}
    got = {k: tuple(v.shape) for k, v in data.items()}
    if got != want:
        raise ValueError(f"generator {traffic['generator']!r} made {got}, not {want}")
    return data


def epoch_perm(seed: int, epoch: int, n: int) -> np.ndarray:
    """The loader's order of the set in one epoch."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n)


def batch_rows(seed: int, n: int, batch: int, step: int) -> np.ndarray:
    """The set's rows that train step ``step`` (0-based) reads, for a set of
    ``n`` rows that ``batch`` divides."""
    per_epoch = n // batch
    epoch, i = divmod(step, per_epoch)
    return epoch_perm(seed, epoch, n)[i * batch:(i + 1) * batch]
