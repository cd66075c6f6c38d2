"""The ``zipf`` generator: a closed training set of power-law ids.

A traffic file that names it (``"generator": "zipf"``) gives:

    {"generator": "zipf", "rows": 4194304, "batch_size": 8192,
     "zipf_alpha": 1.05, "label_rate": 0.25, "dense_geometric_p": 0.1}

Each sparse field's ids are Zipf(alpha) ranks over the rows the chip holds
for that field, mapped to rows by a seeded permutation (so the hot rows lie
scattered over the table, as hashed CTR ids do). Each dense feature is
log(1 + x) with x + 1 ~ Geometric(p), as DLRM's Criteo preprocessing logs
its counts. Labels are Bernoulli(label_rate). Everything is drawn on the
device from ``torch.Generator``s seeded from ``--seed``, in one call per
field.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.generate import gen


def zipf_ranks(n: int, count: int, alpha: float, g: torch.Generator, device) -> torch.Tensor:
    """``count`` ranks in [0, n) with P(r) proportional to (r + 1)^-alpha,
    by the inverse of the exact CDF (float64)."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device).pow_(-alpha)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(count, dtype=torch.float64, device=device, generator=g)
    return torch.searchsorted(cdf, u).clamp_(max=n - 1)


def make_dataset(traffic: dict, field_rows, num_dense: int, seed: int, device) -> dict:
    n = int(traffic["rows"])
    alpha = float(traffic["zipf_alpha"])
    cat = torch.empty((n, len(field_rows)), dtype=torch.int32, device=device)
    offset = 0
    for f, rows in enumerate(field_rows):
        rows = int(rows)
        ranks = zipf_ranks(rows, n, alpha, gen(device, seed, 1, f), device)
        perm = torch.randperm(rows, generator=gen(device, seed, 2, f), device=device)
        cat[:, f] = (perm[ranks] + offset).to(torch.int32)
        offset += rows
    p = float(traffic["dense_geometric_p"])
    u = torch.rand((n, num_dense), generator=gen(device, seed, 3), device=device,
                   dtype=torch.float32)
    counts = torch.floor(torch.log1p(-u) / np.log1p(-p))  # Geometric(p) - 1: 0, 1, 2, ...
    dense = torch.log1p(counts)
    labels = (torch.rand(n, generator=gen(device, seed, 4), device=device)
              < float(traffic["label_rate"])).float()
    return {"cat_ids": cat, "num_vals": dense, "labels": labels}
