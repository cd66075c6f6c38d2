"""Synthetic ml-100k-schema data: the port of ``rectpu/data/synthetic.py``.

Writes CSV files with the exact 42-column schema the trainers consume
(reference trainers/ml_100k.py:3-7), from a planted user/item latent-factor
model, so a model that learns reaches a clearly-above-chance AUC. The port
needs no pandas: it makes the same numpy draws in the same order as rectpu's
``generate_frame``, derives the date columns with the standard library, and
writes with the ``csv`` module in pandas' format (``to_csv(index=False)``:
minimal quoting, "\\n" line ends), so for one seed both packages write the
same bytes.
"""

from __future__ import annotations

import csv
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

from rectpu_torch.features.schema import COLUMNS, GENRE

_OCCUPATIONS = [
    "administrator", "artist", "doctor", "educator", "engineer", "entertainment",
    "executive", "healthcare", "homemaker", "lawyer", "librarian", "marketing",
    "none", "other", "programmer", "retired", "salesman", "scientist", "student",
    "technician", "writer",
]


def generate_frame(num_rows: int = 10000, num_users: int = 943, num_items: int = 1682,
                   seed: int = 0, latent_dim: int = 6) -> dict:
    """{column: 1-D numpy array} in ``COLUMNS`` order, the rows rectpu's
    ``generate_frame`` returns for the same arguments."""
    rng = np.random.default_rng(seed)

    # planted structure: biases (learnable by linear models) + latent factors
    # (learnable only by embedding interactions, e.g. FM/DNN towers)
    u_fac = rng.normal(scale=0.7, size=(num_users, latent_dim))
    i_fac = rng.normal(scale=0.7, size=(num_items, latent_dim))
    u_bias = rng.normal(scale=1.0, size=num_users)
    i_bias = rng.normal(scale=1.0, size=num_items)
    u_age = rng.integers(7, 74, size=num_users)
    u_gender = rng.choice(["F", "M"], size=num_users, p=[0.3, 0.7])
    u_occ = rng.choice(_OCCUPATIONS, size=num_users)
    u_zip = np.array([f"{z:05d}" for z in rng.integers(0, 99999, size=num_users)])
    i_year = rng.integers(1922, 1999, size=num_items)
    i_genres = (rng.random((num_items, len(GENRE))) < 0.12).astype(np.int64)
    i_genres[:, 0] = 0  # "unknown" genre is rare
    i_title = np.array([f"movie_{i}" for i in range(num_items)])

    user = rng.integers(0, num_users, size=num_rows)
    item = rng.integers(0, num_items, size=num_rows)
    score = (u_fac[user] * i_fac[item]).sum(axis=1)
    score = score + u_bias[user] + i_bias[item]
    score = score + 0.15 * (u_age[user] - 33) / 10.0 + 0.1 * (i_year[item] - 1960) / 10.0
    score = score + 0.2 * (u_gender[user] == "M") + 0.1 * i_genres[item, :].sum(axis=1)
    score += rng.normal(scale=0.8, size=num_rows)
    # map scores to 1..5 ratings by quantile so the label prior resembles ml-100k
    qs = np.quantile(score, [0.10, 0.30, 0.60, 0.82])
    rating = 1 + (score[:, None] >= qs[None, :]).sum(axis=1)

    ts = rng.integers(874724710, 893286638, size=num_rows)  # ml-100k's time range
    dts = [datetime.fromtimestamp(int(t), tz=timezone.utc) for t in ts]
    zips = u_zip[user]
    years = i_year[item]
    cols = {
        "user_id": user + 1,
        "item_id": item + 1,
        "rating": rating,
        "timestamp": ts,
        "datetime": np.array([d.strftime("%Y-%m-%d %H:%M:%S") for d in dts]),
        "year": np.array([d.year for d in dts]),
        "month": np.array([d.month for d in dts]),
        "day": np.array([d.day for d in dts]),
        "week": np.array([d.isocalendar()[1] for d in dts]),
        "dayofweek": np.array([d.weekday() + 1 for d in dts]),
        "age": u_age[user],
        "gender": u_gender[user],
        "occupation": u_occ[user],
        "zipcode": zips,
        "zipcode1": np.array([z[0] for z in zips]),
        "zipcode2": np.array([z[:2] for z in zips]),
        "zipcode3": np.array([z[:3] for z in zips]),
        "title": i_title[item],
        "release": np.array([f"01-Jan-{y}" for y in years]),
        "video_release": np.full(num_rows, "null"),
        "imdb": np.full(num_rows, "null"),
    }
    for gi, g in enumerate(GENRE):
        cols[g] = i_genres[item, gi]
    cols["release_date"] = np.array([f"{y}-01-01" for y in years])
    cols["release_year"] = years
    return {c: cols[c] for c in COLUMNS}


def _write_csv(path: Path, frame: dict, lo: int, hi: int) -> None:
    names = list(frame)
    columns = [frame[c][lo:hi].tolist() for c in names]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*columns))


def write_synthetic_dataset(dest_dir: str | Path, train_rows: int = 20000,
                            test_rows: int = 4000, seed: int = 0, **kwargs) -> dict:
    """Write train.csv/test.csv (+all.csv) with the trainer schema; returns paths."""
    dest = Path(dest_dir)
    dest.mkdir(parents=True, exist_ok=True)
    # one planted model for both splits; rows are iid so a head/tail split is clean
    n = train_rows + test_rows
    full = generate_frame(n, seed=seed, **kwargs)
    paths = {"train": dest / "train.csv", "test": dest / "test.csv", "all": dest / "all.csv"}
    _write_csv(paths["train"], full, 0, train_rows)
    _write_csv(paths["test"], full, train_rows, n)
    _write_csv(paths["all"], full, 0, n)
    return {k: str(v) for k, v in paths.items()}
