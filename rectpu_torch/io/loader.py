"""Input pipeline, CSV -> encoded batches: the port of ``rectpu/io/loader.py``.

The dataset is parsed and feature-encoded once into dense columnar numpy
arrays (global ids per field + float label); batch iteration is array
slicing. rectpu reads the CSV with pandas (or its native C++ loader); the
port reads it with the standard ``csv`` module and applies pandas' rules:
string columns stay strings (zipcode "03364" keeps its leading zero,
``loader.py:62-64``), pandas' missing-value tokens ("", "NA", "null", ...)
take the schema default (0 / "null"), numeric text parses as pandas'
``to_numeric(errors="coerce")`` does. Every other rule is rectpu's, so the
batch stream is the same as rectpu's ``CsvDataset``:

  - label = (rating >= cutoff), cutoff default 5 (trainers/ml_100k.py:48);
  - TRAIN shuffles and repeats forever, one full permutation per epoch from
    ``default_rng(SeedSequence([seed, epoch]))`` (:269-271), with an epoch's
    remainder rows carried into the next epoch's first batch;
  - EVAL is one ordered pass, the last batch zero-padded with weight 0.

``StreamingCsvDataset`` (out-of-core windows) is not ported yet (ROADMAP.md
queue A7).
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path

import numpy as np

from rectpu_torch.features.schema import FeatureSet, column_default, is_string_column
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# pandas.read_csv's default missing-value tokens
_NA_TOKENS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])


@dataclasses.dataclass
class DataState:
    """Position of the input iterator, checkpointable for exact resume:
    ``index`` is the row offset within the current epoch's stream."""

    epoch: int = 0
    index: int = 0
    seed: int = 0


def _number(token: str, default, as_float: bool):
    if token in _NA_TOKENS:
        return default
    try:
        return float(token) if as_float else int(token)
    except ValueError:
        pass
    try:
        x = float(token)
    except ValueError:
        return default  # pandas' errors="coerce": NaN, then the default
    if x != x:
        return default
    return x if as_float else int(x)


def read_csv_columns(csv_path: str | Path, columns: list[str],
                     float_cols: set | frozenset = frozenset()) -> dict:
    """Read a CSV into {column -> np array}, applying schema defaults.

    ``float_cols``: columns consumed as raw floats (NumericFeature), read as
    float64; other numeric columns are int64 (integer hashing stringifies
    decimally, so "3" must not become "3.0"). String columns come back as
    numpy str arrays."""
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    pos = {name: i for i, name in enumerate(header)}
    out = {}
    for col in columns:
        default = column_default(col)
        i = pos.get(col)
        raw = [r[i] if i < len(r) else "" for r in rows] if i is not None else None
        if is_string_column(col):
            vals = ([str(default)] * len(rows) if raw is None else
                    [str(default) if t in _NA_TOKENS else t for t in raw])
            out[col] = np.array(vals, dtype=str) if vals else np.zeros(0, dtype=str)
        else:
            as_float = col in float_cols
            dtype = np.float64 if as_float else np.int64
            if raw is None:
                out[col] = np.full(len(rows), default, dtype=dtype)
            else:
                out[col] = np.array([_number(t, default, as_float) for t in raw], dtype=dtype)
    return out


class CsvDataset:
    """A fully encoded, in-memory dataset ready for batching.

    Attributes:
        cat_ids: [N, F] int32 global embedding-row ids.
        num_vals: [N, D] float32 numeric features (D may be 0).
        labels: [N] float32 binary labels.
    """

    def __init__(self, csv_path: str | Path, feature_set: FeatureSet,
                 label_col: str = "rating", cutoff: int = 5):
        self.feature_set = feature_set
        needed = [f.name for f in feature_set.categorical] + [f.name for f in feature_set.numeric]
        columns = read_csv_columns(csv_path, needed + [label_col],
                                   float_cols={f.name for f in feature_set.numeric})
        batch = feature_set.encode(columns)
        self.cat_ids = batch["cat_ids"]
        self.num_vals = batch.get(
            "num_vals", np.zeros((self.cat_ids.shape[0], 0), dtype=np.float32))
        self.labels = (columns[label_col] >= cutoff).astype(np.float32)
        self.size = self.cat_ids.shape[0]
        logger.debug("dataset loaded: %s rows from %s", self.size, csv_path)

    @classmethod
    def from_arrays(cls, cat_ids, labels, num_vals=None, feature_set=None):
        ds = cls.__new__(cls)
        ds.feature_set = feature_set
        ds.cat_ids = np.asarray(cat_ids, dtype=np.int32)
        ds.labels = np.asarray(labels, dtype=np.float32)
        ds.num_vals = (np.asarray(num_vals, dtype=np.float32) if num_vals is not None
                       else np.zeros((ds.cat_ids.shape[0], 0), dtype=np.float32))
        ds.size = ds.cat_ids.shape[0]
        return ds

    def apply_row_permutation(self, perm: np.ndarray) -> None:
        """Relabel the encoded row ids in place, id -> perm[id] (a stored row
        placement, ``rectpu/io/loader.py:153``)."""
        self.cat_ids = np.asarray(perm, dtype=np.int32)[self.cat_ids]

    def train_index_batches(self, batch_size: int, state: DataState | None = None,
                            seed: int = 0):
        """Infinite shuffled row-index batches of shape [batch_size]: yields
        (row_indices int64, DataState after the batch). ``train_batches``
        materializes the same batches."""
        state = state or DataState(seed=seed)
        epoch, index = state.epoch, state.index
        perm = self._perm(epoch, state.seed)
        carry = np.empty((0,), dtype=perm.dtype)
        while True:
            take = batch_size - carry.shape[0]
            if index + take <= perm.shape[0]:
                sel = perm[index: index + take]
                index += take
                rows = np.concatenate([carry, sel]) if carry.size else sel
                carry = np.empty((0,), dtype=perm.dtype)
                yield rows, DataState(epoch=epoch, index=index, seed=state.seed)
            else:
                carry = np.concatenate([carry, perm[index:]])
                epoch += 1
                index = 0
                perm = self._perm(epoch, state.seed)

    def train_batches(self, batch_size: int, state: DataState | None = None, seed: int = 0):
        """Infinite shuffled batches {cat_ids, num_vals, labels} with the
        DataState after each."""
        for rows, st in self.train_index_batches(batch_size, state=state, seed=seed):
            yield {"cat_ids": self.cat_ids[rows], "num_vals": self.num_vals[rows],
                   "labels": self.labels[rows]}, st

    def eval_batches(self, batch_size: int):
        """One ordered pass; the last batch is zero-padded with weight 0."""
        n_batches = max(-(-self.size // batch_size), 1)
        for b in range(n_batches):
            sel = np.arange(b * batch_size, min((b + 1) * batch_size, self.size))
            n = sel.shape[0]
            ids, num, lab = self.cat_ids[sel], self.num_vals[sel], self.labels[sel]
            w = np.ones((n,), dtype=np.float32)
            if n < batch_size:
                pad = batch_size - n
                ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), dtype=np.int32)])
                num = np.concatenate([num, np.zeros((pad, num.shape[1]), dtype=np.float32)])
                lab = np.concatenate([lab, np.zeros((pad,), dtype=np.float32)])
                w = np.concatenate([w, np.zeros((pad,), dtype=np.float32)])
            yield {"cat_ids": ids, "num_vals": num, "labels": lab, "weights": w}

    def _perm(self, epoch: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        return rng.permutation(self.size)
