"""Feature-column specs and the ml-100k feature set, for request encoding.

A copy of the serving-side parts of ``rectpu/features/schema.py``: the four
categorical specs, ``NumericFeature``, ``FeatureSet`` and
``ml_100k_feature_set``. Every categorical column is encoded host-side to a
dense integer id, and all columns share ONE unified id space: each field owns
a contiguous offset range of a single embedding table, so a batch is a dense
``[B, num_fields] int32`` matrix of global row ids and the device-side work is
one gather (reference trainers/ml_100k.py:3-39).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from rectpu_torch.features.hashing import fingerprint64, hash_bucket

GENRE = (
    "unknown,action,adventure,animation,children,comedy,crime,documentary,drama,fantasy,"
    "filmnoir,horror,musical,mystery,romance,scifi,thriller,war,western"
).split(",")

_STR_COLS = frozenset(
    ["datetime", "gender", "occupation", "zipcode", "zipcode1", "zipcode2", "zipcode3",
     "title", "release", "video_release", "imdb", "release_date"]
)


def is_string_column(col: str) -> bool:
    return col in _STR_COLS


@dataclass(frozen=True)
class HashFeature:
    """``categorical_column_with_hash_bucket`` equivalent."""

    name: str
    num_buckets: int
    dtype: str = "string"  # "string" | "int32" — int32 is stringified before hashing

    def encode(self, values: np.ndarray) -> np.ndarray:
        return hash_bucket(values, self.num_buckets)


@dataclass(frozen=True)
class VocabFeature:
    """``categorical_column_with_vocabulary_list`` equivalent.

    In-vocab values map to their index; out-of-vocab values map to
    ``len(vocab) + fingerprint64(value) % num_oov_buckets`` (TF semantics).
    """

    name: str
    vocab: tuple
    num_oov_buckets: int = 1

    @property
    def num_buckets(self) -> int:
        return len(self.vocab) + self.num_oov_buckets

    def encode(self, values: np.ndarray) -> np.ndarray:
        values = np.asarray(values)
        flat = values.reshape(-1)
        base = len(self.vocab)
        # vectorized in-vocab lookup (sorted searchsorted); only the rare
        # OOV values pay a per-element hash
        vocab_arr = np.asarray(self.vocab)
        try:
            cmp = flat.astype(vocab_arr.dtype) if flat.dtype != vocab_arr.dtype else flat
        except (ValueError, TypeError):
            cmp = None
        if cmp is not None:
            sorter = np.argsort(vocab_arr, kind="stable")
            svocab = vocab_arr[sorter]
            pos = np.clip(np.searchsorted(svocab, cmp), 0, base - 1)
            hit = svocab[pos] == cmp
            out = np.where(hit, sorter[pos], -1).astype(np.int32)
            miss = np.flatnonzero(~hit)
        else:  # incomparable dtypes: everything takes the per-element path
            out = np.full(flat.shape, -1, dtype=np.int32)
            lookup = {v: i for i, v in enumerate(self.vocab)}
            for i in range(flat.shape[0]):
                idx = lookup.get(flat[i])
                if idx is not None:
                    out[i] = idx
            miss = np.flatnonzero(out < 0)
        for i in miss:
            v = flat[i]
            if self.num_oov_buckets <= 0:
                raise ValueError(f"out-of-vocabulary value {v!r} for column {self.name}")
            out[i] = base + fingerprint64(str(v)) % self.num_oov_buckets
        return out.reshape(values.shape)


@dataclass(frozen=True)
class BucketizedFeature:
    """``bucketized_column`` equivalent: boundaries b yield len(b)+1 buckets,
    with bucket(i) covering [b[i-1], b[i]) (values == boundary go right)."""

    name: str
    boundaries: tuple

    @property
    def num_buckets(self) -> int:
        return len(self.boundaries) + 1

    def encode(self, values: np.ndarray) -> np.ndarray:
        values = np.asarray(values)
        return np.searchsorted(
            np.asarray(self.boundaries, dtype=np.float64), values.astype(np.float64), side="right"
        ).astype(np.int32)


@dataclass(frozen=True)
class IdentityFeature:
    """``categorical_column_with_identity`` equivalent (ids clamped to range)."""

    name: str
    num_buckets: int

    def encode(self, values: np.ndarray) -> np.ndarray:
        values = np.asarray(values).astype(np.int64)
        return np.clip(values, 0, self.num_buckets - 1).astype(np.int32)


@dataclass(frozen=True)
class NumericFeature:
    """``numeric_column`` equivalent: raw float value, no id space."""

    name: str

    def encode(self, values: np.ndarray) -> np.ndarray:
        return np.asarray(values, dtype=np.float32)


def ml_100k_features() -> list:
    """The 26 categorical feature columns of the reference, in order
    (reference trainers/ml_100k.py:18-39)."""
    feats = [
        HashFeature("user_id", 1000, dtype="int32"),
        HashFeature("item_id", 2000, dtype="int32"),
        BucketizedFeature("age", tuple(range(15, 66, 10))),
        VocabFeature("gender", ("F", "M"), num_oov_buckets=1),
        HashFeature("occupation", 50),
        HashFeature("zipcode", 1000),
        BucketizedFeature("release_year", tuple(range(1930, 1991, 10))),
    ]
    feats.extend(IdentityFeature(g, 2) for g in GENRE)
    return feats


@dataclass(frozen=True)
class FeatureSet:
    """An ordered set of categorical + numeric features sharing one id space.

    ``offsets[f]`` is the start row of field f in the unified table;
    ``total_buckets`` is the table's logical row count.
    """

    categorical: tuple
    numeric: tuple = ()

    @property
    def num_fields(self) -> int:
        return len(self.categorical)

    @property
    def num_numeric(self) -> int:
        return len(self.numeric)

    @property
    def field_sizes(self) -> tuple:
        return tuple(f.num_buckets for f in self.categorical)

    @property
    def offsets(self) -> np.ndarray:
        sizes = np.asarray(self.field_sizes, dtype=np.int64)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)

    @property
    def total_buckets(self) -> int:
        return int(sum(self.field_sizes))

    def encode(self, columns: dict) -> dict:
        """Encode raw per-column arrays (name -> 1-D array) into a dense batch:
        ``cat_ids`` [B, num_fields] int32 of GLOBAL row ids and, if numeric
        features are configured, ``num_vals`` [B, num_numeric] float32."""
        offs = self.offsets
        n = len(np.asarray(columns[self.categorical[0].name]))
        cat_ids = np.empty((n, len(self.categorical)), dtype=np.int32)
        for i, f in enumerate(self.categorical):
            np.add(f.encode(columns[f.name]), offs[i], out=cat_ids[:, i],
                   casting="unsafe")
        batch = {"cat_ids": cat_ids}
        if self.numeric:
            batch["num_vals"] = np.stack(
                [f.encode(columns[f.name]) for f in self.numeric], axis=1
            )
        return batch


def ml_100k_feature_set(numeric: Sequence[str] = ()) -> FeatureSet:
    return FeatureSet(
        categorical=tuple(ml_100k_features()),
        numeric=tuple(NumericFeature(n) for n in numeric),
    )
