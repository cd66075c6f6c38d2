"""The encoded-dataset cache: the port of ``rectpu/io/records.py``.

The encoded dataset (global ids + numeric values + labels) is cached in one
``.npz`` next to the CSV, keyed by a fingerprint of the feature spec and
stamped with the file's size and mtime, so a CSV is parsed at most once per
(file, schema) pair. The fingerprint, the file name, the stamp and the
arrays are rectpu's, so either package reads the cache file the other wrote.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from rectpu_torch.features.schema import FeatureSet
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

CACHE_VERSION = 1


def _spec_fingerprint(feature_set: FeatureSet, label_col: str, cutoff: float) -> str:
    desc = {
        "version": CACHE_VERSION,
        "label": [label_col, cutoff],
        "categorical": [repr(f) for f in feature_set.categorical],
        "numeric": [repr(f) for f in feature_set.numeric],
    }
    return hashlib.sha256(json.dumps(desc, sort_keys=True).encode()).hexdigest()[:16]


def cache_path(csv_path: str | Path, fingerprint: str) -> Path:
    csv_path = Path(csv_path)
    return csv_path.parent / f".{csv_path.name}.{fingerprint}.rectpu.npz"


def load_cached(csv_path, feature_set, label_col: str = "rating", cutoff: float = 5):
    """Return encoded arrays for the CSV, via cache when fresh."""
    csv_path = Path(csv_path)
    fp = _spec_fingerprint(feature_set, label_col, cutoff)
    cpath = cache_path(csv_path, fp)
    stat = csv_path.stat()
    stamp = f"{stat.st_size}:{stat.st_mtime_ns}"
    if cpath.exists():
        try:
            with np.load(cpath, allow_pickle=False) as z:
                if str(z["stamp"]) == stamp:
                    logger.debug("dataset cache hit: %s", cpath)
                    return {
                        "cat_ids": z["cat_ids"],
                        "num_vals": z["num_vals"],
                        "labels": z["labels"],
                    }
        except Exception:
            pass  # corrupt/stale cache: rebuild

    from rectpu_torch.io.loader import CsvDataset

    ds = CsvDataset(csv_path, feature_set, label_col=label_col, cutoff=cutoff)
    arrays = {"cat_ids": ds.cat_ids, "num_vals": ds.num_vals, "labels": ds.labels}
    tmp = cpath.with_suffix(".tmp.npz")
    np.savez(tmp, stamp=stamp, **arrays)
    tmp.rename(cpath)
    logger.debug("dataset cache written: %s", cpath)
    return arrays
