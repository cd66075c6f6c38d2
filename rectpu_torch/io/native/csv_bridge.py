"""The Python side of the native CSV loader (the port's copy of
``rectpu/io/native/csv_bridge.py``): a ``FeatureSet`` as the loader's spec
lines, and the encoded arrays of a file or of a window of its bytes."""

from __future__ import annotations

import ctypes

import numpy as np

from rectpu_torch.features.schema import (
    BucketizedFeature,
    FeatureSet,
    HashFeature,
    IdentityFeature,
    VocabFeature,
)
from rectpu_torch.io import native
from rectpu_torch.kernels import LaunchCount

# windows of bytes encoded natively (the streaming loader's), so a run can
# show that its input went through the native parser
windows = LaunchCount("csv_windows")


def build_spec(feature_set: FeatureSet, label_col: str, cutoff: float) -> str:
    """One line a feature, in the order of the encoded columns (see the
    header of ``csv_loader.cc``), then the label's."""
    lines = []
    for f in feature_set.categorical:
        if isinstance(f, HashFeature):
            kind = "int" if f.dtype == "int32" else "str"
            lines.append(f"hash:{f.name}:{f.num_buckets}:{kind}")
        elif isinstance(f, VocabFeature):
            lines.append(f"vocab:{f.name}:{f.num_oov_buckets}:{','.join(f.vocab)}")
        elif isinstance(f, BucketizedFeature):
            bounds = ",".join(repr(float(b)) for b in f.boundaries)
            lines.append(f"bucket:{f.name}:{bounds}")
        elif isinstance(f, IdentityFeature):
            lines.append(f"identity:{f.name}:{f.num_buckets}")
        else:
            raise TypeError(f"native loader cannot encode {type(f).__name__}")
    for f in feature_set.numeric:
        lines.append(f"numeric:{f.name}")
    lines.append(f"label:{label_col}:{cutoff}")
    return "\n".join(lines)


def _encode_handle(lib, h, feature_set: FeatureSet, label_col: str, cutoff: float) -> dict:
    try:
        err = lib.rectpu_csv_error(h)
        if err:
            raise RuntimeError(f"native csv open failed: {err.decode()}")
        rows = lib.rectpu_csv_rows(h)
        n_num = feature_set.num_numeric
        cat_ids = np.empty((rows, feature_set.num_fields), dtype=np.int32)
        num_vals = np.empty((rows, max(n_num, 1)), dtype=np.float32)
        labels = np.empty((rows,), dtype=np.float32)
        rc = lib.rectpu_csv_encode(
            h, build_spec(feature_set, label_col, cutoff).encode(),
            cat_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            err = lib.rectpu_csv_error(h)
            raise RuntimeError(f"native csv encode failed: {err.decode() if err else rc}")
        if n_num == 0:
            num_vals = np.zeros((rows, 0), dtype=np.float32)
        return {"cat_ids": cat_ids, "num_vals": num_vals, "labels": labels}
    finally:
        lib.rectpu_csv_free(h)


def encode_bytes(data: bytes, feature_set: FeatureSet, label_col: str, cutoff: float) -> dict:
    """Encode a window of CSV bytes, its header line first: the streaming
    loader's entry point, so the file is never resident."""
    lib = native.load()
    out = _encode_handle(lib, lib.rectpu_csv_open_mem(data, len(data), 8), feature_set,
                         label_col, cutoff)
    windows.add()
    return out


def load_and_encode(csv_path, feature_set: FeatureSet, label_col: str, cutoff: float) -> dict:
    """Parse and encode a whole CSV file: {cat_ids, num_vals, labels}."""
    lib = native.load()
    return _encode_handle(lib, lib.rectpu_csv_open(str(csv_path).encode(), 8), feature_set,
                          label_col, cutoff)
