"""The port's encoded-dataset cache (``rectpu_torch/io/records.py``) against
rectpu's (``rectpu/io/records.py``) on one synthetic ml-100k CSV, with and
without numeric columns: the spec fingerprint and the cache file's name are
rectpu's; a cache file either package writes is a hit for the other (its
encoder is not called), and the arrays equal the fresh encode of both
packages; a CSV that changes after the write is encoded again."""

import os

import numpy as np
import pytest

import rectpu.io.loader as jax_loader
import rectpu_torch.io.loader as loader
from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.io import records as jax_records
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.io import records

NUMERIC = ((), ("age", "action"))


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    return write_synthetic_dataset(tmp_path_factory.mktemp("records"), train_rows=600,
                                   test_rows=100, seed=4)["train"]


def _no_encode(*args, **kwargs):
    raise AssertionError("the cache missed: the CSV was encoded again")


@pytest.mark.parametrize("numeric", NUMERIC, ids=["no_numeric", "numeric"])
def test_fingerprint_and_file_name_are_rectpus(csv_path, numeric):
    for label, cutoff in (("rating", 5), ("rating", 4)):
        fp = records._spec_fingerprint(ml_100k_feature_set(numeric), label, cutoff)
        assert fp == jax_records._spec_fingerprint(jax_feature_set(numeric), label, cutoff)
        assert records.cache_path(csv_path, fp) == jax_records.cache_path(csv_path, fp)


@pytest.mark.parametrize("writer", ["port", "rectpu"])
@pytest.mark.parametrize("numeric", NUMERIC, ids=["no_numeric", "numeric"])
def test_each_package_reads_the_others_cache(csv_path, numeric, writer, monkeypatch):
    fs, jfs = ml_100k_feature_set(numeric), jax_feature_set(numeric)
    cpath = records.cache_path(csv_path, records._spec_fingerprint(fs, "rating", 5))
    cpath.unlink(missing_ok=True)
    if writer == "port":
        written = records.load_cached(csv_path, fs)
        monkeypatch.setattr(jax_loader, "CsvDataset", _no_encode)
        read = jax_records.load_cached(csv_path, jfs)
    else:
        written = jax_records.load_cached(csv_path, jfs)
        monkeypatch.setattr(loader, "CsvDataset", _no_encode)
        read = records.load_cached(csv_path, fs)
    assert cpath.exists()
    monkeypatch.undo()  # the encoders back, for the fresh encode
    want = loader.CsvDataset(csv_path, fs)
    for key in ("cat_ids", "num_vals", "labels"):
        np.testing.assert_array_equal(written[key], getattr(want, key))
        np.testing.assert_array_equal(read[key], getattr(want, key))
        assert read[key].dtype == getattr(want, key).dtype


def test_a_changed_csv_is_encoded_again(csv_path, tmp_path):
    path = tmp_path / "train.csv"
    path.write_bytes(open(csv_path, "rb").read())
    fs = ml_100k_feature_set()
    first = records.load_cached(path, fs)
    lines = path.read_text().splitlines(keepends=True)
    path.write_text("".join(lines[:-10]))
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    again = records.load_cached(path, fs)
    assert again["labels"].shape[0] == first["labels"].shape[0] - 10
    np.testing.assert_array_equal(jax_records.load_cached(path, jax_feature_set())["cat_ids"],
                                  again["cat_ids"])
