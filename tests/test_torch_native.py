"""The port's native host library against rectpu's defining Python paths.

The port's C++ (``rectpu_torch/io/native``: FarmHash, the JSON request
parser, the CSV parser and encoder) is built with g++ at first use. Each
path is held exactly against rectpu's Python one (rectpu's own library is
not built here, so its ``hash_bucket`` and loaders run their Python and
pandas paths): bucket for bucket, column for column, batch for batch.
"""

import json

import numpy as np
import pytest

from rectpu.features.hashing import hash_bucket as jax_hash_bucket
from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.io.loader import CsvDataset as JaxCsvDataset
from rectpu.io.loader import StreamingCsvDataset as JaxStreaming
from rectpu.serve.server import instances_to_columns as jax_instances_to_columns
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.features.hashing import hash_bucket
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.io import native
from rectpu_torch.io.loader import CsvDataset, StreamingCsvDataset
from rectpu_torch.serve.export import ServingModel
from rectpu_torch.serve.server import parse_request_columns

BUCKETS = (1, 7, 1000, 2**31 - 1)

HASH_CASES = {
    "ints": np.array([0, 1, -1, 7, 942, 1682, 10**12, -(2**63), 2**63 - 1], dtype=np.int64),
    "int32": np.array([3, 30, 300, -5], dtype=np.int32),
    "bytes_leading_zeros": np.array([b"03364", b"00000", b"85711", b"T8H1N", b"0", b""],
                                    dtype="S5"),
    "ascii_str": np.array(["F", "M", "student", "", "x" * 40, "y" * 70]),
    "non_ascii": np.array(["café", "naïve", "東京", "x", "\U0001f600"]),
    "object_mixed": np.array([b"03364", "café", 12, "M"], dtype=object),
}


@pytest.mark.parametrize("case", list(HASH_CASES))
def test_hash_bucket_matches_rectpu(case):
    """Ints hash as decimal strings, S-dtype bytes as their bytes (a leading
    zero kept), non-ASCII text as its UTF-8: the native buckets equal
    rectpu's and the port's Python loop's."""
    values = HASH_CASES[case]
    for b in BUCKETS:
        got = hash_bucket(values, b)
        assert got.dtype == np.int32 and got.shape == values.shape
        np.testing.assert_array_equal(got, jax_hash_bucket(values, b), err_msg=f"{case} {b}")
        np.testing.assert_array_equal(got, hash_bucket(values, b, use_native=False))


def test_fingerprint_and_2d_shape():
    from rectpu_torch.features.hashing import fingerprint64_bytes

    for s in (b"", b"a", b"0123456789abcdef", b"x" * 17, b"y" * 33, b"z" * 65, b"w" * 200):
        assert native.fingerprint64(s) == fingerprint64_bytes(s)
    values = np.arange(12, dtype=np.int64).reshape(3, 4)
    np.testing.assert_array_equal(hash_bucket(values, 13), jax_hash_bucket(values, 13))


FAST_BODIES = {
    "ints_strings": {"instances": [
        {"user_id": 1, "item_id": 10, "age": 25, "gender": "F", "occupation": "student",
         "zipcode": "03364", "release_year": 1994, "action": 1},
        {"user_id": 7, "item_id": 55, "age": 40, "gender": "M", "occupation": "writer",
         "zipcode": "10027", "release_year": 1987, "action": 0}]},
    "floats_bools": {"instances": [{"user_id": 3, "x": 1.5, "flag": True},
                                   {"user_id": 4, "x": -2.25, "flag": False}]},
    "escapes_non_ascii": {"instances": [{"user_id": 1, "occupation": "café \"x\""},
                                        {"user_id": 2, "occupation": "東\\n"}]},
    "extra_top_level_key": {"signature_name": "serving_default",
                            "instances": [{"user_id": 9, "gender": "F"}]},
    "one_row": {"instances": [{"user_id": 5}]},
}


def _same_columns(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if w.dtype.kind == "U":
            assert g.dtype.kind == "S", k
            assert [x.decode("utf-8") for x in g.tolist()] == w.tolist(), k
        else:
            assert g.dtype.kind in "if" and (g.dtype.kind == "f") == (w.dtype.kind == "f"), k
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)


@pytest.mark.parametrize("ascii_only", [True, False])
@pytest.mark.parametrize("case", list(FAST_BODIES))
def test_json_columns_match_rectpus_json_loads_path(case, ascii_only):
    """Bodies with \\u escapes (json.dumps' default) and with raw UTF-8."""
    raw = json.dumps(FAST_BODIES[case], ensure_ascii=ascii_only).encode()
    parsed = native.parse_json_instances(raw)
    assert parsed is not None
    columns, n = parsed
    instances = json.loads(raw)["instances"]
    assert n == len(instances)
    _same_columns(columns, jax_instances_to_columns(instances))
    got, n2 = parse_request_columns(raw)
    assert n2 == n and sorted(got) == sorted(columns)
    plain, n3 = parse_request_columns(raw, use_native=False)
    assert n3 == n
    _same_columns(got, plain)


SLOW_BODIES = {
    "nested": b'{"instances": [{"user_id": [1, 2]}]}',
    "mixed_column": b'{"instances": [{"zipcode": "85711"}, {"zipcode": 10027}]}',
    "inconsistent_keys": b'{"instances": [{"user_id": 1}, {"item_id": 2}]}',
    "null": b'{"instances": [{"user_id": null}]}',
    "lone_surrogate": b'{"instances": [{"occupation": "\\ud800"}]}',
    "nul_char": b'{"instances": [{"occupation": "a\\u0000"}]}',
    "malformed": b'{"instances": [{"user_id": 1}',
    "empty": b"",
}


@pytest.mark.parametrize("case", list(SLOW_BODIES))
def test_json_out_of_shape_bodies_fall_back_to_json_loads(case):
    raw = SLOW_BODIES[case]
    assert native.parse_json_instances(raw) is None
    try:
        want = parse_request_columns(raw, use_native=False)
    except Exception as e:  # json.loads' errors are the behaviour
        with pytest.raises(type(e)):
            parse_request_columns(raw)
        return
    got = parse_request_columns(raw)
    assert got[1] == want[1] and sorted(got[0]) == sorted(want[0])


def test_request_encode_is_the_same_either_way():
    """A 64-instance body parsed natively or by json.loads encodes to the
    same model inputs (the server's request path)."""
    from rectpu_torch.models import DeepFMModel, TowerConfig

    rng = np.random.default_rng(0)
    body = {"instances": [
        {"user_id": int(rng.integers(1, 943)), "item_id": int(rng.integers(1, 1683)),
         "age": int(rng.integers(7, 73)), "gender": ["F", "M"][i % 2],
         "occupation": ["student", "writer", "none"][i % 3],
         "zipcode": f"{int(rng.integers(0, 99999)):05d}",
         "release_year": int(rng.integers(1922, 1999)), "drama": i % 2}
        for i in range(64)]}
    raw = json.dumps(body).encode()
    model = DeepFMModel(TowerConfig(feature_set=ml_100k_feature_set()))
    served = ServingModel(model, model.cfg.feature_set, device="cpu")
    a = served.encode_request(parse_request_columns(raw)[0])
    b = served.encode_request(parse_request_columns(raw, use_native=False)[0])
    np.testing.assert_array_equal(a["cat_ids"], b["cat_ids"])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    files = write_synthetic_dataset(d / "data", train_rows=700, test_rows=200, seed=5)
    quoted = d / "q.csv"
    quoted.write_text(
        "user_id,item_id,rating,age,gender,occupation,zipcode,release_year,title,action\n"
        '1,2,5,30,F,student,85711,1994,"Movie, The (1994)",1\n'
        '3,4,2,,M,"say ""hi""",,1950,plain,0\n'
        "5,6,4,45,,engineer,00000,,x,1\n"
    )
    return {**files, "quoted": str(quoted)}


@pytest.mark.parametrize("file,numeric", [
    ("train", ()), ("test", ("age", "release_year")), ("train", ("action", "drama")),
    ("quoted", ()), ("quoted", ("action",)),
])
def test_csv_dataset_matches_rectpus_pandas_loader(data, file, numeric):
    ds = CsvDataset(data[file], ml_100k_feature_set(numeric=numeric), use_native=True)
    ref = JaxCsvDataset(data[file], jax_feature_set(numeric=numeric), use_native=False)
    plain = CsvDataset(data[file], ml_100k_feature_set(numeric=numeric), use_native=False)
    for k in ("cat_ids", "num_vals", "labels"):
        np.testing.assert_array_equal(getattr(ds, k), getattr(ref, k), err_msg=k)
        np.testing.assert_array_equal(getattr(ds, k), getattr(plain, k), err_msg=k)
        assert getattr(ds, k).dtype == getattr(ref, k).dtype
    if file == "quoted":
        np.testing.assert_array_equal(ds.labels, [1.0, 0.0, 0.0])


def test_streaming_windows_match_rectpu(data):
    """The native windows, in rectpu's chunk and window order, give rectpu's
    batches (its pandas windows), and the default (None) is native."""
    from rectpu_torch.io.native import csv_bridge

    fs, jfs = ml_100k_feature_set(numeric=("drama",)), jax_feature_set(numeric=("drama",))
    port = StreamingCsvDataset(data["train"], fs, chunk_rows=100, window_chunks=3,
                               prefetch=False)
    ref = JaxStreaming(data["train"], jfs, chunk_rows=100, window_chunks=3, use_native=False,
                       prefetch=False)
    csv_bridge.windows.reset()
    got_it, want_it = port.train_batches(64, seed=3), ref.train_batches(64, seed=3)
    for _ in range(25):  # more than two epochs of 700 rows
        (g, gs), (w, ws) = next(got_it), next(want_it)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert (gs.epoch, gs.index) == (ws.epoch, ws.index)
    assert csv_bridge.windows.value >= 6
    for g, w in zip(port.eval_batches(64), ref.eval_batches(64)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """g++'s error surfaces; nothing falls back to Python."""
    from rectpu_torch.io.native import build

    bad = tmp_path / "farmhash.cc"
    bad.write_text("this is not C++\n")
    for name in build.SOURCES[1:]:
        (tmp_path / name).write_text((build.HERE / name).read_text())
    monkeypatch.setattr(build, "HERE", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_bindings_match_the_c_entries():
    """Every ctypes binding names an ``extern "C"`` function of the sources
    with as many parameters."""
    import re

    from rectpu_torch.io.native import build

    text = "".join((build.HERE / name).read_text() for name in build.SOURCES)
    for fn, (argtypes, _) in native._SIGNATURES.items():
        m = re.search(r'extern "C" [\w\s\*]+?\b' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        assert len([a for a in m.group(1).split(",") if a.strip()]) == len(argtypes), fn
