"""The rest of the trainer surface against rectpu: the best exporter, the
streaming CSV input and TensorBoard event files.

  - ``serve.export.make_exporter``: both packages' exporters fed the same
    metric sequences, with a restart (a new exporter on the same job dir)
    in the middle, write exports at the same steps, keep the same last
    ``exports_to_keep`` and the same ``best_metric.json``.
  - ``io.loader.StreamingCsvDataset``: the batch stream (ids, numeric
    values, labels and the DataState after each batch) is rectpu's
    ``StreamingCsvDataset(use_native=False)``'s exactly, over two epochs,
    after a resume in the middle of an epoch, on each of two shards, with a
    stored row placement and on a file whose quoted fields hold newlines; so
    is the padded eval pass.
  - ``utils.events.EventWriter``: with the wall clock fixed, the file is
    rectpu's byte for byte; a trainer CLI run writes the tags rectpu's writes
    at the same steps (both files read back by ``utils.events.read_events``,
    which checks every record's CRCs).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.io.loader import StreamingCsvDataset as JaxStreaming
from rectpu.models import DCNModel as JaxDCN
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.serve.export import make_exporter as jax_make_exporter
from rectpu.trainers import dcn as jax_dcn_cli
from rectpu.utils import events as jax_events
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.io.loader import DataState, StreamingCsvDataset
from rectpu_torch.models import DCNModel, TowerConfig
from rectpu_torch.serve.export import make_exporter
from rectpu_torch.trainers import dcn as dcn_cli
from rectpu_torch.utils import events

# --- the best exporter ---------------------------------------------------------

# (mode, metric, the metric's values at steps 1..8; None: the metric missing)
EXPORTER_CASES = {
    "best_auc": ("best", "auc", [0.60, 0.58, 0.65, 0.65, None, 0.70, 0.69, 0.72]),
    "best_average_loss": ("best", "average_loss", [0.50, 0.52, 0.47, 0.47, 0.40, None, 0.45,
                                                   0.39]),
    "best_accuracy_never_better": ("best", "accuracy", [0.9, 0.8, 0.9, 0.7, 0.6, 0.9, 0.5,
                                                        0.4]),
    "latest": ("latest", "auc", [0.60, 0.58, 0.65, 0.65, 0.70, 0.69, 0.72, 0.71]),
}


def _exported_steps(job_dir) -> list:
    base = job_dir / "export" / "exporter"
    if not base.exists():
        return []
    return [json.loads((d / "model.json").read_text())["step"] for d in sorted(base.iterdir())]


@pytest.mark.parametrize("case", list(EXPORTER_CASES))
def test_best_exporter_matches_rectpu(case, tmp_path):
    mode, metric, values = EXPORTER_CASES[case]
    cfg = dict(embedding_size=4, hidden_units=(4,))
    model_t = DCNModel(TowerConfig(feature_set=ml_100k_feature_set(), **cfg),
                       num_cross_layers=1)
    model_j = JaxDCN(JaxTowerConfig(feature_set=jax_feature_set(), **cfg), num_cross_layers=1)
    params = jax.tree.map(lambda t: t.numpy(), model_t.init(torch.Generator().manual_seed(0)))
    sides = {"port": (lambda: make_exporter(model_t, tmp_path / "port", mode=mode,
                                            compare_metric=metric), params),
             "rectpu": (lambda: jax_make_exporter(model_j, tmp_path / "rectpu", mode=mode,
                                                  compare_metric=metric),
                        jax.tree.map(jnp.asarray, params))}
    bests = {name: [] for name in sides}
    for name, (make, tree) in sides.items():
        exporter = make()
        for step, value in enumerate(values, start=1):
            if step == 4:
                exporter = make()  # a restarted run: the best so far comes from the file
            metrics = {"count": 100.0} if value is None else {metric: value, "count": 100.0}
            exporter(tree, step, metrics=metrics)
            time.sleep(0.002)  # exports are named by the millisecond
            best = tmp_path / name / "best_metric.json"
            bests[name].append(best.read_text() if best.exists() else None)
    assert bests["port"] == bests["rectpu"]
    got, want = _exported_steps(tmp_path / "port"), _exported_steps(tmp_path / "rectpu")
    assert got == want and len(got) <= 5
    if mode == "latest":
        assert got == [4, 5, 6, 7, 8] and bests["port"][-1] is None


def test_exporter_rejects_an_unknown_mode(tmp_path):
    model = DCNModel(TowerConfig(feature_set=ml_100k_feature_set()))
    with pytest.raises(ValueError, match="unknown exporter mode"):
        make_exporter(model, tmp_path, mode="first")


# --- the streaming CSV input ---------------------------------------------------

CHUNK_ROWS, WINDOW_CHUNKS, BATCH = 64, 2, 48
NUMERIC = ("action",)


@pytest.fixture(scope="module")
def csv_files(tmp_path_factory):
    """The synthetic train CSV (550 rows: 9 chunks of 64, the last short) and
    a copy whose zipcode fields are quoted, every seventh with a newline in
    it (a row that spans two lines)."""
    d = tmp_path_factory.mktemp("stream")
    files = write_synthetic_dataset(d / "data", train_rows=550, test_rows=130, seed=4)
    lines = open(files["train"], newline="").read().split("\n")
    header = lines[0].split(",")
    z = header.index("zipcode")
    quoted = [lines[0]]
    for i, line in enumerate(lines[1:]):
        if not line:
            quoted.append(line)
            continue
        cols = line.split(",")
        cols[z] = f'"{cols[z][:2]}\n{cols[z][2:]}"' if i % 7 == 0 else f'"{cols[z]}"'
        quoted.append(",".join(cols))
    (d / "quoted.csv").write_text("\n".join(quoted))
    return {"train": files["train"], "test": files["test"], "quoted": str(d / "quoted.csv")}


def _streams(path, prefetch: bool = True):
    """The port's dataset (its windows parsed ahead on a thread when
    ``prefetch``) and rectpu's. rectpu's parses on the calling thread: its
    pandas parse of a window on the prefetch thread crashed this process
    (a segmentation fault in pandas' Arrow strings) once torch was loaded;
    prefetching changes when a window is parsed, not what it holds."""
    port = StreamingCsvDataset(path, ml_100k_feature_set(numeric=NUMERIC),
                               chunk_rows=CHUNK_ROWS, window_chunks=WINDOW_CHUNKS,
                               prefetch=prefetch)
    ref = JaxStreaming(path, jax_feature_set(numeric=NUMERIC), chunk_rows=CHUNK_ROWS,
                       window_chunks=WINDOW_CHUNKS, use_native=False, prefetch=False)
    return port, ref


def _take(it, n):
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (bg, sg), (bw, sw) in zip(got, want):
        assert sorted(bg) == sorted(bw)
        for k in bw:
            np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)
            assert bg[k].dtype == bw[k].dtype, k
        assert (sg.epoch, sg.index, sg.seed) == (sw.epoch, sw.index, sw.seed)


@pytest.mark.parametrize("file,prefetch", [("train", True), ("quoted", False)])
def test_streaming_batches_match_rectpu_over_two_epochs_and_a_resume(csv_files, file, prefetch):
    port, ref = _streams(csv_files[file], prefetch=prefetch)
    assert (port.size, port.num_chunks) == (ref.size, ref.num_chunks) == (550, 9)
    assert port._chunk_offsets == ref._chunk_offsets
    n = 2 * 550 // BATCH + 1  # past the second epoch's end
    got = _take(port.train_batches(BATCH, seed=3), n)
    _same_batches(got, _take(ref.train_batches(BATCH, seed=3), n))
    assert got[-1][1].epoch == 2
    # resume in the middle of the first epoch's second window
    state = got[4][1]
    assert state.epoch == 0 and CHUNK_ROWS * WINDOW_CHUNKS < state.index
    resumed = _take(port.train_batches(BATCH, state=DataState(**vars(state))), 8)
    _same_batches(resumed, _take(ref.train_batches(BATCH, state=state), 8))
    _same_batches(resumed, got[5:13])


def test_streaming_shards_row_placement_and_eval_match_rectpu(csv_files):
    perm = np.random.default_rng(0).permutation(
        ml_100k_feature_set(numeric=NUMERIC).total_buckets + 7).astype(np.int32)
    for shard in (0, 1):
        port, ref = _streams(csv_files["train"])
        port.apply_row_permutation(perm)
        ref.apply_row_permutation(perm)
        _same_batches(_take(port.train_batches(BATCH, seed=1, shard_id=shard, num_shards=2), 7),
                      _take(ref.train_batches(BATCH, seed=1, shard_id=shard, num_shards=2), 7))
        got = list(port.eval_batches(100, shard_id=shard, num_shards=2))
        want = list(ref.eval_batches(100, shard_id=shard, num_shards=2))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    port, ref = _streams(csv_files["test"])
    got, want = list(port.eval_batches(64)), list(ref.eval_batches(64))
    assert len(got) == len(want) == 3 and got[-1]["weights"].sum() == 130 - 128
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_streaming_native_loader_is_not_ported(csv_files):
    """(Named when the native loader was missing.) ``use_native=True`` now
    encodes every window through the native library: the same batches as the
    Python path's and rectpu's, one native window a window loaded."""
    from rectpu_torch.io.native import csv_bridge

    fs = ml_100k_feature_set(numeric=NUMERIC)
    kw = dict(chunk_rows=CHUNK_ROWS, window_chunks=WINDOW_CHUNKS, prefetch=False)
    native = StreamingCsvDataset(csv_files["quoted"], fs, use_native=True, **kw)
    plain = StreamingCsvDataset(csv_files["quoted"], fs, use_native=False, **kw)
    ref = JaxStreaming(csv_files["quoted"], jax_feature_set(numeric=NUMERIC),
                       chunk_rows=CHUNK_ROWS, window_chunks=WINDOW_CHUNKS, use_native=False,
                       prefetch=False)
    csv_bridge.windows.reset()
    got = _take(native.train_batches(BATCH, seed=2), 14)
    assert csv_bridge.windows.value == 6  # 9 chunks in windows of 2: 5, then 1 of epoch 2
    _same_batches(got, _take(plain.train_batches(BATCH, seed=2), 14))
    _same_batches(got, _take(ref.train_batches(BATCH, seed=2), 14))


# --- TensorBoard event files ---------------------------------------------------


def test_crc32c_check_value():
    assert events.crc32c(b"123456789") == 0xE3069283  # the CRC-32C catalogue's check


def test_event_records_equal_rectpus(tmp_path, monkeypatch):
    """The same calls with the wall clock fixed write rectpu's bytes."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    rng = np.random.default_rng(0)
    histograms = {"params/w": rng.normal(0.0, 0.1, 5000).astype(np.float32),
                  "params/zeros": np.zeros(7, np.float32),
                  "params/mixed": np.concatenate([rng.normal(size=300), np.zeros(30),
                                                  [1e-13, -1e25]]),
                  "params/empty": np.zeros(0, np.float32)}
    writers = {"port": events.EventWriter(tmp_path / "port"),
               "rectpu": jax_events.EventWriter(tmp_path / "rectpu")}
    for w in writers.values():
        w.add_scalar("loss", 0.6931472, 100)
        w.add_scalar("examples_per_sec", 123456.789, 100)
        w.add_scalars({"eval/auc": 0.71, "eval/average_loss": 0.45, "eval/count": 9057.0}, 200)
        for tag, values in histograms.items():
            w.add_histogram(tag, values, 2**40)
            w.add_scalar(f"{tag}/fraction_of_zero_values",
                         float((values == 0).mean()) if values.size else 0.0, 2**40)
        w.close()
    (got,), (want,) = ((tmp_path / name).iterdir() for name in ("port", "rectpu"))
    assert got.name == want.name == "events.out.tfevents.1700000000.rectpu"
    assert got.read_bytes() == want.read_bytes()
    records = events.read_events(got)
    assert records[0] == (100, ["loss"]) and records[2] == (
        200, ["eval/auc", "eval/average_loss", "eval/count"])
    data = bytearray(got.read_bytes())
    data[-30] ^= 1
    got.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        events.read_events(got)


def test_trainer_cli_writes_rectpus_tags_at_rectpus_steps(tmp_path):
    """The DCN CLI, 100 steps in loops of 50 with an eval at 50: a log (loss,
    examples/s) at 100, eval scalars at 50 and 100, the parameter
    histograms and zero shares at 50; the tags in rectpu's order."""
    data = write_synthetic_dataset(tmp_path / "data", train_rows=400, test_rows=100, seed=2)
    argv = ["--train-csv", data["train"], "--test-csv", data["test"], "--train-steps", "100",
            "--batch-size", "16", "--steps-per-loop", "50", "--save-checkpoints-steps", "50",
            "--num-cross-layers", "2", "--hidden-units", "8"]
    jax_dcn_cli.train_and_evaluate(jax_dcn_cli.build_parser().parse_args(
        [*argv, "--job-dir", str(tmp_path / "rectpu")]))
    dcn_cli.train_and_evaluate(dcn_cli.build_parser().parse_args(
        [*argv, "--job-dir", str(tmp_path / "port"), "--device", "cpu"]))
    (got,), (want,) = (list((tmp_path / name).glob("events.out.tfevents.*"))
                       for name in ("port", "rectpu"))
    got, want = events.read_events(got), events.read_events(want)
    assert got == want
    steps = {step for step, _ in got}
    assert steps == {50, 100}
    tags = {t for _, ts in got for t in ts}
    assert {"loss", "examples_per_sec", "eval/auc", "params/cross/1/w",
            "params/top/0/kernel/fraction_of_zero_values"} <= tags
