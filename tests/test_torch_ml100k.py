"""The port's ml-100k ETL and CLI, its restore paths, and check (3).

  - ETL: ``rectpu_torch.data.ml_100k`` (no pandas) against rectpu's (pandas)
    on fabricated raw GroupLens files, as ``tests/test_etl.py`` makes them,
    and on a second set with what pandas' inference decides: zipcodes with
    leading zeros, letters and a missing one, a title with a comma, quotes
    and a latin-1 letter, a blank and a malformed release date (a float
    release_year), ratings of a dropped user and item, a timestamp at
    midnight: the five CSVs byte for byte. ``local --synthetic`` writes the
    same bytes as rectpu's.
  - Dense restore: 6 steps straight equal 3 steps, a checkpoint, a restore
    and 3 more, bit for bit (every parameter and optimizer-state leaf, the
    step and the data position), through the port's CLIs in four configs.
  - Warm start, both ways between the packages: from a job dir, its export
    and its ``ckpt-N`` directory the warm-started export holds the source's
    parameters bit for bit; ``--warm-start-vars`` loads only the named
    subtrees; a shape mismatch raises.
  - Check (3) of ROADMAP.md's North star (``slow``): reference-default
    DeepFM on the synthetic ml-100k for 20,000 steps. (a) Both packages
    warm-start from rectpu's step-0 export with dropout 0: the port's
    streaming AUC within 0.002 of rectpu's. (b) The port's default run at
    ``--seed 42``: its AUC is reported beside rectpu's pin 0.8124665 with
    whether it lies within 0.002; the seed spread (sd 0.0035 over seeds) is
    wider than that gate, so (b) is reported, not asserted.
"""

import json
import time

import numpy as np
import pytest
import torch

from rectpu.data import ml_100k as jax_etl
from rectpu.trainers import deep_fm as jax_deep_fm_cli
from rectpu_torch.data import ml_100k as etl
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.serve.export import latest_export
from rectpu_torch.train.checkpoint import _load_flat_npz
from rectpu_torch.trainers import deep_fm as deep_fm_cli
from rectpu_torch.trainers import linear_deep as linear_deep_cli

PIN_AUC = 0.8124665  # RESULTS.md round-5 parity gate, rectpu on the TPU
GATE = 0.002  # BASELINE.md


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RAW_SETS = {
    # tests/test_etl.py:11-27
    "test_etl": {
        "u.user": b"1|24|M|technician|85711\n2|53|F|other|94043\n3|23|M|writer|32067\n",
        "u.item": (b"1|Toy Story (1995)|01-Jan-1995||http://imdb/1|0|0|0|1|1|1|0|0|0|0|0|0|0|0"
                   b"|0|0|0|0|0\n"
                   b"2|GoldenEye (1995)|01-Jan-1995||http://imdb/2|0|1|1|0|0|0|0|0|0|0|0|0|0|0"
                   b"|0|0|1|0|0\n"
                   b"3|unknown||||1|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0\n"),
        "u.data": b"1\t1\t5\t874965758\n2\t2\t3\t888550871\n3\t1\t4\t889237482\n1\t2\t2\t878542960\n",
        "ua.base": b"1\t1\t5\t874965758\n2\t2\t3\t888550871\n3\t1\t4\t889237482\n"
                   b"1\t2\t2\t878542960\n",
        "ua.test": b"1\t1\t5\t874965758\n",
    },
    "inference": {
        "u.user": b"1|24|M|technician|85711\n2|53|F|other|01002\n3|23|M|writer|T8H1N\n"
                  b"4|33|F|artist|NA\n",
        "u.item": ("1|Toy Story (1995)|01-Jan-1995||http://imdb/1|0|0|0|1|1|1|0|0|0|0|0|0|0|0|0"
                   "|0|0|0|0\n"
                   "2|City of Lost Children, The (1995)|15-Dec-1995||http://imdb/2|0|1|1|0|0|0|0"
                   "|0|0|0|0|0|0|0|0|0|1|0|0\n"
                   "3|unknown||||1|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0\n"
                   "4|Caf\xe9 \"Noir\" (1994)|||http://imdb/4|0|0|0|0|0|0|0|0|1|0|0|0|0|0|0|0|0"
                   "|0|0\n"
                   "5|Ghost|bad-date||http://imdb/5|0|0|0|0|0|0|0|0|1|0|0|0|0|0|0|0|0|0|0\n\n"
                   ).encode("latin-1"),
        "u.data": b"1\t1\t5\t874965758\n2\t2\t3\t888550871\n3\t1\t4\t889237482\n"
                  b"9\t1\t1\t878542960\n4\t4\t3\t86400\n2\t5\t1\t0\n3\t3\t4\t889237482\n"
                  b"1\t4\t2\t893286638\n",
        "ua.base": b"1\t1\t5\t874965758\n4\t4\t3\t86400\n2\t5\t1\t0\n1\t2\t2\t878542960\n",
        "ua.test": b"1\t1\t5\t874965758\n3\t3\t4\t889237482\n",
    },
}


@pytest.mark.parametrize("raw", list(RAW_SETS))
def test_etl_writes_rectpus_bytes(raw, tmp_path):
    src = tmp_path / "raw"
    src.mkdir()
    for name, data in RAW_SETS[raw].items():
        (src / name).write_bytes(data)
    for name, mod in (("jax", jax_etl), ("port", etl)):
        (tmp_path / name).mkdir()
        mod.save_data(mod.process_data(mod.load_data(src)), tmp_path / name)
    for table in ("all", "train", "test", "users", "items"):
        want = (tmp_path / "jax" / f"{table}.csv").read_bytes()
        assert (tmp_path / "port" / f"{table}.csv").read_bytes() == want, table
    frames = etl.process_data(etl.load_data(src))
    assert etl.DATA_CONFIG == jax_etl.DATA_CONFIG
    assert list(frames["users"].columns) == etl.DATA_CONFIG["users"]["columns"] + [
        "zipcode1", "zipcode2", "zipcode3"]


def test_local_synthetic_cli_writes_rectpus_bytes(tmp_path, monkeypatch):
    """``local --synthetic`` writes rectpu's bytes; ``gcp`` (which raised
    until the BigQuery variant was ported) runs its pipeline against a stub
    client, the download replaced by the fabricated raw files."""
    from test_torch_bigquery import install_stub

    for name, mod in (("jax", jax_etl), ("port", etl)):
        mod.main(["local", "--synthetic", "--synthetic-rows", "1500", "--dest",
                  str(tmp_path / name), "--log-path", str(tmp_path / f"{name}.log")])
    for split in ("train", "test", "all"):
        want = (tmp_path / "jax" / "ml-100k" / f"{split}.csv").read_bytes()
        assert (tmp_path / "port" / "ml-100k" / f"{split}.csv").read_bytes() == want, split
    stub = install_stub(monkeypatch)

    def download(url, dest):
        (tmp_path / "gcp" / "ml-100k").mkdir(parents=True)
        for name, data in RAW_SETS["test_etl"].items():
            (tmp_path / "gcp" / "ml-100k" / name).write_bytes(data)

    monkeypatch.setattr(etl, "download_data", download)
    etl.main(["gcp", "--dest", str(tmp_path / "gcp"), "--credentials",
              str(tmp_path / "none.json"), "--log-path", str(tmp_path / "gcp.log")])
    (client,) = stub.clients
    assert [c[:3] for c in client.calls if c[0] == "load"] == [
        ("load", "ml_100k", name) for name in etl.RAW_TABLES]
    assert sum(c[0] == "extract" for c in client.calls) == 5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_synthetic_dataset(tmp_path_factory.mktemp("ml100k_data"), train_rows=400,
                                   test_rows=100, seed=3)


def _argv(data, job, steps, *flags):
    return ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
            "--job-dir", str(job), "--train-steps", str(steps), "--batch-size", "32",
            "--steps-per-loop", "3", "--save-checkpoints-steps", "3", *flags]


def _ckpt(job, step):
    d = job / f"ckpt-{step}"
    return _load_flat_npz(d / "arrays.npz"), json.loads((d / "meta.json").read_text())


# name: (CLI, flags)
RESTORE_CASES = {
    "defaults": (deep_fm_cli, []),
    "scaled_dense": (deep_fm_cli, ["--preset", "scaled", "--fast-step", "off"]),
    "bf16_sr_slots_bf16_table": (deep_fm_cli, ["--optimizer-slot-dtype", "bfloat16-sr",
                                               "--table-dtype", "bfloat16"]),
    "wide_deep_per_tower": (linear_deep_cli, []),
}


@pytest.mark.parametrize("case", list(RESTORE_CASES))
def test_dense_restore_is_bitwise(case, data, tmp_path):
    cli, flags = RESTORE_CASES[case]
    straight = tmp_path / "straight"
    cli.train_and_evaluate(cli.build_parser().parse_args(_argv(data, straight, 6, *flags)))
    split = tmp_path / "split"
    cli.train_and_evaluate(cli.build_parser().parse_args(_argv(data, split, 3, *flags)))
    cli.train_and_evaluate(cli.build_parser().parse_args(
        _argv(data, split, 6, "--restore", *flags)))
    (a, meta_a), (b, meta_b) = _ckpt(straight, 6), _ckpt(split, 6)
    assert set(a) == set(b) and any(k.startswith("opt_state/") for k in a)
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key
    assert meta_a["step"] == meta_b["step"] == 6
    assert meta_a["data_state"] == meta_b["data_state"]


@pytest.fixture(scope="module")
def sources(data, tmp_path_factory):
    """A port DeepFM job and a rectpu one, 6 steps each: {package: job dir}."""
    root = tmp_path_factory.mktemp("ws_sources")
    deep_fm_cli.train_and_evaluate(deep_fm_cli.build_parser().parse_args(
        _argv(data, root / "port", 6)))
    argv = [a for a in _argv(data, root / "jax", 6) if a not in ("--device", "cpu")]
    jax_deep_fm_cli.train_and_evaluate(jax_deep_fm_cli.build_parser().parse_args(argv))
    return {"port": root / "port", "jax": root / "jax"}


def _source_params(job):
    return _load_flat_npz(latest_export(job) / "arrays.npz")


def _warm(package, data, job, source, *flags):
    """A --train-steps 0 run of ``package``'s DeepFM CLI warm-started from
    ``source``; returns its export's parameters."""
    argv = _argv(data, job, 0, "--warm-start-from", str(source), *flags)
    if package == "port":
        deep_fm_cli.train_and_evaluate(deep_fm_cli.build_parser().parse_args(argv))
    else:
        argv = [a for a in argv if a not in ("--device", "cpu")]
        jax_deep_fm_cli.train_and_evaluate(jax_deep_fm_cli.build_parser().parse_args(argv))
    return _load_flat_npz(latest_export(job) / "arrays.npz")


@pytest.mark.parametrize("kind", ["job_dir", "export", "ckpt"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_warm_start_carries_the_sources_params(direction, kind, sources, data, tmp_path):
    src_pkg, dst_pkg = direction.split("_to_")
    job = sources[src_pkg]
    source = {"job_dir": job, "export": latest_export(job), "ckpt": job / "ckpt-6"}[kind]
    got = _warm(dst_pkg, data, tmp_path / "warm", source)
    want = _source_params(job)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_warm_start_partial_and_shape_mismatch(direction, sources, data, tmp_path):
    """A bigger tower warm-starts only 'emb' and 'linear' (the MLP keeps the
    fresh init of a cold run with the same seed); a different embedding size
    raises."""
    src_pkg, dst_pkg = direction.split("_to_")
    want = _source_params(sources[src_pkg])
    flags = ("--hidden-units", "32", "16")
    got = _warm(dst_pkg, data, tmp_path / "partial", sources[src_pkg], *flags,
                "--warm-start-vars", "emb", "linear")
    cold = _warm(dst_pkg, data, tmp_path / "cold", sources[src_pkg], *flags,
                 "--warm-start-vars", "linear")
    for key in ("emb", "linear/w", "linear/b"):
        assert torch.equal(got[key], want[key]), key
    assert got["mlp/0/kernel"].shape == (104, 32)
    assert torch.equal(got["mlp/0/kernel"], cold["mlp/0/kernel"])
    assert not torch.equal(cold["emb"], want["emb"])
    with pytest.raises(ValueError, match="shape mismatch"):
        _warm(dst_pkg, data, tmp_path / "mismatch", sources[src_pkg], "--embedding-size", "8")


def _run(package, data, job, *flags):
    argv = ["--train-csv", data["train"], "--test-csv", data["test"], "--job-dir", str(job),
            "--save-checkpoints-steps", "1000000", *flags]
    if package == "port":
        metrics, _ = deep_fm_cli.train_and_evaluate(
            deep_fm_cli.build_parser().parse_args(["--device", "cpu", *argv]))
        return metrics
    return jax_deep_fm_cli.train_and_evaluate(jax_deep_fm_cli.build_parser().parse_args(argv))


@pytest.mark.slow
def test_check3_ml100k_auc(tmp_path, record_property):
    """Check (3): reference-default DeepFM (K=4, [16, 16], dropout 0.1, batch
    32, Adam 1e-3) on the synthetic ml-100k (90,570 / 9,057 rows), 20,000
    steps, the streaming AUC."""
    torch.set_num_threads(max(torch.get_num_threads(), 4))
    etl.main(["local", "--synthetic", "--dest", str(tmp_path / "data"),
              "--log-path", str(tmp_path / "etl.log")])
    data = {s: str(tmp_path / "data" / "ml-100k" / f"{s}.csv") for s in ("train", "test")}
    # (a) the matched run: both packages from rectpu's step-0 params, dropout 0
    _run("jax", data, tmp_path / "init", "--train-steps", "0")
    init = latest_export(tmp_path / "init")
    t0 = time.time()
    auc_a = {pkg: _run(pkg, data, tmp_path / f"a_{pkg}", "--warm-start-from", str(init),
                       "--dropout", "0")["auc"] for pkg in ("jax", "port")}
    # (b) the port's default run at --seed 42
    auc_b = _run("port", data, tmp_path / "b", "--seed", "42")["auc"]
    report = {"a_rectpu": auc_a["jax"], "a_port": auc_a["port"],
              "a_gap": auc_a["port"] - auc_a["jax"], "b_port": auc_b, "b_pin": PIN_AUC,
              "b_gap": auc_b - PIN_AUC, "b_within_gate": abs(auc_b - PIN_AUC) <= GATE,
              "seconds": time.time() - t0}
    print(f"check (3): {json.dumps(report)}")
    for k, v in report.items():
        record_property(k, v)
    assert abs(report["a_gap"]) <= GATE, report
    assert np.isfinite(auc_b) and 0.5 < auc_b < 1.0, report
