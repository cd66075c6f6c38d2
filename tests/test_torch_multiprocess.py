"""The DeepFM trainer CLI sharded over 2 and 4 ranks under
``torch.distributed.run`` on the CPU (Gloo) against the same CLI in one
process: the final eval metrics and the parameter digest of the last
checkpoint within rectpu's ``_assert_matches`` tolerances
(``tests/test_multiprocess.py:76``: metrics rtol 1e-4, atol 1e-5; digest
rtol 1e-5). Dropout is on, from the hash masks, which key on global rows and
so do not depend on the rank count. Also: a world that does not match the
mesh raises, also with ``--tp-mlp`` (``tests/test_torch_tp_cli.py`` runs
the tensor-parallel towers at 2 ranks).
"""

import shutil
import subprocess

import numpy as np
import pytest

from rectpu_torch.data.synthetic import write_synthetic_dataset
from torch_mp_worker import cli_command, cli_env, param_digest, run_cli


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_synthetic_dataset(tmp_path_factory.mktemp("mp_data"), train_rows=2000,
                                   test_rows=512, seed=11)


def _flags(data, job, *extra):
    return ["--train-csv", data["train"], "--test-csv", data["test"], "--job-dir", str(job),
            "--train-steps", "30", "--batch-size", "32", "--save-checkpoints-steps", "15",
            "--steps-per-loop", "5", "--dropout-impl", "hash", *extra]


def _assert_matches(single, multi, rtol=1e-4, atol=1e-5, digest_rtol=1e-5):
    assert multi[0]["count"] == 512
    for key in ("auc", "average_loss", "accuracy"):
        assert np.isclose(single[0][key], multi[0][key], rtol=rtol, atol=atol), \
            (key, single[0], multi[0])
    assert np.isclose(param_digest(single[1]), param_digest(multi[1]), rtol=digest_rtol)


def test_two_ranks_dedup_freq_placement_matches_one_rank(data, tmp_path):
    """--ep-mode dedup with --ep-row-placement freq and --ep-peer-capacity
    auto at 2 ranks; the single run takes the same row placement from its
    job dir (the stored-placement branch)."""
    multi = run_cli(2, *_flags(data, tmp_path / "m", "--num-model-shards", "2", "--ep-mode",
                               "dedup", "--ep-row-placement", "freq", "--ep-peer-capacity",
                               "auto"))
    perm = np.load(tmp_path / "m" / "row_perm.npy")
    assert not np.array_equal(perm, np.arange(perm.shape[0]))
    (tmp_path / "s").mkdir()
    shutil.copy(tmp_path / "m" / "row_perm.npy", tmp_path / "s" / "row_perm.npy")
    single = run_cli(1, *_flags(data, tmp_path / "s", "--restore"))
    _assert_matches(single, multi)


def test_four_ranks_2x2_matches_one_rank(data, tmp_path):
    """A 2x2 mesh (both axes span processes) in the flat layout over the 2d
    exchange with the mxu backward."""
    flat = ["--flat-layout", "--scatter-impl", "mxu"]
    single = run_cli(1, *_flags(data, tmp_path / "s", *flat))
    multi = run_cli(4, *_flags(data, tmp_path / "m", *flat, "--num-data-shards", "2",
                               "--num-model-shards", "2", "--ep-mode", "2d"))
    _assert_matches(single, multi)


def test_world_unlike_the_mesh_raises(data, tmp_path):
    proc = subprocess.run(cli_command(2, *_flags(data, tmp_path / "j", "--num-model-shards",
                                                 "4")),
                          capture_output=True, text=True, timeout=120, env=cli_env())
    assert proc.returncode != 0
    assert "needs 4 processes, the process group has 2" in proc.stdout + proc.stderr


@pytest.mark.parametrize("extra, error, match", [
    (["--num-model-shards", "2"], ValueError, "needs 2 processes, but no process group is up"),
    (["--tp-mlp", "--num-model-shards", "2"], ValueError,
     "needs 2 processes, but no process group is up"),
])
def test_rejections_in_one_process(data, tmp_path, monkeypatch, extra, error, match):
    from rectpu_torch.trainers import deep_fm

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = deep_fm.build_parser().parse_args(["--device", "cpu",
                                              *_flags(data, tmp_path / "j", *extra)])
    with pytest.raises(error, match=match):
        deep_fm.train_and_evaluate(args)
