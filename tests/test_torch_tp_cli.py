"""The DeepFM trainer CLI with ``--tp-mlp`` (the tensor-parallel towers)
under ``torch.distributed.run`` on the CPU (Gloo): at 2 ranks with
``--num-model-shards 2`` (the 2d exchange; each tower's layers column- and
row-sharded over the 2 ranks) against the same CLI in one process, within
rectpu's ``_assert_matches`` tolerances (``tests/test_multiprocess.py:76``:
metrics rtol 1e-4, atol 1e-5; digest rtol 1e-5), hash dropout on; rank 0's
export holds the towers in rectpu's global shapes and serves the one
process's predictions. ``--tp-mlp`` without model shards raises rectpu's
ValueError (``rectpu/parallel/plan.py:108-109``).
"""

import subprocess

import numpy as np

from test_torch_multiprocess import _assert_matches, _flags, data  # noqa: F401 (fixture)
from torch_mp_worker import cli_command, cli_env, run_cli


def test_two_ranks_tp_mlp_matches_one_rank_and_exports(data, tmp_path):
    """--tp-mlp --num-model-shards 2 (2d exchange, the towers column- and
    row-sharded over the 2 ranks) against the CLI in one process; rank 0's
    export holds the towers in rectpu's global shapes and serves."""
    from rectpu_torch.serve.export import latest_export, load_model

    multi = run_cli(2, *_flags(data, tmp_path / "m", "--num-model-shards", "2", "--tp-mlp"))
    single = run_cli(1, *_flags(data, tmp_path / "s"))
    _assert_matches(single, multi)
    export = latest_export(tmp_path / "m")
    served = load_model(export, device="cpu")
    assert tuple(served.model.mlp[0]["kernel"].shape) == (104, 16)
    feats = {"user_id": np.array([1, 50]), "item_id": np.array([10, 7]),
             "age": np.array([25, 61]), "gender": np.array(["F", "M"]),
             "occupation": np.array(["student", "writer"]),
             "zipcode": np.array(["02139", "94043"]), "release_year": np.array([1994, 1960])}
    want = load_model(latest_export(tmp_path / "s"), device="cpu").predict(dict(feats))
    np.testing.assert_allclose(served.predict(dict(feats))["logits"], want["logits"],
                               rtol=1e-4, atol=1e-5)


def test_tp_mlp_without_model_shards_raises(data, tmp_path):
    proc = subprocess.run(cli_command(2, *_flags(data, tmp_path / "j", "--num-data-shards",
                                                 "2", "--tp-mlp")),
                          capture_output=True, text=True, timeout=120, env=cli_env())
    assert proc.returncode != 0
    assert "tp_mlp requires num_model_shards > 1" in proc.stdout + proc.stderr
