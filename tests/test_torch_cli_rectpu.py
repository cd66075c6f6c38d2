"""The port's DeepFM trainer CLI sharded over 2 torchrun ranks (Gloo on the
CPU) against rectpu's DeepFM CLI sharded over 2 of its virtual CPU devices
in one process, both with ``--num-model-shards 2 --ep-mode dedup``: the
loader's blocks, the sharded loop, the sharded eval and the gathered save
of both packages on one run. Both warm-start from one rectpu checkpoint
(the packages draw their inits from different generators) and train 30
steps with dropout off; the final eval metrics and the parameter digest of
the last checkpoints are held to rectpu's ``_assert_matches`` tolerances
(``tests/test_multiprocess.py:76``: metrics rtol 1e-4, atol 1e-5; digest
rtol 1e-5), here between the packages. Seen: the metrics within 3e-7
relative, the digests within 2e-10.
"""

import numpy as np

from rectpu.trainers import deep_fm as jax_deep_fm
from rectpu_torch.data.synthetic import write_synthetic_dataset
from torch_mp_worker import checkpoint_params, param_digest, run_cli


def test_two_rank_cli_matches_rectpus_sharded_cli(tmp_path):
    data = write_synthetic_dataset(tmp_path / "data", train_rows=2000, test_rows=512, seed=11)
    base = ["--train-csv", data["train"], "--test-csv", data["test"], "--batch-size", "32",
            "--steps-per-loop", "5", "--dropout", "0"]

    def rectpu_cli(*flags):
        args = jax_deep_fm.build_parser().parse_args([*base, *map(str, flags)])
        return jax_deep_fm.train_and_evaluate(args)

    rectpu_cli("--job-dir", tmp_path / "init", "--train-steps", "1")  # the shared start
    sharded = ["--train-steps", "30", "--save-checkpoints-steps", "15", "--warm-start-from",
               str(tmp_path / "init" / "ckpt-1"), "--num-model-shards", "2", "--ep-mode", "dedup"]
    want = rectpu_cli(*sharded, "--job-dir", tmp_path / "rectpu")
    got, params = run_cli(2, *base, *sharded, "--job-dir", str(tmp_path / "port"))
    assert got["count"] == want["count"] == 512
    for key in ("auc", "average_loss", "accuracy"):
        assert np.isclose(got[key], want[key], rtol=1e-4, atol=1e-5), (key, got, want)
    assert np.isclose(param_digest(params), param_digest(checkpoint_params(tmp_path / "rectpu")),
                      rtol=1e-5)
