"""Checkpoints of a sharded run of the port's DeepFM CLI (2 ranks under
``torch.distributed.run``, Gloo on the CPU):

  - killed with SIGKILL after a mid-run checkpoint and relaunched with
    ``--restore``, it ends on the uninterrupted run's parameters bit for bit
    (rectpu's ``tests/test_multiprocess.py:186``): params, optimizer state,
    data position and dropout masks all come back;
  - its checkpoint, in rectpu's single-device layout, restores in rectpu's
    single-device trainer, whose eval of it gives the sharded run's final
    metrics (rtol 1e-5: another summation order of the eval sums).
"""

import os
import signal
import subprocess
import time

import numpy as np

from rectpu.trainers import deep_fm as jax_deep_fm_cli
from rectpu_torch.data.synthetic import write_synthetic_dataset
from torch_mp_worker import checkpoint_params, cli_command, cli_env, run_cli

STEPS = 300


def _flags(data, job, steps=STEPS, save=30):
    return ["--train-csv", data["train"], "--test-csv", data["test"], "--job-dir", str(job),
            "--train-steps", str(steps), "--batch-size", "32", "--save-checkpoints-steps",
            str(save), "--steps-per-loop", "10", "--dropout-impl", "hash",
            "--num-model-shards", "2", "--ep-mode", "dedup"]


def test_kill_and_restore_resumes_bitwise(tmp_path):
    data = write_synthetic_dataset(tmp_path / "data", train_rows=2000, test_rows=256, seed=11)
    ref_metrics, ref = run_cli(2, *_flags(data, tmp_path / "ref"))

    job = tmp_path / "killed"
    proc = subprocess.Popen(cli_command(2, *_flags(data, job)), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, env=cli_env(), start_new_session=True)
    deadline = time.time() + 240
    saved = []
    while time.time() < deadline and proc.poll() is None:
        saved = [d for d in job.glob("ckpt-*") if (d / "meta.json").exists()
                 and int(d.name.split("-")[1]) < STEPS]
        if saved:
            break
        time.sleep(0.05)
    os.killpg(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)
    assert saved, "no mid-run checkpoint appeared before the run ended"
    left = sorted(int(d.name.split("-")[1]) for d in job.glob("ckpt-*")
                  if (d / "meta.json").exists())
    assert left and left[-1] < STEPS, left

    metrics, got = run_cli(2, *_flags(data, job), "--restore")
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ("auc", "average_loss", "accuracy"):
        assert metrics[key] == ref_metrics[key], (key, metrics, ref_metrics)


def test_sharded_checkpoint_restores_in_rectpu(tmp_path):
    data = write_synthetic_dataset(tmp_path / "data", train_rows=1000, test_rows=256, seed=5)
    job = tmp_path / "job"
    metrics, params = run_cli(2, *_flags(data, job, steps=20, save=100))
    assert params["params/emb"].shape[0] % 2 == 0
    got = jax_deep_fm_cli.train_and_evaluate(jax_deep_fm_cli.build_parser().parse_args(
        ["--train-csv", data["train"], "--test-csv", data["test"], "--job-dir", str(job),
         "--train-steps", "20", "--batch-size", "32", "--dropout-impl", "hash", "--restore"]))
    for key in ("auc", "average_loss", "accuracy"):
        assert np.isclose(got[key], metrics[key], rtol=1e-5), (key, got, metrics)
    np.testing.assert_array_equal(checkpoint_params(job)["params/emb"], params["params/emb"])
