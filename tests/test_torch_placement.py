"""A job dir's stored row placement (``row_perm.npy``) in the port, as in rectpu.

rectpu relabels the train and eval ids through ``<job-dir>/row_perm.npy``
whenever the file exists (``rectpu/trainers/common.py:453-459``) and writes
the map into every export (``serve/export.py:155-158``). Here rectpu trains a
job dir, the dir is given a placement, and both packages restore it and train
3 more steps on the same stream: the per-step losses must agree at the
matched-init tolerance of ``tests/test_torch_train.py`` (1e-5 relative, the
fp32 reference config), which they cannot if one side ignores the map. The
port's export must then carry the map, and serving must use it.
"""

import json
import shutil

import numpy as np

import rectpu.trainers.common as jax_common
from rectpu.data.synthetic import write_synthetic_dataset as jax_write_synthetic
from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.serve.export import load_model as jax_load_model
from rectpu.trainers import deep_fm as jax_deep_fm_cli
from rectpu_torch.serve.export import latest_export, load_model
from rectpu_torch.trainers import deep_fm as deep_fm_cli

LOSS_RTOL = 1e-5


def _argv(data, job, steps, *extra):
    return ["--train-csv", data["train"], "--test-csv", data["test"], "--job-dir", str(job),
            "--train-steps", str(steps), "--batch-size", "32", "--dropout", "0",
            "--steps-per-loop", "3", "--save-checkpoints-steps", "100",
            "--data-placement", "host", *extra]


def test_stored_row_placement_restores_and_exports_as_in_rectpu(tmp_path, monkeypatch):
    data = jax_write_synthetic(tmp_path / "data", train_rows=600, test_rows=100, seed=3)
    base = tmp_path / "job"
    jax_deep_fm_cli.train_and_evaluate(
        jax_deep_fm_cli.build_parser().parse_args(_argv(data, base, 2)))
    rows = JaxTowerConfig(feature_set=jax_feature_set()).padded_buckets
    perm = np.random.default_rng(0).permutation(rows).astype(np.int32)
    np.save(base / "row_perm.npy", perm)
    job_j, job_t = tmp_path / "job_rectpu", tmp_path / "job_port"
    shutil.copytree(base, job_j)
    shutil.copytree(base, job_t)

    # rectpu: record the losses of its (scanned) train chunk
    losses_j = []
    build = jax_common.build_trainer

    def recording_build(*args, **kwargs):
        trainer = build(*args, **kwargs)
        chunk = trainer._train_chunk

        def record(*a):
            out = chunk(*a)
            losses_j.extend(np.asarray(out[-1], np.float64).tolist())
            return out

        trainer._train_chunk = record
        return trainer

    monkeypatch.setattr(jax_common, "build_trainer", recording_build)
    jax_deep_fm_cli.train_and_evaluate(
        jax_deep_fm_cli.build_parser().parse_args(_argv(data, job_j, 5, "--restore")))
    _, trainer = deep_fm_cli.train_and_evaluate(
        deep_fm_cli.build_parser().parse_args(_argv(data, job_t, 5, "--restore", "--device",
                                                    "cpu")))
    assert len(losses_j) == 3 and len(trainer.step_losses) == 3
    for got, want in zip(trainer.step_losses, losses_j):
        assert abs(got - want) <= LOSS_RTOL * abs(want), (trainer.step_losses, losses_j)

    export = latest_export(job_t)
    assert json.loads((export / "model.json").read_text())["row_placement"] is True
    stored = np.load(export / "row_perm.npy")
    assert stored.dtype == np.int32
    np.testing.assert_array_equal(stored, perm)
    features = {"user_id": np.array([1, 50, 7]), "item_id": np.array([10, 7, 300]),
                "age": np.array([25, 61, 33]), "gender": np.array(["F", "M", "M"]),
                "occupation": np.array(["student", "writer", "doctor"]),
                "zipcode": np.array(["02139", "94043", "10001"]),
                "release_year": np.array([1994, 1960, 1977])}
    served = load_model(export, device="cpu")
    np.testing.assert_array_equal(served.row_perm, perm)
    got = served.predict(dict(features))
    want = jax_load_model(export).predict(dict(features))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=1e-5)
    # without the map the same request reads other rows of the table
    served.row_perm = None
    assert not np.allclose(served.predict(dict(features))["logits"], got["logits"])
