"""Slice-level checks of the port's training path against rectpu.

  - Model level: rectpu's ``DeepFMModel.init`` makes the weights, the port
    loads them (``rectpu_torch.convert``), and both packages take 3 Adam steps
    with dropout 0 on the same batches (rectpu: a jitted value_and_grad and
    ``optimizers.adam``; the port: ``Trainer.train_step``): the K=4 [16, 16]
    fp32 reference config and the flat ``--preset scaled`` config at a narrow
    width.
  - Data: the port's synthetic CSV and CSV reader against rectpu's.
  - Trainer: the port's trainer CLI on ``--device cpu``, its checkpoint read
    by rectpu's Checkpointer and its export by both packages' ``load_model``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.data.synthetic import write_synthetic_dataset as jax_write_synthetic
from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.io.loader import CsvDataset as JaxCsvDataset
from rectpu.models import DeepFMModel as JaxDeepFM
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.serve.export import load_model as jax_load_model
from rectpu.train.checkpoint import Checkpointer as JaxCheckpointer
from rectpu.train.metrics import sigmoid_xent as jax_xent
from rectpu.train.optimizers import BF16_SR as JAX_BF16_SR
from rectpu.train.optimizers import adam as jax_adam
from rectpu_torch.convert import flat_params, load_params, params_tree
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.io.loader import CsvDataset
from rectpu_torch.models import DeepFMModel, TowerConfig
from rectpu_torch.serve.export import latest_export, load_model
from rectpu_torch.train.loop import TrainConfig, Trainer
from rectpu_torch.train.optimizers import BF16_SR, adam
from rectpu_torch.trainers import deep_fm as deep_fm_cli

MODEL_CASES = {
    # the reference config: fp32 everywhere; per-step losses within 1e-5
    # relative and every parameter within 1e-6 (the sums of the forward and
    # backward run in other orders, ~1e-7 relative; each Adam step moves a
    # weight by ~lr = 1e-3, so that is 1e-3 of a step)
    "k4_fp32": dict(cfg=dict(embedding_size=4, hidden_units=(16, 16)), slots=None,
                    loss_rtol=1e-5, param_atol=1e-6),
    # --preset scaled at K=8 [32, 16]: flat layout, bf16 towers and table
    # cotangent, bf16 m and stochastically rounded v. bf16 activations may
    # round one ulp (2^-8) apart, so the losses agree to 1e-4 relative and
    # each leaf's total update over the 3 steps to 2e-2 in relative L2 (an
    # Adam step is ~lr * sign(g) early on, so a gradient near 0 can take the
    # other sign on the two sides, and a stochastic rounding can land one
    # bf16 ulp apart)
    "flat_scaled": dict(cfg=dict(embedding_size=8, hidden_units=(32, 16),
                                 compute_dtype="bfloat16", table_grad_dtype="bfloat16",
                                 flat_layout=True, packed_linear=True, scatter_impl="mxu",
                                 table_padding=2048, dropout_impl="hash"),
                        slots="bf16-sr", loss_rtol=1e-4, update_rel_l2=2e-2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on few cores; one intra-op thread keeps
    these small-shape tests from crowding the workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(fs, n, b, seed):
    rng = np.random.default_rng(seed)
    offs, sizes = fs.offsets, fs.field_sizes
    out = []
    for _ in range(n):
        ids = np.stack([offs[f] + rng.integers(0, sizes[f], b) for f in range(fs.num_fields)],
                       axis=1).astype(np.int32)
        out.append({"cat_ids": ids, "num_vals": np.zeros((b, 0), np.float32),
                    "labels": (rng.random(b) < 0.3).astype(np.float32)})
    return out


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_three_adam_steps_match_rectpu(case, tmp_path):
    spec = MODEL_CASES[case]
    model_j = JaxDeepFM(JaxTowerConfig(feature_set=jax_feature_set(), dropout=0.0,
                                       **spec["cfg"]))
    params_j = model_j.init(jax.random.PRNGKey(3))
    batches = _batches(model_j.cfg.feature_set, 3, 64, seed=7)

    slots_j = {"m": jnp.bfloat16, "v": JAX_BF16_SR} if spec["slots"] else None
    opt_j = jax_adam(learning_rate=1e-3, slot_dtype=slots_j)

    @jax.jit
    def step_j(params, state, batch):
        def loss_fn(p):
            return jax_xent(model_j.apply(p, batch, train=True), batch["labels"]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = opt_j.update(grads, state, params)
        return params, state, loss

    model_t = DeepFMModel(TowerConfig(feature_set=ml_100k_feature_set(), dropout=0.0,
                                      **spec["cfg"]))
    tree0 = jax.tree.map(np.asarray, params_j)
    load_params(model_t, tree0)
    slots_t = {"m": torch.bfloat16, "v": BF16_SR} if spec["slots"] else None
    opt_t = adam(learning_rate=1e-3, slot_dtype=slots_t)
    trainer = Trainer(model_t, opt_t, None, None, tmp_path, TrainConfig(seed=0))
    trainer.opt_state = opt_t.init(flat_params(model_t))

    state_j = opt_j.init(params_j)
    for i, batch in enumerate(batches):
        params_j, state_j, loss_j = step_j(params_j, state_j,
                                           {k: jnp.asarray(v) for k, v in batch.items()})
        loss_t = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, i)
        assert abs(float(loss_t) - float(loss_j)) <= spec["loss_rtol"] * abs(float(loss_j)), i

    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params_j))[0]
    got = params_tree(model_t)
    start = dict(jax.tree_util.tree_flatten_with_path(tree0)[0])
    for path, w in want:
        leaf = got
        for p in path:
            leaf = leaf[getattr(p, "key", getattr(p, "idx", None))]
        g = leaf.float().numpy()
        w = np.asarray(w, np.float32)
        if "param_atol" in spec:
            assert np.abs(g - w).max() <= spec["param_atol"], jax.tree_util.keystr(path)
        else:
            w0 = np.asarray(start[path], np.float32)
            du, dw = g - w0, w - w0
            rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
            assert rel <= spec["update_rel_l2"], (jax.tree_util.keystr(path), rel)
    assert int(trainer.opt_state["t"]) == 3


def test_synthetic_csv_and_dataset_match_rectpu(tmp_path):
    """The same bytes in all three files, and the same encoded ids, labels,
    train batches (two epochs' worth) and padded eval batches."""
    a = write_synthetic_dataset(tmp_path / "port", train_rows=600, test_rows=100, seed=4)
    b = jax_write_synthetic(tmp_path / "jax", train_rows=600, test_rows=100, seed=4)
    for split in ("train", "test", "all"):
        assert open(a[split], "rb").read() == open(b[split], "rb").read(), split
    for numeric in ((), ("age",)):
        ds_t = CsvDataset(a["train"], ml_100k_feature_set(numeric=numeric))
        ds_j = JaxCsvDataset(b["train"], jax_feature_set(numeric=numeric))
        np.testing.assert_array_equal(ds_t.cat_ids, ds_j.cat_ids)
        np.testing.assert_array_equal(ds_t.labels, ds_j.labels)
        np.testing.assert_array_equal(ds_t.num_vals, ds_j.num_vals)
    it_t, it_j = ds_t.train_batches(256, seed=42), ds_j.train_batches(256, seed=42)
    for _ in range(5):
        (bt, st), (bj, sj) = next(it_t), next(it_j)
        assert (st.epoch, st.index) == (sj.epoch, sj.index)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])
    for bt, bj in zip(ds_t.eval_batches(256), ds_j.eval_batches(256)):
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])


def test_trainer_cli_on_cpu_writes_an_export_both_packages_read(tmp_path):
    data = write_synthetic_dataset(tmp_path / "data", train_rows=800, test_rows=200, seed=1)
    job = tmp_path / "job"
    args = deep_fm_cli.build_parser().parse_args(
        ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
         "--job-dir", str(job), "--train-steps", "10", "--batch-size", "64",
         "--steps-per-loop", "5", "--save-checkpoints-steps", "5", "--eval-auc", "exact"])
    metrics, trainer = deep_fm_cli.train_and_evaluate(args)
    assert len(trainer.step_losses) == 10 and np.isfinite(trainer.step_losses).all()
    assert 0.0 <= metrics["auc"] <= 1.0 and 0.0 <= metrics["auc_streaming"] <= 1.0
    # rectpu's Checkpointer restores the port's last checkpoint
    tree, meta = JaxCheckpointer(job).restore()
    assert meta["step"] == 10 and meta["data_state"]["index"] == 640
    assert int(np.asarray(tree["opt_state"]["t"])) == 10
    np.testing.assert_array_equal(np.asarray(tree["params"]["emb"]),
                                  params_tree(trainer.model)["emb"].numpy())
    # both packages serve the export it wrote
    export = latest_export(job)
    features = {"user_id": np.array([1, 50]), "item_id": np.array([10, 7]),
                "age": np.array([25, 61]), "gender": np.array(["F", "M"]),
                "occupation": np.array(["student", "writer"]),
                "zipcode": np.array(["02139", "94043"]), "release_year": np.array([1994, 1960])}
    got = load_model(export, device="cpu").predict(dict(features))
    want = jax_load_model(export).predict(dict(features))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=1e-5)


def test_trainer_raises_without_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = write_synthetic_dataset(tmp_path / "data", train_rows=100, test_rows=20, seed=1)
    args = deep_fm_cli.build_parser().parse_args(
        ["--train-csv", data["train"], "--test-csv", data["test"], "--job-dir",
         str(tmp_path / "job"), "--train-steps", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deep_fm_cli.train_and_evaluate(args)


@pytest.mark.parametrize("flags,queue", [
    (["--tp-mlp"], "A17"), (["--tp-mlp", "--num-model-shards", "2"], "A17"),
])
def test_unported_flags_raise(flags, queue, tmp_path):
    """(Named when ``--tp-mlp`` raised, naming ROADMAP.md queue ``queue``.)
    The flag trains now. In one process there is no plan, so it changes
    nothing, as in rectpu: the checkpoint equals the run's without it, bit
    for bit. With --num-model-shards 2 the CLI at 2 torchrun ranks trains the
    tensor-parallel towers, and rank 0's checkpoint holds the towers and
    their Adam state in rectpu's global shapes."""
    from torch_mp_worker import checkpoint_params, run_cli

    data = write_synthetic_dataset(tmp_path / "data", train_rows=300, test_rows=100, seed=1)
    argv = ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
            "--train-steps", "4", "--batch-size", "32", "--steps-per-loop", "2",
            "--save-checkpoints-steps", "2"]
    if "--num-model-shards" not in flags:
        runs = {}
        for tag, extra in (("tp", flags), ("plain", [])):
            args = deep_fm_cli.build_parser().parse_args(
                [*argv, "--job-dir", str(tmp_path / tag), *extra])
            metrics, trainer = deep_fm_cli.train_and_evaluate(args)
            assert trainer.plan is None and np.isfinite(trainer.step_losses).all()
            runs[tag] = checkpoint_params(tmp_path / tag)
        assert sorted(runs["tp"]) == sorted(runs["plain"])
        for k, v in runs["plain"].items():
            np.testing.assert_array_equal(runs["tp"][k], v, err_msg=k)
        return
    metrics, params = run_cli(2, *argv[2:], "--job-dir", str(tmp_path / "job"), *flags)
    assert metrics["count"] == 100 and 0.0 <= metrics["auc"] <= 1.0
    assert params["params/mlp/0/kernel"].shape == (104, 16)
    assert params["params/mlp/1/kernel"].shape == (16, 16)
    assert params["params/mlp/0/bias"].shape == (16,)
    tree, _ = JaxCheckpointer(tmp_path / "job").restore()
    assert np.asarray(tree["opt_state"]["m"]["mlp"][0]["kernel"]).shape == (104, 16)
    assert np.asarray(tree["opt_state"]["v"]["mlp"][1]["kernel"]).shape == (16, 16)


@pytest.mark.parametrize("flags,opt_name", [
    (["--compute-dtype", "bfloat16", "--table-store", "bfloat16"], "Adam+Bf16Store"),
    (["--optimizer", "Adagrad"], "Adagrad"),
    (["--streaming-io"], "Adam"),
    (["--exporter", "best"], "Adam"),
])
def test_formerly_unported_flags_train(flags, opt_name, tmp_path):
    """--table-store bfloat16 and --optimizer Adagrad, which raised until the
    rest of rectpu's optimizers were ported, and --streaming-io and
    --exporter best, which raised until the rest of the trainer surface was
    ported, train through the CLI; the store keeps a bf16 table the forward
    reads and its fp32 master in the state, the best exporter records its
    metric beside the export."""
    data = write_synthetic_dataset(tmp_path / "data", train_rows=300, test_rows=100, seed=1)
    args = deep_fm_cli.build_parser().parse_args(
        ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
         "--job-dir", str(tmp_path / "job"), "--train-steps", "4", "--batch-size", "32",
         "--steps-per-loop", "2", "--save-checkpoints-steps", "2", *flags])
    metrics, trainer = deep_fm_cli.train_and_evaluate(args)
    assert trainer.optimizer.name == opt_name
    assert len(trainer.step_losses) == 4 and np.isfinite(trainer.step_losses).all()
    assert 0.0 <= metrics["auc"] <= 1.0
    if "--table-store" in flags:
        assert params_tree(trainer.model)["emb"].dtype == torch.bfloat16
        assert trainer.opt_state["master"]["emb"].dtype == torch.float32
        tree, _ = JaxCheckpointer(tmp_path / "job").restore()
        assert set(tree["opt_state"]) == {"inner", "master"}
    if "--exporter" in flags:
        best = json.loads((tmp_path / "job" / "best_metric.json").read_text())
        assert set(best) == {"auc", "step"} and latest_export(tmp_path / "job") is not None


def test_table_store_checks(tmp_path):
    """rectpu's two checks of --table-store bfloat16 (common.py:514-528)."""
    for flags, match in ((["--table-store", "bfloat16"], "requires --compute-dtype"),
                         (["--table-store", "bfloat16", "--compute-dtype", "bfloat16",
                           "--table-dtype", "bfloat16"], "redundant")):
        args = deep_fm_cli.build_parser().parse_args(
            ["--device", "cpu", "--job-dir", str(tmp_path / "job"), *flags])
        with pytest.raises(ValueError, match=match):
            deep_fm_cli.train_and_evaluate(args)
