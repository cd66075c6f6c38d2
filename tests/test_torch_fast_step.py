"""The port's sparse fast step (``rectpu_torch.train.fast_step``) against
rectpu's ``make_sparse_step``, and its trainer wiring.

  - Matched init: rectpu's ``init`` makes the weights (every leaf then made
    random: rectpu's zero linear weights would hide a wrong path), the port
    loads them, and both take 3 fast steps on the same batches with dropout
    0 (rectpu: its jitted step; the port: ``Trainer.train_step`` with
    ``fast_step``). Per-step losses, the final parameters and the whole
    optimizer state (rest m/v, the m|v slabs, t) must agree. DeepFM packed
    runs rectpu's "dma" backend (its Pallas row set in interpret mode).
  - The first fast step from zero state equals the port's dense Adam step.
  - Checkpoints: a rectpu-written fast-step checkpoint restores in the port
    and the port's in rectpu; a run resumed from a checkpoint is bitwise the
    run that was not stopped.
  - The trainer CLI with ``--fast-step on --sparse-scatter dma`` on
    ``--device cpu``, and ``--fast-step`` resolution.

Tolerances (fp32): losses within 1e-5 relative; parameters within 1e-6
absolute (forward and backward sums run in other orders, ~1e-7 relative, and
each Adam step moves a weight by ~lr = 1e-3); each state leaf within 1e-5 of
its largest magnitude (m and v are made of the same gradients, ~1e-7 apart
relative, and v of their squares).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.models import DeepFMModel as JaxDeepFM
from rectpu.models import DLRMModel as JaxDLRM
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.models import XDeepFMModel as JaxXDeepFM
from rectpu.train.checkpoint import Checkpointer as JaxCheckpointer
from rectpu.train.fast_step import make_sparse_step as jax_make_sparse_step
from rectpu_torch.convert import (flat_params, flatten_tree, load_params, params_tree,
                                  sparse_state_from_tree, sparse_state_tree)
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import DeepFMModel, DLRMModel, TowerConfig, XDeepFMModel
from rectpu_torch.serve.export import latest_export, load_model
from rectpu_torch.train.checkpoint import Checkpointer
from rectpu_torch.train.fast_step import make_sparse_step
from rectpu_torch.train.loop import TrainConfig, Trainer
from rectpu_torch.train.optimizers import adam
from rectpu_torch.trainers import common as cli_common
from rectpu_torch.trainers import deep_fm as deep_fm_cli

LOSS_RTOL, PARAM_ATOL, STATE_RTOL_OF_MAX = 1e-5, 1e-6, 1e-5

# name: (rectpu class, port class, TowerConfig kwargs, model kwargs, backend)
CASES = {
    "deep_fm_packed_dma": (JaxDeepFM, DeepFMModel,
                           dict(embedding_size=4, hidden_units=(8,), packed_linear=True), {},
                           "dma"),
    "deep_fm_unpacked_fused": (JaxDeepFM, DeepFMModel,
                               dict(embedding_size=4, hidden_units=(8,)), {}, "dma"),
    "dlrm": (JaxDLRM, DLRMModel, dict(embedding_size=4, hidden_units=(8,)), {}, "auto"),
    "xdeep_fm_packed_cin": (JaxXDeepFM, XDeepFMModel,
                            dict(embedding_size=4, hidden_units=(8,), packed_linear=True),
                            dict(cin_units=(4, 4)), "xla"),
}
BATCH = 64


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on few cores; one intra-op thread keeps
    these small-shape tests from crowding the workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(fs, n, seed):
    rng = np.random.default_rng(seed)
    return [{"cat_ids": np.stack([fs.offsets[f] + rng.integers(0, fs.field_sizes[f], BATCH)
                                  for f in range(fs.num_fields)], axis=1).astype(np.int32),
             "num_vals": np.zeros((BATCH, 0), np.float32),
             "labels": (rng.random(BATCH) < 0.3).astype(np.float32)} for _ in range(n)]


def _randomize(params, seed):
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        scale = 0.3 if any(getattr(p, "key", None) in ("emb", "table") for p in path) else 0.1
        leaves.append(jnp.asarray(rng.normal(0.0, scale, np.shape(leaf)), jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _models(case):
    jcls, tcls, cfg, kwargs, _ = CASES[case]
    model_j = jcls(JaxTowerConfig(feature_set=jax_feature_set(), dropout=0.0, **cfg), **kwargs)
    model_t = tcls(TowerConfig(feature_set=ml_100k_feature_set(), dropout=0.0, **cfg), **kwargs)
    return model_j, model_t


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_trees_close(got: dict, want: dict, atol=None, rtol_of_max=None, bitwise=False):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, key
        if bitwise:
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        tol = atol if atol is not None else rtol_of_max * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= tol, (key, np.abs(g - w).max(), tol)


@pytest.fixture(scope="module")
def rectpu_runs():
    """rectpu's 3 fast steps per case, computed once: (initial params,
    batches, per-step losses, final params, final state)."""
    out = {}
    for case in CASES:
        model_j, _ = _models(case)
        params = _randomize(model_j.init(jax.random.PRNGKey(3)), 5)
        init, step = jax_make_sparse_step(model_j, learning_rate=1e-3,
                                          scatter_backend=CASES[case][4])
        jstep = jax.jit(step)
        batches = _batches(model_j.cfg.feature_set, 3, seed=7)
        p, state, losses = params, init(params), []
        for i, b in enumerate(batches):
            p, state, loss = jstep(p, state, _jnp(b), jax.random.PRNGKey(0), jnp.asarray(i))
            losses.append(float(loss))
        out[case] = (params, batches, losses, p, state)
    return out


def _port_trainer(model_t, tmp_path, backend, params0):
    load_params(model_t, jax.tree.map(np.asarray, params0))
    fast = make_sparse_step(model_t, learning_rate=1e-3, scatter_backend=backend)
    trainer = Trainer(model_t, adam(1e-3), None, None, tmp_path, TrainConfig(seed=0),
                      fast_step=fast)
    trainer.opt_state = fast[0](flat_params(model_t))
    return trainer


@pytest.mark.parametrize("case", list(CASES))
def test_three_fast_steps_match_rectpu(case, rectpu_runs, tmp_path):
    params0, batches, losses_j, params_j, state_j = rectpu_runs[case]
    _, model_t = _models(case)
    trainer = _port_trainer(model_t, tmp_path, CASES[case][4], params0)
    for i, b in enumerate(batches):
        loss = float(trainer.train_step(_torch(b), i))
        assert abs(loss - losses_j[i]) <= LOSS_RTOL * abs(losses_j[i]), (i, loss, losses_j[i])
    _assert_trees_close(params_tree(model_t), jax.device_get(params_j), atol=PARAM_ATOL)
    state_t = sparse_state_tree(model_t, trainer.opt_state)
    assert int(state_t["t"]) == int(state_j["t"]) == 3
    _assert_trees_close({k: state_t[k] for k in ("m", "v", "mv_sparse")},
                        jax.device_get({k: state_j[k] for k in ("m", "v", "mv_sparse")}),
                        rtol_of_max=STATE_RTOL_OF_MAX)


def test_first_fast_step_equals_dense_adam_step(tmp_path):
    """From zero state, lazy Adam's first step is dense Adam's (rectpu's
    ``test_fast_step_first_step_matches_dense``), on the port alone."""
    model_j, dense = _models("deep_fm_unpacked_fused")
    _, fast = _models("deep_fm_unpacked_fused")
    params0 = jax.tree.map(np.asarray, _randomize(model_j.init(jax.random.PRNGKey(1)), 2))
    load_params(dense, params0)
    opt = adam(1e-3)
    t_dense = Trainer(dense, opt, None, None, tmp_path / "d", TrainConfig(seed=0))
    t_dense.opt_state = opt.init(flat_params(dense))
    t_fast = _port_trainer(fast, tmp_path / "f", "auto", params0)
    batch = _torch(_batches(model_j.cfg.feature_set, 1, seed=11)[0])
    loss_d = float(t_dense.train_step(batch, 0))
    loss_f = float(t_fast.train_step(batch, 0))
    assert loss_d == loss_f
    got, want = flatten_tree(params_tree(fast)), flatten_tree(params_tree(dense))
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_checkpoints_interchange_with_rectpu(rectpu_runs, tmp_path):
    """rectpu's fast-step checkpoint restores in the port (bitwise), the port
    writes rectpu's tree back, rectpu restores that, and one more step on
    each side from the restored state still agrees."""
    params0, batches, _, params_j, state_j = rectpu_runs["deep_fm_packed_dma"]
    JaxCheckpointer(tmp_path / "j").save(3, {"params": params_j, "opt_state": state_j})
    tree, meta = Checkpointer(tmp_path / "j").restore()
    model_j, model_t = _models("deep_fm_packed_dma")
    trainer = _port_trainer(model_t, tmp_path, "dma", tree["params"])
    trainer.opt_state = sparse_state_from_tree(tree["opt_state"])
    want = jax.device_get({"params": params_j, "opt_state": state_j})
    got = {"params": params_tree(model_t),
           "opt_state": sparse_state_tree(model_t, trainer.opt_state)}
    _assert_trees_close(got, want, bitwise=True)
    # the port's tree, written by the port, restores in rectpu with rectpu's structure
    Checkpointer(tmp_path / "t").save(3, got)
    back, _ = JaxCheckpointer(tmp_path / "t").restore()
    assert jax.tree.structure(back) == jax.tree.structure(want)
    _assert_trees_close(back, want, bitwise=True)
    # one more step on each side from the restored state
    _, step = jax_make_sparse_step(model_j, learning_rate=1e-3, scatter_backend="dma")
    p4, s4, loss_j = jax.jit(step)(back["params"], back["opt_state"], _jnp(batches[0]),
                                   jax.random.PRNGKey(0), jnp.asarray(3))
    loss_t = float(trainer.train_step(_torch(batches[0]), 3))
    assert abs(loss_t - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    _assert_trees_close(params_tree(model_t), jax.device_get(p4), atol=PARAM_ATOL)


def _cli_args(data, job, *flags):
    return deep_fm_cli.build_parser().parse_args(
        ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
         "--job-dir", str(job), "--batch-size", "64", "--steps-per-loop", "3",
         "--fast-step", "on", "--sparse-scatter", "dma", "--packed-linear", *flags])


def test_fast_step_restore_is_bitwise(tmp_path):
    """6 steps straight == 3 steps, a checkpoint, a restore and 3 more:
    params, the m|v slab, the rest m/v and t, bit for bit."""
    data = write_synthetic_dataset(tmp_path / "data", train_rows=800, test_rows=64, seed=2)
    straight = _cli_args(data, tmp_path / "a", "--train-steps", "6",
                         "--save-checkpoints-steps", "6")
    deep_fm_cli.train_and_evaluate(straight)
    first = _cli_args(data, tmp_path / "b", "--train-steps", "3", "--save-checkpoints-steps", "3")
    deep_fm_cli.train_and_evaluate(first)
    resumed = _cli_args(data, tmp_path / "b", "--train-steps", "6",
                        "--save-checkpoints-steps", "3", "--restore")
    deep_fm_cli.train_and_evaluate(resumed)
    (tree_a, meta_a), (tree_b, meta_b) = (Checkpointer(tmp_path / d).restore() for d in "ab")
    assert meta_a["step"] == meta_b["step"] == 6
    assert meta_a["data_state"] == meta_b["data_state"]
    assert set(tree_a["opt_state"]) == {"m", "v", "mv_sparse", "t"}
    assert int(tree_a["opt_state"]["t"]) == 6
    _assert_trees_close(tree_b, tree_a, bitwise=True)


@pytest.mark.parametrize("preset", [False, True])
def test_trainer_cli_fast_step_dma_on_cpu_serves_its_export(preset, tmp_path):
    data = write_synthetic_dataset(tmp_path / "data", train_rows=1500, test_rows=200, seed=1)
    flags = ["--train-steps", "20", "--save-checkpoints-steps", "20"]
    metrics, trainer = deep_fm_cli.train_and_evaluate(
        _cli_args(data, tmp_path / "job", *flags, *(["--preset", "scaled"] if preset else [])))
    assert trainer.fast_step is not None
    assert len(trainer.step_losses) == 20 and np.isfinite(trainer.step_losses).all()
    assert 0.0 <= metrics["auc"] <= 1.0
    mv = trainer.opt_state["mv_sparse"]["table"]
    assert mv.dtype == torch.float32 and mv.shape[1] == 256  # dma lane-pads; preset slots ignored
    features = {"user_id": np.array([1, 50]), "item_id": np.array([10, 7]),
                "age": np.array([25, 61]), "gender": np.array(["F", "M"]),
                "occupation": np.array(["student", "writer"]),
                "zipcode": np.array(["02139", "94043"]), "release_year": np.array([1994, 1960])}
    out = load_model(latest_export(tmp_path / "job"), device="cpu").predict(features)
    assert out["logits"].shape == (2,) and np.isfinite(out["logits"]).all()


def test_resolve_fast_step_modes():
    """'auto' stays dense below rectpu's crossover (850M table elements) and
    turns on past it; an incompatible run makes 'auto' stay dense and 'on'
    raise; the CLI's own default is the dense step for ml-100k."""
    parser = deep_fm_cli.build_parser()
    small = deep_fm_cli.build_model(parser.parse_args([]))
    big = DeepFMModel(TowerConfig(feature_set=ml_100k_feature_set(), embedding_size=64,
                                  table_padding=14_000_000))  # 14M rows x 65 > 850M
    opt = adam(1e-3)
    assert parser.parse_args([]).fast_step == "auto"
    assert cli_common.resolve_fast_step(parser.parse_args([]), small, opt) is None
    assert cli_common.resolve_fast_step(parser.parse_args([]), big, opt) is not None
    assert cli_common.resolve_fast_step(parser.parse_args(["--fast-step", "on"]), small,
                                        opt) is not None
    typed = ["--optimizer-slot-dtype", "bfloat16"]
    assert cli_common.resolve_fast_step(parser.parse_args(typed), big, opt) is None
    with pytest.raises(ValueError, match="--fast-step on: sparse rows support"):
        cli_common.resolve_fast_step(parser.parse_args(["--fast-step", "on", *typed]), small,
                                     opt)
    with pytest.raises(ValueError, match="--fast-step on: needs fp32 tables"):
        cli_common.resolve_fast_step(
            parser.parse_args(["--fast-step", "on", "--table-dtype", "bfloat16"]), small, opt)


def test_make_sparse_step_checks_match_rectpu():
    """Every check rectpu's make_sparse_step raises, with its words, the EP
    ones included."""
    class NoHook:
        name, cfg = "no_hook", TowerConfig(feature_set=ml_100k_feature_set())

    cfg = dict(feature_set=ml_100k_feature_set(), embedding_size=4)
    fused_off = DeepFMModel(TowerConfig(fuse_linear_lookup=False, **cfg))
    packed = DeepFMModel(TowerConfig(packed_linear=True, **cfg))
    tight = DeepFMModel(TowerConfig(packed_linear=True, table_padding=1, **cfg))
    unpacked = DeepFMModel(TowerConfig(**cfg))
    padded_flat = DeepFMModel(TowerConfig(packed_linear=True, packed_col_pad=8,
                                          flat_layout=True, **cfg))

    class EP:
        ep = True

    for model, kw, exc, match in (
            (NoHook(), {}, ValueError, "needs an apply_looked hook"),
            (fused_off, {}, ValueError, "requires fuse_linear_lookup=True or packed_linear"),
            (packed, {"loss_reduction": "max"}, ValueError, "loss_reduction must be"),
            (packed, {"scatter_backend": "mxu"}, ValueError, "scatter_backend must be"),
            (tight, {"scatter_backend": "dma"}, ValueError, ">= 8 pad rows"),
            (packed, {"slot_dtype": "bfloat16"}, ValueError, "slot_dtype must be"),
            (packed, {"slot_dtype": "bfloat16_sr", "plan": EP()}, ValueError,
             "bf16 slots are not wired"),
            (unpacked, {"plan": EP()}, ValueError, "linear tower needs packed_linear=True"),
            (padded_flat, {"plan": EP()}, ValueError,
             "packed_col_pad \\+ flat_layout is not supported under EP")):
        with pytest.raises(exc, match=match):
            make_sparse_step(model, **kw)
    init, _ = make_sparse_step(packed, scatter_backend="xla")
    state = init({"table": torch.zeros(4224, 5), "linear/b": torch.zeros(())})
    assert state["mv_sparse"]["table"].shape == (4224, 10)  # small table: tight slab
