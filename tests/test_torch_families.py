"""Slice-level checks of the port's Linear, DNN and Wide&Deep against rectpu.

  - Forward: rectpu's ``init`` makes the weights (every leaf then made
    random, since rectpu's zero linear weights would hide a wrong path), the
    port carries them across (``rectpu_torch.convert``), and both packages'
    logits on the same batch agree, in every form: Wide&Deep unfused, fused,
    packed (with and without pad columns), the flat layout, numeric fields,
    bf16 towers.
  - Training: 3 steps from rectpu's init on the same batches, dropout 0,
    with each family's default optimizer (FTRL; Adagrad(0.05); per-tower
    FTRL + Adagrad, or the packed column split) and DeepFM with
    ``--optimizer Adagrad`` and with ``--table-store bfloat16`` (rectpu: a
    jitted value_and_grad and its optimizer, as its Trainer steps; the port:
    ``Trainer.train_step``); per-step losses and final weights compared.
  - Serving: an export written by rectpu is served by the port's CPU
    ``ServingModel`` and by rectpu's, and the port's trainer CLIs on
    ``--device cpu`` write exports that both packages serve.

Tolerances. fp32 (weights from rectpu's init, every leaf then random):
logits within 1e-5 (sums in another order, ~1e-7 relative); losses within
1e-5 relative; each leaf's total update over the 3 steps within 1e-4
relative L2 (FTRL recomputes w from z and n each step, so the weight carries
the fp32 rounding of z/sqrt(n), and Adagrad divides by sqrt(acc): a few fp32
ulps of a step). bf16 towers (rectpu's init as it is, as for DeepFM's
flagship case): logits within 2e-2 (one bf16 ulp of an activation, 2^-8
relative, moved by its weight), losses within 1e-4 relative (1e-3 under
Adagrad and FTRL, see BF16_LOSS_RTOL) and each leaf's update within 2e-2
relative L2, as ``tests/test_torch_train.py`` allows DeepFM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.models import DeepFMModel as JaxDeepFM
from rectpu.models import DNNModel as JaxDNN
from rectpu.models import LinearModel as JaxLinear
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.models import WideDeepModel as JaxWideDeep
from rectpu.serve.export import export_model as jax_export_model
from rectpu.serve.export import load_model as jax_load_model
from rectpu.train import optimizers as jax_opt
from rectpu.train.metrics import sigmoid_xent as jax_xent
from rectpu_torch.convert import flat_params, load_params, params_tree
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import (
    MODEL_REGISTRY,
    DeepFMModel,
    DNNModel,
    LinearModel,
    TowerConfig,
    WideDeepModel,
)
from rectpu_torch.serve.export import export_model, latest_export, load_model
from rectpu_torch.train import optimizers as t_opt
from rectpu_torch.train.loop import TrainConfig, Trainer
from rectpu_torch.trainers import deep as deep_cli
from rectpu_torch.trainers import linear as linear_cli
from rectpu_torch.trainers import linear_deep as linear_deep_cli

FAMILIES = {"linear": (JaxLinear, LinearModel), "deep": (JaxDNN, DNNModel),
            "linear_deep": (JaxWideDeep, WideDeepModel), "deep_fm": (JaxDeepFM, DeepFMModel)}
NUMERIC = ("action", "drama")
BF16 = dict(compute_dtype="bfloat16")
FLAT_BF16 = dict(compute_dtype="bfloat16", table_grad_dtype="bfloat16", flat_layout=True,
                 scatter_impl="mxu", table_padding=2048)

# name: (family, TowerConfig kwargs, numeric columns)
CASES = {
    "linear": ("linear", {}, ()),
    "linear_numeric": ("linear", {}, NUMERIC),
    "deep": ("deep", dict(embedding_size=4, hidden_units=(16, 16)), ()),
    "deep_numeric": ("deep", dict(embedding_size=4, hidden_units=(16,)), NUMERIC),
    "deep_bf16_numeric": ("deep", dict(embedding_size=4, hidden_units=(16,), **BF16), NUMERIC),
    "deep_flat_bf16": ("deep", dict(embedding_size=8, hidden_units=(16,), **FLAT_BF16), ()),
    "wd_unfused": ("linear_deep", dict(embedding_size=4, hidden_units=(16,),
                                       fuse_linear_lookup=False), NUMERIC),
    "wd_fused": ("linear_deep", dict(embedding_size=4, hidden_units=(16, 8)), ()),
    "wd_fused_numeric": ("linear_deep", dict(embedding_size=4, hidden_units=(16,)), NUMERIC),
    "wd_packed": ("linear_deep", dict(embedding_size=4, hidden_units=(16,),
                                      packed_linear=True), ()),
    "wd_packed_pad_numeric": ("linear_deep", dict(embedding_size=4, hidden_units=(16,),
                                                  packed_linear=True, packed_col_pad=8),
                              NUMERIC),
    "wd_packed_bf16": ("linear_deep", dict(embedding_size=4, hidden_units=(16,),
                                           packed_linear=True, **BF16), ()),
    "wd_flat_bf16": ("linear_deep", dict(embedding_size=8, hidden_units=(16,),
                                         packed_linear=True, **FLAT_BF16), ()),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on few cores; one intra-op thread keeps
    these small-shape tests from crowding the workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(family, cfg, numeric=(), model_kwargs=None):
    jax_cls, port_cls = FAMILIES[family]
    kw = model_kwargs or {}
    model_j = jax_cls(JaxTowerConfig(feature_set=jax_feature_set(numeric=numeric), **cfg), **kw)
    model_t = port_cls(TowerConfig(feature_set=ml_100k_feature_set(numeric=numeric), **cfg),
                       **kw)
    return model_j, model_t


def _randomize(params, seed: int):
    """Every leaf random in its own dtype: tables at 0.3, the rest at 0.1."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        scale = 0.3 if ("emb" in name or "table" in name) else 0.1
        arr = np.asarray(leaf)
        leaves.append(jnp.asarray(rng.normal(0.0, scale, arr.shape).astype(np.float32),
                                  arr.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _batches(fs, n, b, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = np.stack([fs.offsets[f] + rng.integers(0, fs.field_sizes[f], b)
                        for f in range(fs.num_fields)], axis=1).astype(np.int32)
        out.append({"cat_ids": ids,
                    "num_vals": rng.integers(0, 2, (b, fs.num_numeric)).astype(np.float32),
                    "labels": (rng.random(b) < 0.3).astype(np.float32)})
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[getattr(p, "key", getattr(p, "idx", None))]
    return tree


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_rectpu(case):
    family, cfg, numeric = CASES[case]
    model_j, model_t = _models(family, cfg, numeric)
    params = _randomize(model_j.init(jax.random.PRNGKey(1)), seed=len(case))
    if "packed_col_pad" in cfg:  # the pad columns are zero, as pack_fused_table makes them
        params["table"] = params["table"].at[:, cfg["embedding_size"] + 1:].set(0.0)
    load_params(model_t, jax.tree.map(np.asarray, params))
    (batch,) = _batches(model_j.cfg.feature_set, 1, 24, seed=5)
    want = np.asarray(jax.jit(model_j.apply)(params,
                                             {k: jnp.asarray(v) for k, v in batch.items()}))
    got = model_t(torch.from_numpy(batch["cat_ids"]), torch.from_numpy(batch["num_vals"]))
    assert got.shape == (24,) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.01  # the comparison is not of zeros
    atol = 2e-2 if cfg.get("compute_dtype") == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)
    # the carrier gives back rectpu's tree, leaf for leaf
    tree = params_tree(model_t)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0]:
        np.testing.assert_array_equal(_leaf(tree, path).float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_flat_layout_refuses_a_padded_packed_table():
    """rectpu's lookup_flat takes no lane-padded table; neither does the port."""
    cfg = dict(embedding_size=4, hidden_units=(8,), packed_linear=True, packed_col_pad=8,
               flat_layout=True)
    model_j, model_t = _models("linear_deep", cfg)
    params = model_j.init(jax.random.PRNGKey(0))
    load_params(model_t, jax.tree.map(np.asarray, params))
    (batch,) = _batches(model_j.cfg.feature_set, 1, 4, seed=0)
    with pytest.raises(NotImplementedError, match="lane-padded"):
        model_j.apply(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(NotImplementedError, match="lane-padded"):
        model_t(torch.from_numpy(batch["cat_ids"]), torch.from_numpy(batch["num_vals"]))


def test_registry_and_default_optimizers():
    fs = ml_100k_feature_set()
    assert {"linear", "deep", "linear_deep", "dcn", "autoint"} <= set(MODEL_REGISTRY)
    names = {name: MODEL_REGISTRY[name](TowerConfig(feature_set=fs)).default_optimizer().name
             for name in ("linear", "deep", "linear_deep", "deep_fm", "dlrm", "xdeep_fm",
                          "dcn", "autoint")}
    assert names == {"linear": "Ftrl", "deep": "Adagrad",
                     "linear_deep": "PerSubtree(linear:Ftrl,*:Adagrad)", "deep_fm": "Adam",
                     "dlrm": "Adam", "xdeep_fm": "Adam", "dcn": "Adam", "autoint": "Adam"}
    for name in ("dcn", "autoint"):  # both build, and carry the fast step's hook
        model = MODEL_REGISTRY[name](TowerConfig(feature_set=fs))
        assert model.name == name and hasattr(model, "apply_looked")
    packed = WideDeepModel(TowerConfig(feature_set=fs, packed_linear=True))
    assert packed.default_optimizer().name == "PackedWideDeep(Ftrl+Adagrad)"
    assert not hasattr(packed, "apply_looked")  # as rectpu's: no fast-step hook
    assert hasattr(DNNModel(TowerConfig(feature_set=fs)), "apply_looked")


# bf16 towers under Adagrad(0.05) and FTRL(~0.2) take steps 50-200x Adam's
# 1e-3, so a gradient one bf16 ulp apart moves a weight that much further;
# and once FTRL moves the wide weights off zero, rectpu's flat layout rounds
# the small fields' linear partial sum to bf16 (ROADMAP.md C) where the port
# sums in fp32: the losses after the first step agree to 1e-3 relative
BF16_LOSS_RTOL = {"Adagrad": 1e-3, "PackedWideDeep(Ftrl+Adagrad)": 1e-3}

# name: (family, TowerConfig kwargs, numeric, optimizer: "default" or
# (rectpu's, the port's) factories)
STEP_CASES = {
    "linear_ftrl": ("linear", {}, NUMERIC, "default"),
    "deep_adagrad": ("deep", dict(embedding_size=4, hidden_units=(16, 16)), (), "default"),
    "deep_adagrad_bf16_sr": ("deep", dict(embedding_size=4, hidden_units=(16,)), NUMERIC,
                             (lambda: jax_opt.adagrad(0.05, slot_dtype=jax_opt.BF16_SR),
                              lambda: t_opt.adagrad(0.05, slot_dtype=t_opt.BF16_SR))),
    "deep_flat_bf16": ("deep", dict(embedding_size=8, hidden_units=(16,), **FLAT_BF16), (),
                       "default"),
    "wd_per_tower": ("linear_deep", dict(embedding_size=4, hidden_units=(16,)), NUMERIC,
                     "default"),
    "wd_unfused": ("linear_deep", dict(embedding_size=4, hidden_units=(16,),
                                       fuse_linear_lookup=False), (), "default"),
    "wd_packed": ("linear_deep", dict(embedding_size=4, hidden_units=(16,),
                                      packed_linear=True), NUMERIC, "default"),
    "wd_flat_bf16_packed": ("linear_deep", dict(embedding_size=8, hidden_units=(16,),
                                                packed_linear=True, **FLAT_BF16), (),
                            "default"),
    "deep_fm_adagrad": ("deep_fm", dict(embedding_size=4, hidden_units=(16, 16)), (),
                        (lambda: jax_opt.get_optimizer("Adagrad", 0.01),
                         lambda: t_opt.get_optimizer("Adagrad", 0.01))),
}


def _steps(model_j, model_t, opt_j, opt_t, params_j, batches, tmp_path):
    """3 steps on both sides from rectpu's ``params_j``: (rectpu's losses and
    final tree, the port's losses and final tree, the starting tree)."""

    @jax.jit
    def step_j(params, state, batch):
        def loss_fn(p):
            return jax_xent(model_j.apply(p, batch, train=True), batch["labels"]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = opt_j.update(grads, state, params)
        return params, state, loss

    tree0 = jax.tree.map(np.asarray, params_j)
    state_j = opt_j.init(params_j)
    if opt_j.prepare is not None:
        params_j = opt_j.prepare(params_j)
    load_params(model_t, tree0)
    trainer = Trainer(model_t, opt_t, None, None, tmp_path, TrainConfig(seed=0))
    trainer.opt_state = opt_t.init(flat_params(model_t))
    if getattr(opt_t, "prepare", None) is not None:
        load_params(model_t, opt_t.prepare(params_tree(model_t)))
    losses_j, losses_t = [], []
    for i, batch in enumerate(batches):
        params_j, state_j, loss_j = step_j(params_j, state_j,
                                           {k: jnp.asarray(v) for k, v in batch.items()})
        losses_j.append(float(loss_j))
        losses_t.append(float(trainer.train_step(
            {k: torch.from_numpy(v) for k, v in batch.items()}, i)))
    return (losses_j, jax.tree.map(np.asarray, params_j)), (losses_t, params_tree(model_t)), tree0


def _hold(got, want, tree0, loss_rtol: float, update_rel_l2: float) -> None:
    """Per-step losses within ``loss_rtol``; each leaf's total update within
    ``update_rel_l2`` relative L2."""
    for i, (lt, lj) in enumerate(zip(got[0], want[0])):
        assert abs(lt - lj) <= loss_rtol * abs(lj), (i, lt, lj)
    for path, w in jax.tree_util.tree_flatten_with_path(want[1])[0]:
        g, w = _leaf(got[1], path).float().numpy(), np.asarray(w, np.float32)
        w0 = np.asarray(_leaf(tree0, path), np.float32)
        du, dw = g - w0, w - w0
        rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
        assert rel <= update_rel_l2, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_three_steps_match_rectpu(name, tmp_path):
    family, cfg, numeric, opt = STEP_CASES[name]
    model_j, model_t = _models(family, {**cfg, "dropout": 0.0}, numeric)
    bf16 = cfg.get("compute_dtype") == "bfloat16"
    params_j = model_j.init(jax.random.PRNGKey(2))
    if not bf16:
        params_j = _randomize(params_j, seed=3)
    if opt == "default":
        opt_j, opt_t = model_j.default_optimizer(), model_t.default_optimizer()
    else:
        opt_j, opt_t = opt[0](), opt[1]()
    assert opt_j.name == opt_t.name
    batches = _batches(model_j.cfg.feature_set, 3, 48, seed=8)
    want, got, tree0 = _steps(model_j, model_t, opt_j, opt_t, params_j, batches, tmp_path)
    if bf16:
        _hold(got, want, tree0, BF16_LOSS_RTOL.get(opt_t.name, 1e-4), 2e-2)
    else:
        _hold(got, want, tree0, 1e-5, 1e-4)


def test_table_store_steps_match_the_recast_path_and_rectpu(tmp_path):
    """DeepFM under --preset scaled with --table-store bfloat16: the port's
    steps are bit for bit its steps with plain Adam on the fp32 table that
    the forward casts to bf16, and rectpu's store run is rectpu's recast run;
    so the two packages are held to each other as the plain runs are, within
    the bf16 tolerances of tests/test_torch_train.py's flat_scaled case:
    losses within 2e-4 relative (this run's plain-Adam gap is 1.09e-4 at
    step 2) and each leaf's update within 3e-2 relative L2 (2.4e-2 for the
    last kernel: Adam's first steps are ~lr*sign(g), so a gradient near 0
    can take the other sign on the two sides)."""
    cfg = dict(embedding_size=8, hidden_units=(32, 16), packed_linear=True, dropout=0.0,
               **FLAT_BF16)
    model_j, model_t = _models("deep_fm", cfg)
    params_j = model_j.init(jax.random.PRNGKey(2))
    batches = _batches(model_j.cfg.feature_set, 3, 48, seed=8)
    want, got, tree0 = _steps(model_j, model_t, jax_opt.bf16_param_store(jax_opt.adam(1e-3)),
                              t_opt.bf16_param_store(t_opt.adam(1e-3)), params_j, batches,
                              tmp_path / "store")
    assert got[1]["table"].dtype == torch.bfloat16
    _, model_p = _models("deep_fm", cfg)
    want_p, got_p, _ = _steps(model_j, model_p, jax_opt.adam(1e-3), t_opt.adam(1e-3),
                              params_j, batches, tmp_path / "plain")
    assert got[0] == got_p[0] and want[0] == want_p[0]
    assert torch.equal(got[1]["table"], got_p[1]["table"].to(torch.bfloat16))
    np.testing.assert_array_equal(np.asarray(want[1]["table"], np.float32),
                                  np.asarray(want_p[1]["table"].astype(jnp.bfloat16), np.float32))
    _hold(got, want, tree0, 2e-4, 3e-2)


FEATURES = {
    "user_id": np.array([1, 7, 942, 55, 300]),
    "item_id": np.array([10, 55, 1682, 1, 999]),
    "age": np.array([25, 40, 15, 65, 33]),
    "gender": np.array(["F", "M", "M", "X", "F"]),
    "occupation": np.array(["student", "writer", "engineer", "none", "artist"]),
    "zipcode": np.array(["85711", "10027", "02139", "94043", "T8H1N"]),
    "release_year": np.array([1994, 1987, 1930, 1997, 1960]),
    "action": np.array([1, 0, 1, 0, 0]),
    "drama": np.array([0, 1, 1, 0, 1]),
}


@pytest.mark.parametrize("case", ["linear_numeric", "deep_bf16_numeric", "wd_unfused",
                                  "wd_fused_numeric", "wd_packed_pad_numeric"])
def test_exports_served_both_ways(case, tmp_path):
    """A rectpu export served by the port, and the port's export of the same
    weights served by rectpu: both packages' predictions agree."""
    family, cfg, numeric = CASES[case]
    model_j, model_t = _models(family, cfg, numeric)
    params = _randomize(model_j.init(jax.random.PRNGKey(3)), seed=11)
    if "packed_col_pad" in cfg:
        params["table"] = params["table"].at[:, cfg["embedding_size"] + 1:].set(0.0)
    atol = 2e-2 if cfg.get("compute_dtype") == "bfloat16" else 1e-5
    d_j = jax_export_model(params, model_j, tmp_path / "jax", step=1)
    want = jax_load_model(d_j).predict(dict(FEATURES))
    served = load_model(d_j, device="cpu")
    assert type(served.model).__name__ == type(model_j).__name__
    np.testing.assert_allclose(served.predict(dict(FEATURES))["logits"], want["logits"],
                               rtol=0, atol=atol)
    d_t = export_model(jax.tree.map(np.asarray, params), model_t, tmp_path / "port", step=1)
    got = jax_load_model(d_t).predict(dict(FEATURES))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=atol)


# name: (CLI, extra flags, the optimizer's name)
CLI_CASES = {
    "linear": (linear_cli, [], "Ftrl"),
    "deep": (deep_cli, ["--acc-dtype", "bfloat16-sr"], "Adagrad"),
    "deep_scaled_table_store": (deep_cli, ["--preset", "scaled", "--embedding-size", "8",
                                           "--table-store", "bfloat16"], "Adagrad+Bf16Store"),
    "linear_deep": (linear_deep_cli, [], "PerSubtree(linear:Ftrl,*:Adagrad)"),
    "linear_deep_packed_pad": (linear_deep_cli, ["--packed-linear", "--packed-col-pad", "8"],
                               "PackedWideDeep(Ftrl+Adagrad)"),
    "linear_deep_scaled": (linear_deep_cli, ["--preset", "scaled", "--embedding-size", "8"],
                           "PackedWideDeep(Ftrl+Adagrad)"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_trainer_cli_on_cpu_writes_an_export_both_packages_serve(case, tmp_path):
    cli, flags, opt_name = CLI_CASES[case]
    data = write_synthetic_dataset(tmp_path / "data", train_rows=400, test_rows=100, seed=2)
    job = tmp_path / "job"
    args = cli.build_parser().parse_args(
        ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
         "--job-dir", str(job), "--train-steps", "6", "--batch-size", "64",
         "--steps-per-loop", "3", "--save-checkpoints-steps", "3", *flags])
    metrics, trainer = cli.train_and_evaluate(args)
    assert trainer.optimizer.name == opt_name
    assert len(trainer.step_losses) == 6 and np.isfinite(trainer.step_losses).all()
    assert 0.0 <= metrics["auc"] <= 1.0
    export = latest_export(job)
    got = load_model(export, device="cpu").predict(dict(FEATURES))
    want = jax_load_model(export).predict(dict(FEATURES))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=2e-2)
    if "--packed-col-pad" in flags:  # the pad columns stay zero and the leaf its shape
        table = params_tree(trainer.model)["table"]
        assert table.shape[1] == 8 and not table[:, 5:].any()


def test_fast_step_on_refuses_the_dnns_default_optimizer(tmp_path):
    """rectpu's fast-step check (common.py:299-301) now meets the families'
    optimizers: the DNN has the apply_looked hook, and its Adagrad is
    refused, since the sparse step is lazy Adam."""
    data = write_synthetic_dataset(tmp_path / "data", train_rows=100, test_rows=20, seed=2)
    args = deep_cli.build_parser().parse_args(
        ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
         "--job-dir", str(tmp_path / "job"), "--train-steps", "1", "--fast-step", "on"])
    with pytest.raises(ValueError, match="requires Adam \\(got Adagrad\\)"):
        deep_cli.train_and_evaluate(args)
