"""Slice-level checks of the port's DCN-v2 and AutoInt against rectpu.

  - Forward: the port's seeded ``init`` makes a tree in rectpu's layout
    (every leaf then made random: zero biases and linear weights would hide
    a wrong path), ``rectpu_torch.convert`` carries it across (``rectpu_torch.convert``), and both
    packages' logits on the same batch agree. DCN: full and low rank, the
    flat layout and the [B, F, K] form, with and without a numeric field,
    fp32 and bf16 towers. AutoInt: each ``att_impl``, the grouped form's
    fallback on a batch its group does not divide, the packed, fused and
    unfused linear towers and ``--exclude-linear``, the flat layout and the
    3-D form. The port's init has the tree and shapes of rectpu's.
  - Training: 3 steps from the same weights on the same batches, dropout 0,
    Adam(1e-3) (rectpu: a jitted value_and_grad and its Adam; the port:
    ``Trainer.train_step``), and 3 sparse fast steps of DCN and of packed
    AutoInt (rectpu's ``make_sparse_step``; the port's): per-step losses
    and final weights, and the fast steps' optimizer state, compared.
  - Serving: rectpu's exports served by the port and the port's by rectpu,
    and each trainer CLI on ``--device cpu`` with an export both serve.

Tolerances. fp32: logits within 1e-5 absolute (sums in another order, ~1e-7
relative); losses within 1e-5 relative; each leaf's update over the 3 steps
within 1e-4 relative L2 (Adam's first steps are ~lr*sign(g)/..., a few fp32
ulps of a step apart). bf16 towers: logits within 2e-2 absolute, the bound
the other families' bf16 checks use (one bf16 ulp, 2^-8 relative, of an
activation moved by its weight). AutoInt's attention in bf16: rectpu
multiplies bf16 values and sums in fp32 (``autoint.py:183-198``), and XLA on
the CPU keeps those products exact, as the port's fp32 einsums do; so
its bf16 forms differ from rectpu's only by the order of fp32 sums and the
roundings that order moves, inside the same 2e-2. bf16 steps: losses within
BF16_LOSS_RTOL relative, each leaf's update within BF16_UPDATE_REL_L2 (see
there why these are wider than the 1e-4 and 2e-2 of DeepFM's bf16 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.models import AutoIntModel as JaxAutoInt
from rectpu.models import DCNModel as JaxDCN
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.serve.export import export_model as jax_export_model
from rectpu.serve.export import load_model as jax_load_model
from rectpu.train import optimizers as jax_opt
from rectpu.train.fast_step import make_sparse_step as jax_make_sparse_step
from rectpu.train.metrics import sigmoid_xent as jax_xent
from rectpu_torch.convert import flat_params, flatten_tree, load_params, params_tree
from rectpu_torch.convert import sparse_state_tree
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import AutoIntModel, DCNModel, TowerConfig
from rectpu_torch.serve.export import export_model, latest_export, load_model
from rectpu_torch.train import optimizers as t_opt
from rectpu_torch.train.fast_step import make_sparse_step
from rectpu_torch.train.loop import TrainConfig, Trainer
from rectpu_torch.trainers import autoint as autoint_cli
from rectpu_torch.trainers import dcn as dcn_cli

FAMILIES = {"dcn": (JaxDCN, DCNModel), "autoint": (JaxAutoInt, AutoIntModel)}
NUMERIC = ("action",)
BF16 = dict(compute_dtype="bfloat16")
FLAT_BF16 = dict(compute_dtype="bfloat16", table_grad_dtype="bfloat16", flat_layout=True,
                 scatter_impl="mxu", table_padding=2048)

# name: (family, TowerConfig kwargs, model kwargs, numeric columns)
CASES = {
    "dcn_full": ("dcn", dict(embedding_size=4, hidden_units=(16,)), {}, ()),
    "dcn_full_numeric": ("dcn", dict(embedding_size=4, hidden_units=(16, 8)),
                         dict(num_cross_layers=2), NUMERIC),
    "dcn_low_rank_numeric_bf16": ("dcn", dict(embedding_size=4, hidden_units=(16,), **BF16),
                                  dict(low_rank=8), NUMERIC),
    "dcn_flat_low_rank": ("dcn", dict(embedding_size=4, hidden_units=(16,), flat_layout=True),
                          dict(low_rank=8), ()),
    "dcn_flat_bf16": ("dcn", dict(embedding_size=8, hidden_units=(16,), **FLAT_BF16),
                      dict(num_cross_layers=2), ()),
    "autoint_broadcast_fused": ("autoint", dict(embedding_size=8), {}, ()),
    "autoint_broadcast_numeric_bf16": ("autoint", dict(embedding_size=8, **BF16), {}, NUMERIC),
    "autoint_bf16_impl_numeric_bf16": ("autoint", dict(embedding_size=8, **BF16),
                                       dict(att_impl="bf16", num_heads=4), NUMERIC),
    "autoint_grouped_packed": ("autoint", dict(embedding_size=8, packed_linear=True),
                               dict(att_impl="grouped", att_group=4), NUMERIC),
    "autoint_grouped_ragged_unfused": ("autoint", dict(embedding_size=8,
                                                       fuse_linear_lookup=False),
                                       dict(att_impl="grouped", att_group=5, num_layers=3),
                                       NUMERIC),
    "autoint_grouped_bf16_exclude_linear": ("autoint", dict(embedding_size=8, **BF16),
                                            dict(att_impl="grouped", att_group=8,
                                                 use_linear=False), ()),
    "autoint_packed_pad": ("autoint", dict(embedding_size=8, packed_linear=True,
                                           packed_col_pad=16), dict(head_dim=3), ()),
    "autoint_flat_bf16_impl": ("autoint", dict(embedding_size=8, packed_linear=True,
                                               flat_layout=True), dict(att_impl="bf16"), ()),
    "autoint_flat_bf16_grouped": ("autoint", dict(embedding_size=8, packed_linear=True,
                                                  **FLAT_BF16),
                                  dict(att_impl="grouped", att_group=4), ()),
}
BATCH = 24  # att_group 4 and 8 divide it, 5 does not
# bf16 steps. A hidden layer's bf16 bias gets the batch sum of its bf16
# cotangent: XLA on the CPU reduces it in bf16 (the HLO's reduce type), the
# port sums in fp32 and rounds once. At the first step of the low-rank DCN
# case below that is 5.1e-3 relative L2 between the two top/0/bias
# gradients; a reference patched to sum in fp32 is 1.9e-3 from the port,
# one rounding. Adam steps a near-zero component by ~lr either way, so the
# difference grows to 3.2e-4 relative in the loss and 3.8e-2 relative L2 in
# the update of the first cross layer's v by step 3 (1.2e-4 in the loss of
# the fast steps), against a 1e-4 / 2e-2 bound for DeepFM, whose FM and
# linear terms dilute the tower
BF16_LOSS_RTOL, BF16_UPDATE_REL_L2 = 5e-4, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on few cores; one intra-op thread keeps
    these small-shape tests from crowding the workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(family, cfg, kwargs=None, numeric=()):
    jax_cls, port_cls = FAMILIES[family]
    kw = kwargs or {}
    model_j = jax_cls(JaxTowerConfig(feature_set=jax_feature_set(numeric=numeric), **cfg), **kw)
    model_t = port_cls(TowerConfig(feature_set=ml_100k_feature_set(numeric=numeric), **cfg),
                       **kw)
    return model_j, model_t


def _params(model_t, seed: int, randomize: bool = True):
    """A weight tree in rectpu's layout (numpy leaves) from the port's seeded
    init, whose tree is rectpu's (``test_port_init_has_rectpus_tree``;
    rectpu's own init compiles a random op per shape, seconds a case). With
    ``randomize`` every leaf is then random: tables at 0.3, the rest at 0.2;
    a packed table's pad columns stay zero."""
    tree = jax.tree.map(lambda t: t.numpy(), model_t.init(torch.Generator().manual_seed(seed)))
    if not randomize:
        return tree
    rng = np.random.default_rng(seed)
    k = model_t.cfg.embedding_size
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        table = "emb" in name or "table" in name
        arr = rng.normal(0.0, 0.3 if table else 0.2, leaf.shape).astype(np.float32)
        if "table" in name:
            arr[:, k + 1:] = 0.0
        leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batches(fs, n, b, seed):
    rng = np.random.default_rng(seed)
    return [{"cat_ids": np.stack([fs.offsets[f] + rng.integers(0, fs.field_sizes[f], b)
                                  for f in range(fs.num_fields)], axis=1).astype(np.int32),
             "num_vals": rng.integers(0, 2, (b, fs.num_numeric)).astype(np.float32),
             "labels": (rng.random(b) < 0.3).astype(np.float32)} for _ in range(n)]


def _leaf(tree, path):
    for p in path:
        tree = tree[getattr(p, "key", getattr(p, "idx", None))]
    return tree


def _case_params(case, seed):
    family, cfg, kw, numeric = CASES[case]
    model_j, model_t = _models(family, cfg, kw, numeric)
    return model_j, model_t, _params(model_t, seed)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_rectpu(case):
    family, cfg, kw, numeric = CASES[case]
    model_j, model_t, params = _case_params(case, seed=len(case))
    load_params(model_t, params)
    (batch,) = _batches(model_j.cfg.feature_set, 1, BATCH, seed=5)
    want = np.asarray(jax.jit(model_j.apply)(_jnp(params), _jnp(batch)))
    got = model_t(torch.from_numpy(batch["cat_ids"]), torch.from_numpy(batch["num_vals"]))
    assert got.shape == (BATCH,) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1  # the comparison is not of zeros
    atol = 2e-2 if cfg.get("compute_dtype") == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)
    # the carrier gives back rectpu's tree, leaf for leaf
    tree = params_tree(model_t)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(_leaf(tree, path).float().numpy(), leaf)


def test_grouped_attention_falls_back_on_a_ragged_batch():
    """rectpu's grouped form falls back to the broadcast form when the batch
    is not a multiple of ``att_group`` (``autoint.py:174``); the port does the
    same, and the grouped form of a divisible batch is the broadcast form up
    to the order of the sums."""
    model_j, grouped, params = _case_params("autoint_grouped_ragged_unfused", seed=3)
    broadcast = AutoIntModel(grouped.cfg, att_impl="broadcast", num_layers=3)
    load_params(grouped, params)
    load_params(broadcast, params)
    fs = model_j.cfg.feature_set
    for b in (23, 25):  # 5 divides 25 only
        (batch,) = _batches(fs, 1, b, seed=b)
        ids, num = torch.from_numpy(batch["cat_ids"]), torch.from_numpy(batch["num_vals"])
        g, bc = grouped(ids, num), broadcast(ids, num)
        if b % grouped.att_group:
            assert torch.equal(g, bc)
        else:
            np.testing.assert_allclose(g.detach().numpy(), bc.detach().numpy(), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("family,cfg,kw", [
    ("dcn", dict(embedding_size=4, hidden_units=(8,)), dict(low_rank=3, num_cross_layers=2)),
    ("autoint", dict(embedding_size=6, packed_linear=True, packed_col_pad=16),
     dict(num_heads=4)),
])
def test_port_init_has_rectpus_tree(family, cfg, kw):
    """The port's seeded init makes rectpu's tree: the same leaves, shapes and
    dtypes, zero biases (and zero linear weights and pad columns)."""
    model_j, model_t = _models(family, cfg, kw, NUMERIC)
    want = jax.eval_shape(model_j.init, jax.random.PRNGKey(0))
    got = model_t.init(torch.Generator().manual_seed(0))
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, want))
            == jax.tree.structure(jax.tree.map(lambda a: 0, got)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        t = _leaf(got, path)
        assert tuple(t.shape) == leaf.shape, jax.tree_util.keystr(path)
        if jax.tree_util.keystr(path).endswith("['b']"):
            assert not t.any()
    if family == "autoint" and model_t.use_linear:
        assert model_t.head_dim == max(cfg["embedding_size"] // model_t.num_heads, 1)
        assert not got["table"][:, cfg["embedding_size"]:].any()


STEP_CASES = ["dcn_full", "dcn_low_rank_numeric_bf16", "dcn_flat_bf16",
              "autoint_grouped_ragged_unfused", "autoint_flat_bf16_grouped"]


def _hold(losses_t, losses_j, tree_t, tree_j, tree0, loss_rtol, update_rel_l2):
    for i, (lt, lj) in enumerate(zip(losses_t, losses_j)):
        assert abs(lt - lj) <= loss_rtol * abs(lj), (i, lt, lj)
    for path, w in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
        g, w = _leaf(tree_t, path).float().numpy(), np.asarray(w, np.float32)
        w0 = np.asarray(_leaf(tree0, path), np.float32)
        du, dw = g - w0, w - w0
        rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
        assert rel <= update_rel_l2, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("case", STEP_CASES)
def test_three_adam_steps_match_rectpu(case, tmp_path):
    family, cfg, kw, numeric = CASES[case]
    model_j, model_t = _models(family, {**cfg, "dropout": 0.0}, kw, numeric)
    bf16 = cfg.get("compute_dtype") == "bfloat16"
    # bf16 towers from the init as it is (the flagship case's scales)
    tree0 = _params(model_t, seed=3, randomize=not bf16)
    params = _jnp(tree0)
    opt_j, opt_t = model_j.default_optimizer(), model_t.default_optimizer()
    assert opt_j.name == opt_t.name == "Adam"

    @jax.jit
    def step_j(params, state, batch):
        def loss_fn(p):
            return jax_xent(model_j.apply(p, batch, train=True), batch["labels"]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = opt_j.update(grads, state, params)
        return params, state, loss

    load_params(model_t, tree0)
    trainer = Trainer(model_t, opt_t, None, None, tmp_path, TrainConfig(seed=0))
    trainer.opt_state = opt_t.init(flat_params(model_t))
    state_j, losses_j, losses_t = opt_j.init(params), [], []
    for i, batch in enumerate(_batches(model_j.cfg.feature_set, 3, 48, seed=8)):
        params, state_j, loss = step_j(params, state_j,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        losses_j.append(float(loss))
        losses_t.append(float(trainer.train_step(
            {k: torch.from_numpy(v) for k, v in batch.items()}, i)))
    _hold(losses_t, losses_j, params_tree(model_t), jax.tree.map(np.asarray, params), tree0,
          *((BF16_LOSS_RTOL, BF16_UPDATE_REL_L2) if bf16 else (1e-5, 1e-4)))


# name: (CASES entry, rectpu's and the port's scatter backend)
FAST_CASES = {"dcn_full": "auto", "dcn_low_rank_numeric_bf16": "xla",
              "autoint_grouped_packed": "auto"}


@pytest.mark.parametrize("case", list(FAST_CASES))
def test_three_fast_steps_match_rectpu(case, tmp_path):
    """DCN is the first [V, K] table without a linear tower to reach the fast
    step from a CLI; packed AutoInt's linear bias and numeric weight ride the
    fast step's ``linear_rest`` subtree."""
    family, cfg, kw, numeric = CASES[case]
    model_j, model_t = _models(family, {**cfg, "dropout": 0.0}, kw, numeric)
    bf16 = cfg.get("compute_dtype") == "bfloat16"
    tree0 = _params(model_t, seed=5)
    params = _jnp(tree0)
    backend = FAST_CASES[case]
    init_j, step_j = jax_make_sparse_step(model_j, learning_rate=1e-3, scatter_backend=backend)
    step_j = jax.jit(step_j)
    load_params(model_t, tree0)
    fast = make_sparse_step(model_t, learning_rate=1e-3, scatter_backend=backend)
    trainer = Trainer(model_t, t_opt.adam(1e-3), None, None, tmp_path, TrainConfig(seed=0),
                      fast_step=fast)
    trainer.opt_state = fast[0](flat_params(model_t))
    state_j, losses_j, losses_t = init_j(params), [], []
    for i, batch in enumerate(_batches(model_j.cfg.feature_set, 3, 48, seed=7)):
        params, state_j, loss = step_j(params, state_j,
                                       {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.PRNGKey(0), jnp.asarray(i))
        losses_j.append(float(loss))
        losses_t.append(float(trainer.train_step(
            {k: torch.from_numpy(v) for k, v in batch.items()}, i)))
    _hold(losses_t, losses_j, params_tree(model_t), jax.tree.map(np.asarray, params), tree0,
          *((BF16_LOSS_RTOL, BF16_UPDATE_REL_L2) if bf16 else (1e-5, 1e-4)))
    state_t = flatten_tree(sparse_state_tree(model_t, trainer.opt_state))
    state_j = flatten_tree(jax.device_get(state_j))
    assert sorted(state_t) == sorted(state_j)
    for key, w in state_j.items():
        w = np.asarray(w, np.float32)
        tol = (2e-2 if bf16 else 1e-5) * max(np.abs(w).max(), 1e-30)
        assert np.abs(state_t[key].float().numpy() - w).max() <= tol, key


FEATURES = {
    "user_id": np.array([1, 7, 942, 55, 300]),
    "item_id": np.array([10, 55, 1682, 1, 999]),
    "age": np.array([25, 40, 15, 65, 33]),
    "gender": np.array(["F", "M", "M", "X", "F"]),
    "occupation": np.array(["student", "writer", "engineer", "none", "artist"]),
    "zipcode": np.array(["85711", "10027", "02139", "94043", "T8H1N"]),
    "release_year": np.array([1994, 1987, 1930, 1997, 1960]),
    "action": np.array([1, 0, 1, 0, 0]),
}


@pytest.mark.parametrize("case", ["dcn_low_rank_numeric_bf16", "autoint_packed_pad",
                                  "autoint_grouped_ragged_unfused",
                                  "autoint_grouped_bf16_exclude_linear"])
def test_exports_served_both_ways(case, tmp_path):
    """A rectpu export served by the port, and the port's export of the same
    weights served by rectpu: both packages' predictions agree."""
    model_j, model_t, params = _case_params(case, seed=11)
    atol = 2e-2 if CASES[case][1].get("compute_dtype") == "bfloat16" else 1e-5
    d_j = jax_export_model(_jnp(params), model_j, tmp_path / "jax", step=1)
    want = jax_load_model(d_j).predict(dict(FEATURES))
    served = load_model(d_j, device="cpu")
    assert type(served.model).__name__ == type(model_j).__name__
    for k in model_j.EXPORT_KWARGS:
        assert getattr(served.model, k) == getattr(model_j, k), k
    np.testing.assert_allclose(served.predict(dict(FEATURES))["logits"], want["logits"],
                               rtol=0, atol=atol)
    d_t = export_model(params, model_t, tmp_path / "port", step=1)
    got = jax_load_model(d_t).predict(dict(FEATURES))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=atol)


# name: (CLI, extra flags)
CLI_CASES = {
    "dcn": (dcn_cli, ["--num-cross-layers", "2"]),
    "dcn_scaled_low_rank_fast_step": (dcn_cli, ["--preset", "scaled", "--embedding-size", "8",
                                                "--cross-rank", "4", "--fast-step", "on",
                                                "--sparse-scatter", "dma"]),
    "autoint_scaled_grouped": (autoint_cli, ["--preset", "scaled", "--embedding-size", "8",
                                             "--att-impl", "grouped", "--att-group", "8"]),
    "autoint_exclude_linear_fast_step": (autoint_cli, ["--embedding-size", "8",
                                                       "--exclude-linear", "--head-dim", "3",
                                                       "--numeric-columns", "action",
                                                       "--fast-step", "on"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_trainer_cli_on_cpu_writes_an_export_both_packages_serve(case, tmp_path):
    cli, flags = CLI_CASES[case]
    data = write_synthetic_dataset(tmp_path / "data", train_rows=400, test_rows=100, seed=2)
    job = tmp_path / "job"
    args = cli.build_parser().parse_args(
        ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
         "--job-dir", str(job), "--train-steps", "6", "--batch-size", "64",
         "--steps-per-loop", "3", "--save-checkpoints-steps", "3", *flags])
    metrics, trainer = cli.train_and_evaluate(args)
    assert trainer.optimizer.name == "Adam"
    assert (trainer.fast_step is not None) == ("--fast-step" in flags)
    assert len(trainer.step_losses) == 6 and np.isfinite(trainer.step_losses).all()
    assert 0.0 <= metrics["auc"] <= 1.0
    export = latest_export(job)
    got = load_model(export, device="cpu").predict(dict(FEATURES))
    want = jax_load_model(export).predict(dict(FEATURES))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=2e-2)
