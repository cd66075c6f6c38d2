"""The tensor-parallel towers' sharding rules (``rectpu_torch/parallel/plan.py``
``tp_spec``, ``ParallelPlan.shard_params`` / ``gather_params`` under
``tp_mlp``) against rectpu's ``ParallelPlan._tp_spec`` (``rectpu/parallel/
plan.py:140-184``) on the same trees:

  - rectpu's ``test_tp_param_sharding_rules`` (``tests/test_sharding.py:575``)
    on the port's DeepFM tree, hidden (16, 16), at 2 and 4 model shards: the
    column-sharded even layer and its bias, the row-sharded odd layer and its
    replicated bias, the row-sharded logit, the table's EP rows;
  - DLRM's ``bot`` and ``top`` towers with a width 'model' does not divide;
  - the optimizer-state twins, matched by path suffix;
  - the spec of every leaf of the DeepFM, DLRM, DCN and xDeepFM trees and of
    rectpu's Adam state on them equal to rectpu's;
  - shard -> gather gives the tree back bit for bit (2x2 and 1x4 meshes over
    Gloo, ``tests/torch_mp_worker.py``).

The cuts run on a mesh view with no process group (``fake_mesh``); only the
gather spawns ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.parallel import ParallelPlan as JaxPlan
from rectpu_torch.convert import flat_params, flatten_tree, load_params, opt_state_tree
from rectpu_torch.parallel.plan import ParallelPlan, key_path, tp_spec
from rectpu_torch.train.optimizers import adam
from torch_mp_worker import build_model, fake_mesh, run_ranks

NUMERIC = ("age", "action")
# (family, model kwargs, numeric columns): DLRM's bottom MLP (6,) is divided
# by 2 model shards and not by 4
TREES = (("deep_fm", {}, ()),
         ("dlrm", {"bot_hidden_units": (6,), "interaction_impl": "xla"}, NUMERIC),
         ("dcn", {"num_cross_layers": 2}, ()),
         ("xdeep_fm", {"cin_units": (8, 8)}, ()))
COL, ROW, BIAS, REP = (None, "model"), ("model", None), ("model",), ()


def _cut(family, model_kw, numeric, num_model, rank=0, num_data=2):
    model, params = build_model(family, {}, model_kw, numeric)
    plan = ParallelPlan.create(num_data, num_model, table_rows=model.cfg.padded_buckets,
                               tp_mlp=True, mesh=fake_mesh(num_data, num_model, rank))
    return model, params, plan


def _specs(tree, num_model) -> dict:
    return {k: tp_spec(key_path(k), v, num_model) for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("num_model", [2, 4])
def test_tp_param_sharding_rules(num_model):
    """rectpu's rules on the port's DeepFM tree (ml-100k, K=4, (16, 16)),
    rank by rank: the cut of each leaf is its block of the global leaf."""
    for rank in range(2 * num_model):
        model, params, plan = _cut("deep_fm", {}, (), num_model, rank)
        specs = _specs(params, num_model)
        assert specs["mlp/0/kernel"] == COL and specs["mlp/0/bias"] == BIAS
        assert specs["mlp/1/kernel"] == ROW and specs["mlp/1/bias"] == REP
        assert specs["mlp/2/kernel"] == ROW and specs["mlp/2/bias"] == REP  # the logit
        assert specs["emb"] is None and specs["linear/w"] is None
        m, w = rank % num_model, 16 // num_model
        cut = plan.shard_params(params)
        mlp = params["mlp"]
        np.testing.assert_array_equal(cut["mlp"][0]["kernel"],
                                      mlp[0]["kernel"][:, m * w:(m + 1) * w])
        np.testing.assert_array_equal(cut["mlp"][0]["bias"], mlp[0]["bias"][m * w:(m + 1) * w])
        np.testing.assert_array_equal(cut["mlp"][1]["kernel"],
                                      mlp[1]["kernel"][m * w:(m + 1) * w])
        assert cut["mlp"][1]["bias"] is mlp[1]["bias"]
        np.testing.assert_array_equal(cut["mlp"][2]["kernel"],
                                      mlp[2]["kernel"][m * w:(m + 1) * w])
        v = model.cfg.padded_buckets // num_model
        np.testing.assert_array_equal(cut["emb"], params["emb"][m * v:(m + 1) * v])
        tp = plan.tower_parallel("mlp")
        assert tp.kernel_dims == (1, 0, 0) and tp.gather_rows and tp.axis.index == m


@pytest.mark.parametrize("num_model", [2, 4])
def test_dlrm_towers_and_a_width_model_does_not_divide(num_model):
    """DLRM's ``bot`` ([2, 6], [6, 4]) and ``top``: 6 is divided by 2 model
    shards (column, then row) and not by 4 (both layers replicated)."""
    _, params, plan = _cut("dlrm", TREES[1][1], NUMERIC, num_model)
    specs = _specs(params, num_model)
    if num_model == 2:
        assert (specs["bot/0/kernel"], specs["bot/0/bias"]) == (COL, BIAS)
        assert (specs["bot/1/kernel"], specs["bot/1/bias"]) == (ROW, REP)
    else:
        assert all(specs[f"bot/{i}/{k}"] == REP for i in (0, 1) for k in ("kernel", "bias"))
    assert (specs["top/0/kernel"], specs["top/1/kernel"], specs["top/2/kernel"]) == (COL, ROW,
                                                                                      ROW)
    plan.shard_params(params)
    assert plan.tower_parallel("bot").kernel_dims == ((1, 0) if num_model == 2 else
                                                      (None, None))


@pytest.mark.parametrize("num_model", [2, 4])
def test_optimizer_state_twins_follow_the_params(num_model):
    """Each tower leaf of the Adam state (rectpu's tree, ``opt_state/m/...``
    and ``opt_state/v/...``) is cut as its parameter is."""
    model, params, plan = _cut("deep_fm", {}, (), num_model, rank=num_model - 1)
    state = opt_state_tree(adam(0.01).init(flat_params(load_params(model, params))))
    gen = torch.Generator().manual_seed(0)
    state = jax.tree.map(lambda t: torch.randn(t.shape, generator=gen), state)
    cut = flatten_tree(plan.shard_params({"params": params, "opt_state": state}))
    whole = flatten_tree({"params": params, "opt_state": state})
    twins = 0
    for key, leaf in cut.items():
        if not key.startswith("opt_state/") or key == "opt_state/t":
            continue
        suffix = key.split("/", 2)[2]
        spec = tp_spec(key_path(key), whole[key], num_model)
        assert spec == tp_spec(key_path(suffix), whole["params/" + suffix], num_model), key
        assert leaf.shape == cut["params/" + suffix].shape, key
        if spec is not None:
            twins += 1
            m, dim = num_model - 1, spec.index("model") if "model" in spec else None
            if dim is not None:
                w = whole[key].shape[dim] // num_model
                want = whole[key].narrow(dim, m * w, w)
                np.testing.assert_array_equal(leaf, want)
    assert twins == 2 * 6  # m and v of three layers' kernel and bias


def _rectpu_specs(tree, num_model) -> dict:
    """rectpu's ``_tp_spec`` of every leaf of a jnp tree, by key path."""
    plan = JaxPlan.create(2, num_model, tp_mlp=True)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = plan._tp_spec(path, leaf)
        keys = [getattr(p, "key", getattr(p, "idx", getattr(p, "name", None))) for p in path]
        out["/".join(map(str, keys))] = None if spec is None else tuple(spec)
    return out


@pytest.mark.parametrize("num_model", [2, 4])
@pytest.mark.parametrize("tree", TREES, ids=[t[0] for t in TREES])
def test_every_leaf_spec_equals_rectpus(tree, num_model):
    """The port's ``tp_spec`` of every parameter equals rectpu's ``_tp_spec``
    of the same leaf, and of every tower leaf of rectpu's Adam state (its
    optax tree) equals the port's spec of the parameter at that suffix."""
    from rectpu.train.optimizers import adam as jax_adam

    family, model_kw, numeric = tree
    _, params = build_model(family, {}, model_kw, numeric)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()), params)
    mine = _specs(params, num_model)
    assert mine == _rectpu_specs(jtree, num_model)
    assert any(v not in (None, REP) for v in mine.values())
    theirs = _rectpu_specs(jax_adam(0.01).init(jtree), num_model)
    matched = 0
    for key, spec in theirs.items():
        for suffix in mine:
            if key.endswith("/" + suffix) and mine[suffix] is not None:
                assert spec == mine[suffix], (key, spec, mine[suffix])
                matched += 1
    assert matched == 2 * sum(v is not None for v in mine.values())  # mu and nu


def test_shard_then_gather_gives_the_tree_back(tmp_path):
    """``gather_params`` of ``shard_params`` is the identity, bit for bit, for
    the params and a seeded Adam state of DeepFM and DLRM on 1x4 (DLRM's
    width 6 replicated) and 2x2 meshes, on every rank; each rank holds its
    cut's shapes."""
    trees = [TREES[0], TREES[1]]
    got = run_ranks("tp_roundtrip", 4, tmp_path, meshes=[(1, 4), (2, 2)], trees=trees)
    for rank, res in enumerate(got):
        for (mesh, family), r in res.items():
            assert r["equal"], (rank, mesh, family)
            m = rank % mesh[1]
            if family == "deep_fm":
                w = 16 // mesh[1]
                assert r["shapes"]["params/mlp/0/kernel"] == (104, w)
                assert r["shapes"]["opt_state/v/mlp/1/kernel"] == (w, 16)
                assert r["shapes"]["params/mlp/1/bias"] == (16,), m
            else:
                bot = (2, 6) if mesh[1] == 4 else (2, 3)
                assert r["shapes"]["params/bot/0/kernel"] == bot
