"""Checks shared by the port's EP exchange tests: the ranks' outputs of
``tests/torch_mp_worker.py`` assembled into global arrays, held against the
port's unsharded lookup and against rectpu's exchanges on its virtual CPU
devices (the tolerances are stated in ``tests/test_torch_parallel.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rectpu.parallel import embedding_ep as jax_ep
from rectpu.parallel import make_mesh as jax_make_mesh
from rectpu_torch.ops.embedding import lookup
from torch_mp_worker import LOOKUP_CASES, LOOKUP_K, lookup_inputs

GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
CASE = {c[0]: c for c in LOOKUP_CASES}


def assemble(mesh, results, name):
    """The global output (by batch slice) and table gradient (by shard)."""
    d_n, m_n = mesh
    mode = CASE[name][1]
    world = d_n * m_n
    got = [r[name] for r in results]
    keys = [k for k in got[0] if k != "grad"]
    if mode == "1d":
        for r in range(world):  # every model rank of a data row holds its slice
            for k in keys:
                np.testing.assert_array_equal(got[r][k], got[(r // m_n) * m_n][k])
        out = {k: np.concatenate([got[d * m_n][k] for d in range(d_n)]) for k in keys}
    else:
        out = {k: np.concatenate([got[r][k] for r in range(world)]) for k in keys}
    for r in range(world):  # the data replicas of a shard hold one gradient
        np.testing.assert_array_equal(got[r]["grad"], got[r % m_n]["grad"])
    out["grad"] = np.concatenate([got[m]["grad"] for m in range(m_n)])
    return out


def unsharded(name):
    """The port's unsharded lookup with the same cotangents."""
    _, _, flat, has_lin, _, _, _, bf16 = CASE[name]
    table, ids, ct, (ct_emb, ct_lin), table_bf16 = lookup_inputs()
    t = table_bf16 if bf16 else table
    if flat and not has_lin:
        t = t[:, :LOOKUP_K]
    tt = torch.tensor(t, requires_grad=True)
    looked = lookup(tt, torch.from_numpy(ids))
    if flat:
        b, f = ids.shape
        emb = looked[..., :LOOKUP_K].reshape(b, f * LOOKUP_K)
        loss = (emb * torch.from_numpy(ct_emb)).sum()
        out = {"emb": emb.detach().numpy()}
        if has_lin:
            lin = looked[..., LOOKUP_K].sum(dim=-1)
            loss = loss + (lin * torch.from_numpy(ct_lin)).sum()
            out["lin"] = lin.detach().numpy()
    else:
        loss = (looked * torch.from_numpy(ct)).sum()
        out = {"out": looked.detach().numpy()}
    loss.backward()
    out["grad"] = tt.grad.numpy()
    return out


def jax_case(mesh, name):
    """rectpu's exchange of the same case: (outputs, table gradient)."""
    _, mode, flat, has_lin, impl, cc, cap, bf16 = CASE[name]
    table, ids, ct, (ct_emb, ct_lin), table_bf16 = lookup_inputs()
    t = jnp.asarray(table_bf16 if bf16 else table)
    jm = jax_make_mesh(*mesh)
    if flat:
        make = {"1d": lambda: jax_ep.make_ep_lookup_flat(jm, scatter_impl=impl),
                "2d": lambda: jax_ep.make_ep_lookup_2d_flat(jm, comm_compress=cc,
                                                            scatter_impl=impl),
                "dedup": lambda: jax_ep.make_ep_lookup_dedup_flat(
                    jm, peer_capacity=cap, comm_compress=cc, scatter_impl=impl)}[mode]()

        def obj(tt):
            emb, lin = make(tt, jnp.asarray(ids), has_lin=True)
            return (emb * ct_emb).sum() + (lin * ct_lin).sum(), (emb, lin)
    else:
        make = {"1d": lambda: jax_ep.make_ep_lookup(jm),
                "2d": lambda: jax_ep.make_ep_lookup_2d(jm, comm_compress=cc),
                "dedup": lambda: jax_ep.make_ep_lookup_dedup(
                    jm, peer_capacity=cap, comm_compress=cc, scatter_impl=impl)}[mode]()

        def obj(tt):
            out = make(tt, jnp.asarray(ids))
            return (out * ct).sum(), (out,)
    (_, outs), grad = jax.value_and_grad(obj, has_aux=True)(t)
    return [np.asarray(o) for o in outs], np.asarray(grad)


def check_against_rectpu(ranks, name):
    """The exchange ``name`` equals rectpu's on the same mesh: its rows (the
    capacity-starved dedup drops the same lookups, with zero rows and no
    gradient), and its table gradient from the xla or mxu backward."""
    mesh, results = ranks
    got = assemble(mesh, results, name)
    outs, grad = jax_case(mesh, name)
    if CASE[name][2]:
        np.testing.assert_array_equal(got["emb"], outs[0])
        np.testing.assert_allclose(got["lin"], outs[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    else:
        np.testing.assert_array_equal(got["out"], outs[0])
    if "starved" in name:
        width = LOOKUP_K if CASE[name][2] else outs[0].shape[-1]
        dropped = np.all(outs[0].reshape(-1, width) == 0, axis=1)  # one a lookup
        assert dropped.any()  # the capacity really starves
    np.testing.assert_allclose(got["grad"], grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def check_compressed(ranks, name, against_rectpu):
    mesh, results = ranks
    got = assemble(mesh, results, name)
    ref = unsharded(name)
    key = "emb" if CASE[name][2] else "out"
    cc = CASE[name][5]
    if name.endswith("_exact"):
        np.testing.assert_array_equal(got[key], ref[key])
    elif cc == "bf16":
        np.testing.assert_allclose(got[key], ref[key], rtol=2 ** -8, atol=1e-6)
    else:
        # one scale per table row: its amax over the row's K+1 columns
        table, ids, _, _, _ = lookup_inputs()
        amax = np.abs(table[ids]).max(axis=-1, keepdims=True)
        r = ref[key].reshape(amax.shape[:2] + (-1,))
        assert np.all(np.abs(got[key].reshape(r.shape) - r) <= amax / 254 + 1e-6)
        np.testing.assert_allclose(got["grad"], ref["grad"], rtol=2 ** -7, atol=0.02)
    if against_rectpu:
        outs, grad = jax_case(mesh, name)
        np.testing.assert_allclose(got[key], outs[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["grad"], grad, rtol=2 ** -7, atol=0.02)


# -- composed sharded steps against rectpu's -------------------------------------------

def _rectpu_model(family, cfg_kw, model_kw, numeric=()):
    from rectpu import models as jm
    from rectpu.features.schema import ml_100k_feature_set

    classes = {"deep_fm": jm.DeepFMModel, "dlrm": jm.DLRMModel, "xdeep_fm": jm.XDeepFMModel,
               "linear_deep": jm.WideDeepModel, "deep": jm.DNNModel, "dcn": jm.DCNModel,
               "autoint": jm.AutoIntModel}
    cfg = jm.TowerConfig(feature_set=ml_100k_feature_set(numeric), embedding_size=4,
                         hidden_units=(16, 16), table_padding=128, **cfg_kw)
    return classes[family](cfg, **(model_kw or {}))


def port_init(family, cfg_kw, model_kw, numeric=()):
    """The port's seeded init of ``build_model``, as a jnp tree in rectpu's layout."""
    from torch_mp_worker import build_model

    _, params = build_model(family, cfg_kw, model_kw, numeric)
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()), params)


def flat_numpy(tree) -> dict:
    from rectpu_torch.convert import flatten_tree

    return {k: np.asarray(v, np.float32) for k, v in flatten_tree(jax.device_get(tree)).items()}


def rectpu_dense_steps(case, mesh=None):
    """rectpu's Trainer step (``Trainer._train_one``, jitted by the Trainer),
    STEP_STEPS times on ``mesh`` (a ParallelPlan's) or on one device, from the
    port's init and batches: (losses, flat global params)."""
    import tempfile

    from rectpu.parallel import ParallelPlan
    from rectpu.train.loop import TrainConfig, Trainer
    from rectpu.train.optimizers import BF16_SR, adam
    from torch_mp_worker import STEP_B, step_inputs

    _, family, cfg_kw, model_kw, bf16_slots, mode = case
    model = _rectpu_model(family, cfg_kw, model_kw)
    params = port_init(family, cfg_kw, model_kw)
    opt = adam(0.01, slot_dtype={"m": jnp.bfloat16, "v": BF16_SR} if bf16_slots else None)
    plan = None
    if mesh is not None:
        plan = ParallelPlan.create(*mesh, table_rows=model.cfg.padded_buckets, ep_mode=mode,
                                   scatter_impl=model.cfg.scatter_impl)
    trainer = Trainer(model, opt, None, None, tempfile.mkdtemp(),
                      TrainConfig(batch_size=STEP_B, seed=11), plan=plan)
    state = opt.init(params)
    if plan is not None:
        params, state = plan.shard_params(params), plan.shard_params(state)
    losses = []
    for i, b in enumerate(step_inputs()):
        b = plan.shard_batch(b) if plan is not None else {k: jnp.asarray(v) for k, v in b.items()}
        params, state, loss = trainer._train_one(params, state, jax.random.PRNGKey(0),
                                                 jnp.asarray(i), b)
        losses.append(float(loss))
    return np.asarray(losses), flat_numpy(params)


def rectpu_sparse_rows(mesh, mode, cap):
    """rectpu's ``make_sparse_rows_ep`` on ``mesh`` with the worker's inputs:
    (table, m|v) after one update."""
    from rectpu.parallel import make_mesh as jax_mesh
    from rectpu.parallel.sparse_ep import make_sparse_rows_ep
    from torch_mp_worker import sparse_rows_inputs

    table, mv, ids, dl, lr_t = sparse_rows_inputs()
    update = make_sparse_rows_ep(jax_mesh(*mesh), batch_2d=mode != "1d", peer_capacity=cap)
    t, m = jax.jit(update)(jnp.asarray(table), jnp.asarray(mv), jnp.asarray(ids),
                           jnp.asarray(dl), jnp.float32(lr_t))
    return np.asarray(t), np.asarray(m)


def rectpu_sparse_steps(mesh, mode):
    """rectpu's sparse fast step (packed DeepFM, lr 0.01) STEP_STEPS times on
    ``mesh`` from the port's init: (losses, flat global params, the table's
    m|v slab)."""
    from rectpu.parallel import ParallelPlan
    from rectpu.train.fast_step import make_sparse_step
    from torch_mp_worker import step_inputs

    cfg_kw = {"packed_linear": True}
    model = _rectpu_model("deep_fm", cfg_kw, None)
    params = port_init("deep_fm", cfg_kw, None)
    plan = ParallelPlan.create(*mesh, table_rows=model.cfg.padded_buckets, ep_mode=mode)
    init, step = make_sparse_step(model, learning_rate=0.01, plan=plan)
    state = plan.shard_params(init(params))
    params = plan.shard_params(params)
    jstep = jax.jit(step)
    losses = []
    for i, b in enumerate(step_inputs()):
        params, state, loss = jstep(params, state, plan.shard_batch(b), jax.random.PRNGKey(0),
                                    jnp.asarray(i))
        losses.append(float(loss))
    return np.asarray(losses), flat_numpy(params), np.asarray(state["mv_sparse"]["table"])


def update_rel_l2(got: dict, want: dict, start: dict) -> dict:
    """Per leaf: |(got - start) - (want - start)| / |want - start| (L2)."""
    out = {}
    for k, w in want.items():
        dw = w - start[k]
        out[k] = float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(dw), 1e-30))
    return out


DENSE_LOSS_RTOL, DENSE_PARAM_ATOL = 1e-6, 1e-4


def dense_ranks(mesh, tmp, cases, single=False):
    """The port's ranks of ``cases`` on ``mesh`` -> rank 0's results, after
    checking that every rank gathered the same global params."""
    from torch_mp_worker import run_ranks

    d, m = mesh
    got = run_ranks("dense_cases", d * m, tmp, num_data=d, num_model=m, cases=cases,
                    single=single)
    for r in got[1:]:
        for name in r:
            for k, v in r[name]["params"].items():
                np.testing.assert_array_equal(v, got[0][name]["params"][k])
    return got[0]


def check_dense_against_rectpu(mesh, got, case):
    """The port's sharded steps of ``case`` equal rectpu's on the same mesh
    (the tolerances are stated in ``tests/test_torch_ep_steps_rectpu.py``)."""
    losses, params = rectpu_dense_steps(case, mesh)
    mine = got[case[0]]
    np.testing.assert_allclose(mine["losses"], losses, rtol=DENSE_LOSS_RTOL)
    assert sorted(mine["params"]) == sorted(params)
    for k, want in params.items():
        np.testing.assert_allclose(mine["params"][k], want, rtol=0, atol=DENSE_PARAM_ATOL,
                                   err_msg=k)


# -- tensor-parallel towers --------------------------------------------------------------

def rectpu_step_seeds(steps: int = None) -> list:
    """The dropout seed32 of rectpu's Trainer step i (``jax.random.bits`` of
    ``fold_in(PRNGKey(0), i)``, ``rectpu/models/base.py:150``), which the
    port's ranks take in place of ``step_seed32``."""
    from torch_mp_worker import STEP_STEPS

    return [int(jax.random.bits(jax.random.fold_in(jax.random.PRNGKey(0), i), dtype=jnp.uint32))
            for i in range(steps or STEP_STEPS)]


def rectpu_tp_steps(name, mesh):
    """rectpu's sharded step of ``TP_CASES[name]`` under ``tp_mlp=True`` on
    ``mesh``, STEP_STEPS times from the port's init: the Trainer's
    ``_train_one`` (dropout seeded from ``PRNGKey(0)``), or for a fast case
    ``make_sparse_step`` jitted -> (losses, flat global params)."""
    import tempfile

    from rectpu.parallel import ParallelPlan
    from rectpu.train.fast_step import make_sparse_step
    from rectpu.train.loop import TrainConfig, Trainer
    from rectpu.train.optimizers import adam
    from torch_mp_worker import STEP_B, TP_CASES, step_inputs

    _, family, cfg_kw, model_kw, mode, numeric, fast = TP_CASES[name]
    model = _rectpu_model(family, cfg_kw, model_kw, numeric)
    params = port_init(family, cfg_kw, model_kw, numeric)
    plan = ParallelPlan.create(*mesh, table_rows=model.cfg.padded_buckets, ep_mode=mode,
                               scatter_impl=model.cfg.scatter_impl, tp_mlp=True)
    if fast:
        init, step = make_sparse_step(model, learning_rate=0.01, plan=plan)
        state = init(params)
        jstep = jax.jit(step)
    else:
        opt = adam(0.01)
        state = opt.init(params)
        trainer = Trainer(model, opt, None, None, tempfile.mkdtemp(),
                          TrainConfig(batch_size=STEP_B, seed=11), plan=plan)
    params, state = plan.shard_params(params), plan.shard_params(state)
    losses = []
    for i, b in enumerate(step_inputs(numeric=len(numeric))):
        b = plan.shard_batch(b)
        if fast:
            params, state, loss = jstep(params, state, b, jax.random.PRNGKey(0), jnp.asarray(i))
        else:
            params, state, loss = trainer._train_one(params, state, jax.random.PRNGKey(0),
                                                     jnp.asarray(i), b)
        losses.append(float(loss))
    return np.asarray(losses), flat_numpy(params)


def tp_ranks(mesh, tmp, names):
    """The port's ranks of the TP cases ``names`` on ``mesh`` (dropout seeded
    with rectpu's step seeds) -> rank 0's results, after checking that every
    rank gathered the same global params."""
    from torch_mp_worker import run_ranks

    d, m = mesh
    got = run_ranks("tp_cases", d * m, tmp, num_data=d, num_model=m, names=names,
                    seeds=rectpu_step_seeds())
    for r in got[1:]:
        for name in r:
            for k, v in r[name]["params"].items():
                np.testing.assert_array_equal(v, got[0][name]["params"][k])
    return got[0]


def check_tp_against_rectpu(mesh, got, name, loss_rtol=DENSE_LOSS_RTOL,
                            param_atol=DENSE_PARAM_ATOL):
    """The port's TP steps of ``name`` equal rectpu's on the same mesh."""
    losses, params = rectpu_tp_steps(name, mesh)
    mine = got[name]
    np.testing.assert_allclose(mine["losses"], losses, rtol=loss_rtol)
    assert sorted(mine["params"]) == sorted(params)
    for k, want in params.items():
        np.testing.assert_allclose(mine["params"][k], want, rtol=0, atol=param_atol, err_msg=k)
    return losses, params
