"""Rank processes for the port's sharded CPU tests (``tests/test_torch_parallel.py``,
``tests/test_torch_sparse_ep.py``).

``run_ranks(name, world, tmp_path, **kwargs)`` spawns ``world`` processes
that join one Gloo process group (a FileStore in ``tmp_path``, so parallel
test workers need no ports), each runs ``CASES[name](**kwargs)`` and pickles
its dict of numpy arrays; the caller gets the ranks' dicts in rank order.
This module imports only torch, numpy and ``rectpu_torch``: the rank
processes never load JAX; the test process compares their outputs with
rectpu's.

The inputs are made from numpy seeds, identically in every rank and in the
test process (``lookup_inputs``, ``step_inputs``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import traceback
from pathlib import Path

import numpy as np

LOOKUP_V, LOOKUP_K, LOOKUP_F, LOOKUP_B = 256, 4, 6, 16


def run_ranks(name: str, world: int, tmp_path, timeout: float = 240.0, **kwargs) -> list:
    tmp_path = Path(tmp_path)
    store = tmp_path / f"store_{name}_{world}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, str(store), name, kwargs,
                                               str(tmp_path / f"{name}_{world}_{r}.pkl")))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    if alive:
        raise TimeoutError(f"{len(alive)} rank(s) of {name} did not finish in {timeout} s")
    out = []
    for r in range(world):
        with open(tmp_path / f"{name}_{world}_{r}.pkl", "rb") as f:
            got = pickle.load(f)  # written by the rank processes above
        if isinstance(got, str):
            raise AssertionError(f"rank {r} of {name} failed:\n{got}")
        out.append(got)
    return out


def _entry(rank, world, store, name, kwargs, out):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            result = CASES[name](**kwargs)
        finally:
            dist.destroy_process_group()
    except BaseException:  # the test process raises it with the rank's traceback
        result = traceback.format_exc()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def lookup_inputs(seed: int = 0):
    """(table [V, K+1] fp32, ids [B, F] int32 with repeats, cotangent rows
    [B, F, K+1], flat cotangents ([B, F*K], [B]), a bf16-exact table)."""
    rng = np.random.default_rng(seed)
    v, k, f, b = LOOKUP_V, LOOKUP_K, LOOKUP_F, LOOKUP_B
    table = rng.normal(size=(v, k + 1)).astype(np.float32)
    # fields of 3, 8 and 256 values: duplicates within and across ranks
    highs = [3, 8, v, 3, 40, v]
    ids = np.stack([rng.integers(0, h, size=b) * (v // h) % v for h in highs], 1)
    ids = ids.astype(np.int32)
    ct = rng.normal(size=(b, f, k + 1)).astype(np.float32)
    ct_emb = rng.normal(size=(b, f * k)).astype(np.float32)
    ct_lin = rng.normal(size=(b,)).astype(np.float32)
    table_bf16 = _bf16_round(table)
    return table, ids, ct, (ct_emb, ct_lin), table_bf16


def _bf16_round(a):
    import torch

    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


LOOKUP_CASES = (
    # (name, mode, flat, has_lin, scatter_impl, comm_compress, peer_capacity, bf16 table)
    [(f"{m}", m, False, True, "xla", None, None, False) for m in ("1d", "2d", "dedup")]
    + [(f"{m}_flat_lin{int(h)}_{s}", m, True, h, s, None, None, False)
       for m in ("1d", "2d", "dedup") for h in (True, False) for s in ("xla", "mxu")]
    + [("dedup_mxu", "dedup", False, True, "mxu", None, None, False),
       ("dedup_starved", "dedup", False, True, "xla", None, 2, False),
       ("dedup_flat_starved_mxu", "dedup", True, True, "mxu", None, 2, False),
       ("2d_bf16_exact", "2d", False, True, "xla", "bf16", None, True),
       ("dedup_bf16_exact", "dedup", False, True, "xla", "bf16", None, True),
       ("2d_bf16", "2d", False, True, "xla", "bf16", None, False),
       ("dedup_bf16", "dedup", False, True, "xla", "bf16", None, False),
       ("dedup_int8", "dedup", False, True, "xla", "int8", None, False),
       ("2d_flat_bf16_mxu", "2d", True, True, "mxu", "bf16", None, False),
       ("dedup_flat_int8", "dedup", True, True, "xla", "int8", None, False)]
)


def fake_mesh(d, m, rank=0):
    """A mesh view of rank ``rank`` with no process group (for the plan's
    checks and cuts, which run no collective)."""
    import torch

    from rectpu_torch.parallel.mesh import Axis, Mesh

    world = Axis("world", None, d * m, rank, tuple(range(d * m)))
    data = Axis("data", None, d, rank // m, tuple(range(rank % m, d * m, m)))
    model = Axis("model", None, m, rank % m, tuple(range((rank // m) * m, (rank // m + 1) * m)))
    return Mesh(d, m, rank, torch.device("cpu"), None, data, model, world)


def _plan(num_data, num_model, **kw):
    from rectpu_torch.parallel.plan import ParallelPlan

    return ParallelPlan.create(num_data, num_model, device="cpu", **kw)


def lookup_case_results(num_data: int, num_model: int, names=None) -> dict:
    """The LOOKUP_CASES exchanges (``names``, default all) on this rank: its
    output slice and its table shard's gradient (summed over 'data'), keyed
    by case name."""
    import torch

    from rectpu_torch.parallel.collectives import raw_psum

    table, ids, ct, (ct_emb, ct_lin), table_bf16 = lookup_inputs()
    k = LOOKUP_K
    res = {}
    for name, mode, flat, has_lin, impl, cc, cap, bf16 in LOOKUP_CASES:
        if names is not None and name not in names:
            continue
        plan = _plan(num_data, num_model, table_rows=LOOKUP_V, ep_mode=mode,
                     ep_comm_compress=cc, ep_peer_capacity=cap, scatter_impl=impl)
        n, pos = plan.batch_shards, plan.batch_index
        lo, hi = pos * (LOOKUP_B // n), (pos + 1) * (LOOKUP_B // n)
        full = table_bf16 if bf16 else table
        if flat and not has_lin:
            full = full[:, :k]
        shard = torch.tensor(plan.shard_params({"t": full})["t"], requires_grad=True)
        ids_local = torch.from_numpy(ids[lo:hi])
        if flat:
            emb, lin = plan.lookup_fn.flat_variant(shard, ids_local, has_lin=has_lin)
            loss = (emb * torch.from_numpy(ct_emb[lo:hi])).sum()
            if has_lin:
                loss = loss + (lin * torch.from_numpy(ct_lin[lo:hi])).sum()
            out = {"emb": emb.detach().numpy()}
            if has_lin:
                out["lin"] = lin.detach().numpy()
            else:
                assert lin is None
        else:
            looked = plan.lookup_fn(shard, ids_local)
            loss = (looked * torch.from_numpy(ct[lo:hi, :, :looked.shape[-1]])).sum()
            out = {"out": looked.detach().numpy()}
        loss.backward()
        out["grad"] = raw_psum(shard.grad, plan.mesh.data).numpy()
        res[name] = out
    return res


def collectives_results() -> dict:
    """Each autograd collective's forward and backward over the world axis
    of a 1 x world mesh, on rank-dependent inputs."""
    import torch
    import torch.distributed as dist

    from rectpu_torch.parallel import collectives as c
    from rectpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, dist.get_world_size())
    axis, r = mesh.model, mesh.rank
    res = {}
    for name, fn in (("all_gather", c.all_gather), ("psum_scatter", c.psum_scatter),
                     ("all_to_all", c.all_to_all), ("psum", c.psum)):
        x = (torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) + 100 * r).requires_grad_()
        y = fn(x, axis)
        g = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) * (r + 1)
        y.backward(g)
        res[name] = {"y": y.detach().numpy(), "dx": x.grad.numpy()}
    try:
        make_mesh(1, 1)
    except ValueError as e:
        res["mesh_mismatch"] = str(e)
    return res


# -- model steps ----------------------------------------------------------------

STEP_B = 32
STEP_STEPS = 3


def step_configs():
    """{name: (family, TowerConfig kwargs, model kwargs)}: every family's
    forward forms under EP (the fused table of an unpacked linear weight,
    the flat exchanges, the plain [V, K] table)."""
    flat = {"flat_layout": True, "packed_linear": True}
    return {
        "deepfm": ("deep_fm", {}, {}),
        "deepfm_hash": ("deep_fm", {"dropout": 0.5, "dropout_impl": "hash"}, {}),
        "deepfm_flat": ("deep_fm", {**flat, "scatter_impl": "mxu"}, {}),
        "dlrm": ("dlrm", {}, {}),
        "dlrm_flat": ("dlrm", {"flat_layout": True}, {}),
        "xdeep_fm": ("xdeep_fm", {}, {"cin_units": (8, 8)}),
        "xdeep_fm_flat": ("xdeep_fm", flat, {"cin_units": (8, 8)}),
        "wide_deep": ("linear_deep", {}, {}),
        "dnn": ("deep", {}, {}),
        "dcn": ("dcn", {}, {"num_cross_layers": 2}),
        "autoint": ("autoint", {}, {}),
        "autoint_flat": ("autoint", flat, {}),
    }


def step_inputs(steps: int = STEP_STEPS, seed: int = 5, numeric: int = 0):
    """[steps] global batches {cat_ids, num_vals, labels} of the ml-100k schema;
    ``numeric`` columns of num_vals drawn from their own stream (so the ids
    and labels do not depend on it)."""
    from rectpu_torch.features.schema import ml_100k_feature_set

    fs = ml_100k_feature_set()
    rng = np.random.default_rng(seed)
    num_rng = np.random.default_rng(seed + 100)
    out = []
    for _ in range(steps):
        ids = np.stack([fs.offsets[f] + rng.integers(0, fs.field_sizes[f], size=STEP_B)
                        for f in range(fs.num_fields)], 1).astype(np.int32)
        out.append({"cat_ids": ids,
                    "num_vals": num_rng.normal(size=(STEP_B, numeric)).astype(np.float32),
                    "labels": rng.integers(0, 2, size=STEP_B).astype(np.float32)})
    return out


def build_model(family: str, cfg_kw: dict, model_kw=None, numeric=()):
    """The family at the test widths (K=4, [16, 16]) on the ml-100k schema with
    ``numeric`` columns, and its init from a seeded generator."""
    import torch

    from rectpu_torch.features.schema import ml_100k_feature_set
    from rectpu_torch.models import (AutoIntModel, DCNModel, DeepFMModel, DLRMModel, DNNModel,
                                     TowerConfig, WideDeepModel, XDeepFMModel)

    families = {"deep_fm": DeepFMModel, "dlrm": DLRMModel, "xdeep_fm": XDeepFMModel,
                "linear_deep": WideDeepModel, "deep": DNNModel, "dcn": DCNModel,
                "autoint": AutoIntModel}
    cfg = TowerConfig(feature_set=ml_100k_feature_set(numeric), embedding_size=4,
                      hidden_units=(16, 16), table_padding=128, **cfg_kw)
    model = families[family](cfg, **(model_kw or {}))
    return model, model.init(torch.Generator().manual_seed(3))


def _global_params(model, plan):
    from rectpu_torch.convert import flatten_tree, params_tree

    tree = params_tree(model)
    if plan is not None:
        tree = plan.gather_params(tree)
    return {k: v.float().numpy() for k, v in flatten_tree(tree).items()}


def _run_dense(model, params, batches, plan, dropout_seed=11, bf16_slots=False):
    """STEP_STEPS Adam steps through the Trainer's step -> (losses, params);
    ``bf16_slots``: m in bf16 and v stochastically rounded to bf16."""
    import tempfile

    import torch

    from rectpu_torch.convert import flat_params, load_params
    from rectpu_torch.train.loop import TrainConfig, Trainer
    from rectpu_torch.train.optimizers import BF16_SR, adam

    cfg = TrainConfig(batch_size=STEP_B, seed=dropout_seed)
    opt = adam(0.01, slot_dtype={"m": torch.bfloat16, "v": BF16_SR} if bf16_slots else None)
    trainer = Trainer(model, opt, None, None, tempfile.mkdtemp(), cfg, plan=plan)
    load_params(model, plan.shard_params(params) if plan is not None else params)
    trainer.opt_state = trainer.optimizer.init(flat_params(model))
    n, pos = (plan.batch_shards, plan.batch_index) if plan is not None else (1, 0)
    losses = []
    for i, b in enumerate(batches):
        local = {k: torch.from_numpy(v[pos * (STEP_B // n):(pos + 1) * (STEP_B // n)])
                 for k, v in b.items()}
        loss = trainer.train_step(local, i)
        losses.append(float(plan.global_value(loss)) if plan is not None else float(loss))
    return np.asarray(losses), _global_params(model, plan)


def step_results(num_data: int, num_model: int, modes=("1d", "2d", "dedup")) -> dict:
    """For every step config: the single-process steps (run here on the whole
    batch) and the sharded steps under each EP mode."""
    res = {}
    batches = step_inputs()
    for name, (family, cfg_kw, model_kw) in step_configs().items():
        model, params = build_model(family, cfg_kw, model_kw)
        single = _run_dense(model, params, batches, None)
        res[name] = {"single_losses": single[0], "single": single[1]}
        for mode in modes:
            model, params = build_model(family, cfg_kw, model_kw)
            plan = _plan(num_data, num_model, table_rows=model.cfg.padded_buckets,
                         ep_mode=mode, scatter_impl=model.cfg.scatter_impl)
            losses, got = _run_dense(model, params, batches, plan)
            res[name][mode + "_losses"] = losses
            res[name][mode] = got
    return res


def dense_case_results(num_data: int, num_model: int, cases, single: bool = False) -> dict:
    """Each (name, family, TowerConfig kwargs, model kwargs, bf16 slots, ep_mode)
    of ``cases``: the sharded Trainer steps on this mesh (losses and global
    params), and with ``single`` the single-process steps of the whole batch
    beside them."""
    batches = step_inputs()
    res = {}
    for name, family, cfg_kw, model_kw, bf16_slots, mode in cases:
        model, params = build_model(family, cfg_kw, model_kw)
        plan = _plan(num_data, num_model, table_rows=model.cfg.padded_buckets, ep_mode=mode,
                     scatter_impl=model.cfg.scatter_impl)
        losses, got = _run_dense(model, params, batches, plan, bf16_slots=bf16_slots)
        res[name] = {"losses": losses, "params": got}
        if single:
            model, params = build_model(family, cfg_kw, model_kw)
            losses, got = _run_dense(model, params, batches, None, bf16_slots=bf16_slots)
            res[name].update(single_losses=losses, single=got)
    return res


# -- tensor-parallel towers ---------------------------------------------------------------

# (name, family, TowerConfig kwargs, model kwargs, ep_mode, numeric columns, fast step)
TP_HASH = {"dropout": 0.1, "dropout_impl": "hash"}
TP_FLAT = {"flat_layout": True, "packed_linear": True, "scatter_impl": "xla"}
TP_CASES = {c[0]: c for c in (
    ("deepfm_1d", "deep_fm", TP_HASH, {}, "1d", (), False),
    ("deepfm_2d", "deep_fm", {}, {}, "2d", (), False),
    ("deepfm_flat_1d", "deep_fm", TP_FLAT, {}, "1d", (), False),
    ("deepfm_flat_2d", "deep_fm", {**TP_FLAT, **TP_HASH}, {}, "2d", (), False),
    # bot (5, 8) over 2 numeric columns at M=2: row-parallel, replicated (5 is
    # odd), then a column-parallel last layer of K=4; top (16, 16)
    ("dlrm_2d", "dlrm", {}, {"interaction_impl": "xla", "bot_hidden_units": (5, 8)}, "2d",
     ("age", "action"), False),
    ("dcn_2d", "dcn", {}, {"num_cross_layers": 2}, "2d", (), False),
    ("deepfm_fast_dedup", "deep_fm", {"packed_linear": True}, {}, "dedup", (), True),
    ("deepfm_2d_bf16", "deep_fm", {"compute_dtype": "bfloat16"}, {}, "2d", (), False),
)}


def tp_case_results(num_data: int, num_model: int, names, seeds=None) -> dict:
    """The TP_CASES ``names`` on this mesh under ``tp_mlp``: STEP_STEPS Adam
    steps at lr 0.01 through the Trainer's step (the fast step's own
    ``make_sparse_step`` for a fast case) -> losses and the gathered global
    params; ``seeds`` (each step's dropout seed32) replaces
    ``step_seed32``."""
    import torch

    import rectpu_torch.train.loop as loop_mod
    from rectpu_torch.convert import flat_params, load_params
    from rectpu_torch.train.fast_step import make_sparse_step

    if seeds is not None:
        loop_mod.step_seed32 = lambda seed, step: int(seeds[step])
    res = {}
    for name in names:
        _, family, cfg_kw, model_kw, mode, numeric, fast = TP_CASES[name]
        batches = step_inputs(numeric=len(numeric))
        model, params = build_model(family, cfg_kw, model_kw, numeric)
        plan = _plan(num_data, num_model, table_rows=model.cfg.padded_buckets, ep_mode=mode,
                     scatter_impl=model.cfg.scatter_impl, tp_mlp=True)
        if not fast:
            losses, got = _run_dense(model, params, batches, plan)
        else:
            init, step = make_sparse_step(model, learning_rate=0.01, plan=plan)
            model.lookup_fn, model.tp_plan = plan.lookup_fn, plan
            load_params(model, plan.shard_params(params))
            opt = init(flat_params(model))
            n, pos = plan.batch_shards, plan.batch_index
            losses = []
            for b in batches:
                local = {k: torch.from_numpy(v[pos * (STEP_B // n):(pos + 1) * (STEP_B // n)])
                         for k, v in b.items()}
                losses.append(float(plan.global_value(step(flat_params(model), opt, local,
                                                           None))))
            losses, got = np.asarray(losses), _global_params(model, plan)
        res[name] = {"losses": losses, "params": got}
    return res


def tp_roundtrip_results(meshes, trees) -> dict:
    """On each (num_data, num_model) of ``meshes`` with ``tp_mlp``: each
    (family, model kwargs, numeric) of ``trees``, its init params and an Adam
    state of seeded values, cut by ``shard_params`` and all_gathered back by
    ``gather_params`` -> whether the gather gave the tree back bit for bit,
    and the rank's shard shapes by key path."""
    import torch

    from rectpu_torch.convert import flat_params, flatten_tree, load_params, opt_state_tree
    from rectpu_torch.train.optimizers import adam

    res = {}
    for mesh in meshes:
        for family, model_kw, numeric in trees:
            model, params = build_model(family, {}, model_kw, numeric)
            plan = _plan(*mesh, table_rows=model.cfg.padded_buckets, tp_mlp=True)
            state = opt_state_tree(adam(0.01).init(flat_params(load_params(model, params))))
            gen = torch.Generator().manual_seed(1)

            def seeded(node):
                if isinstance(node, dict):
                    return {k: seeded(v) for k, v in node.items()}
                if isinstance(node, list):
                    return [seeded(v) for v in node]
                return torch.randn(node.shape, generator=gen) if node.is_floating_point() else node

            state = seeded(state)
            whole = {"params": params, "opt_state": state}
            cut = plan.shard_params(whole)
            back = flatten_tree(plan.gather_params(cut))
            res[(mesh, family)] = {
                "equal": sorted(back) == sorted(flatten_tree(whole)) and all(
                    torch.equal(back[k], v) for k, v in flatten_tree(whole).items()),
                "shapes": {k: tuple(v.shape) for k, v in flatten_tree(cut).items()}}
    return res


SPARSE_V, SPARSE_W, SPARSE_B, SPARSE_F = 64, 5, 16, 6
# (name, ep_mode, peer_capacity): the lossless default and a starved capacity
SPARSE_ROWS_CASES = (("1d", "1d", None), ("2d", "2d", None), ("dedup", "dedup", None),
                     ("dedup_starved", "dedup", 2))


def sparse_rows_inputs(seed: int = 9):
    """(table [V, W], packed m|v [V, 2W] with v > 0, ids [B, F] with repeats
    and collisions across ranks, cotangent rows [B, F, W], lr_t)."""
    rng = np.random.default_rng(seed)
    v, w = SPARSE_V, SPARSE_W
    table = rng.normal(size=(v, w)).astype(np.float32)
    mv = np.concatenate([rng.normal(scale=0.1, size=(v, w)),
                         rng.uniform(0.01, 0.1, size=(v, w))], axis=1).astype(np.float32)
    ids = rng.integers(0, v // 2, size=(SPARSE_B, SPARSE_F)).astype(np.int32) * 2
    dl = rng.normal(size=(SPARSE_B, SPARSE_F, w)).astype(np.float32)
    return table, mv, ids, dl, 0.01


def sparse_rows_results(num_data: int, num_model: int) -> dict:
    """``parallel/sparse_ep.make_sparse_rows_ep`` on this rank for each of
    SPARSE_ROWS_CASES: the rank's table and m|v shards after one update."""
    import torch

    from rectpu_torch.parallel.sparse_ep import make_sparse_rows_ep

    table, mv, ids, dl, lr_t = sparse_rows_inputs()
    res = {}
    for name, mode, cap in SPARSE_ROWS_CASES:
        plan = _plan(num_data, num_model, table_rows=SPARSE_V, ep_mode=mode)
        n, pos = plan.batch_shards, plan.batch_index
        rows = slice(pos * (SPARSE_B // n), (pos + 1) * (SPARSE_B // n))
        update = make_sparse_rows_ep(plan.mesh, batch_2d=mode != "1d", peer_capacity=cap)
        shards = plan.shard_params({"table": table, "mv": mv})
        t, m = update(torch.tensor(shards["table"]), torch.tensor(shards["mv"]),
                      torch.from_numpy(ids[rows]), torch.from_numpy(dl[rows]), lr_t)
        res[name] = {"table": t.numpy(), "mv": m.numpy()}
    return res


def sparse_step_results(num_data: int, num_model: int, modes=("1d", "2d", "dedup")) -> dict:
    """The sparse fast step (DeepFM, packed table): single vs sharded, 3 steps."""
    import torch

    from rectpu_torch.convert import flat_params, load_params
    from rectpu_torch.train.fast_step import make_sparse_step

    batches = step_inputs()
    res = {}
    for mode in (None, *modes):
        model, params = build_model("deep_fm", {"packed_linear": True})
        plan = None if mode is None else _plan(num_data, num_model,
                                               table_rows=model.cfg.padded_buckets,
                                               ep_mode=mode)
        init, step = make_sparse_step(model, learning_rate=0.01, plan=plan)
        if plan is not None:
            model.lookup_fn = plan.lookup_fn
            params = plan.shard_params(params)
        load_params(model, params)
        state = init(flat_params(model))
        n, pos = (plan.batch_shards, plan.batch_index) if plan is not None else (1, 0)
        losses = []
        for b in batches:
            local = {k: torch.from_numpy(v[pos * (STEP_B // n):(pos + 1) * (STEP_B // n)])
                     for k, v in b.items()}
            loss = step(flat_params(model), state, local, None)
            losses.append(float(plan.global_value(loss)) if plan is not None else float(loss))
        mv = state["mv_sparse"]["table"]
        if plan is not None:
            mv = plan.gather_params({"mv": mv})["mv"]
        res[str(mode)] = {"losses": np.asarray(losses), "params": _global_params(model, plan),
                          "mv": mv.numpy()}
    return res


METRIC_B = 24  # rows of the metric state each rank accumulates


def metric_inputs(world: int, seed: int = 13):
    """Per rank: (probs, labels, losses, weights) of its METRIC_B rows."""
    rng = np.random.default_rng(seed)
    n = world * METRIC_B
    arrays = (rng.random(n).astype(np.float32), (rng.random(n) < 0.4).astype(np.float32),
              rng.random(n).astype(np.float32), (rng.random(n) < 0.9).astype(np.float32))
    return [tuple(a[r * METRIC_B:(r + 1) * METRIC_B] for a in arrays) for r in range(world)]


DISPATCH_PLANS = {"data2": (2, 1, False), "ep2_dedup_fast": (1, 2, True)}


def dispatch_results(tmp: str) -> dict:
    """``metrics.psum_state`` of this rank's metric rows over a 2x1 plan;
    then, for each plan of ``DISPATCH_PLANS``, the Trainer's 10 steps
    (loops of 4, 4, 2; hash dropout) under dispatch "scan" (eager on the
    CPU) and "pipelined" -> losses and gathered params per mode."""
    import torch

    from rectpu_torch.data.synthetic import write_synthetic_dataset
    from rectpu_torch.features.schema import ml_100k_feature_set
    from rectpu_torch.io.loader import CsvDataset
    from rectpu_torch.models import DeepFMModel, TowerConfig
    from rectpu_torch.train import metrics as metrics_lib
    from rectpu_torch.train.fast_step import make_sparse_step
    from rectpu_torch.train.loop import TrainConfig, Trainer

    plan = _plan(2, 1)
    probs, labels, losses, weights = (torch.from_numpy(a) for a in
                                      metric_inputs(2)[plan.mesh.rank])
    state = metrics_lib.update_state(metrics_lib.init_state(), probs, labels, losses, weights)
    res = {"psum": {k: v.numpy() for k, v in metrics_lib.psum_state(state, plan).items()}}
    rank = plan.mesh.rank
    data = write_synthetic_dataset(Path(tmp) / f"data_{rank}", train_rows=600, test_rows=64,
                                   seed=4)
    fs = ml_100k_feature_set()
    train_ds, eval_ds = CsvDataset(data["train"], fs), CsvDataset(data["test"], fs)
    for name, (d, m, fast) in DISPATCH_PLANS.items():
        for mode in ("scan", "pipelined"):
            cfg = TowerConfig(feature_set=fs, embedding_size=4, hidden_units=(16, 16),
                              dropout=0.1, dropout_impl="hash", packed_linear=fast)
            model = DeepFMModel(cfg)
            plan = _plan(d, m, table_rows=cfg.padded_buckets, ep_mode="dedup")
            step = make_sparse_step(model, learning_rate=1e-3, plan=plan) if fast else None
            trainer = Trainer(model, model.default_optimizer(), train_ds, eval_ds,
                              Path(tmp) / f"job_{name}_{mode}", plan=plan, fast_step=step,
                              config=TrainConfig(batch_size=32, train_steps=10,
                                                 steps_per_loop=4, dispatch_mode=mode,
                                                 save_checkpoints_steps=10**6, seed=5,
                                                 final_eval=False))
            trainer.train_and_evaluate(restore=False)
            res[f"{name}_{mode}"] = {"losses": np.asarray(trainer.step_losses),
                                     "params": _global_params(model, plan)}
    return res


# -- the collectives a step issues (the sequence a piecewise capture replays) ----------

# name: (ep_mode, tp_mlp, the sparse fast step)
RECORD_CASES = {"1d": ("1d", False, False), "2d": ("2d", False, False),
                "dedup": ("dedup", False, False), "fast_dedup": ("dedup", False, True),
                "tp_2d": ("2d", True, False), "tp_1d": ("1d", True, False)}


def _trainer_steps(num_data, num_model, mode, tp, fast, record):
    """STEP_STEPS steps of DeepFM (hash dropout 0.1, Adam 0.01; the packed
    fast step under ``fast``) through ``Trainer.train_step`` on this mesh;
    with ``record`` each step under a ``dispatch.CollectiveLog`` -> (each
    step's collectives, or None, the losses, the gathered params)."""
    import tempfile

    import torch

    from rectpu_torch.convert import flat_params, load_params
    from rectpu_torch.train.dispatch import CollectiveLog
    from rectpu_torch.train.fast_step import make_sparse_step
    from rectpu_torch.train.loop import TrainConfig, Trainer
    from rectpu_torch.train.optimizers import adam

    model, params = build_model("deep_fm", {"dropout": 0.1, "dropout_impl": "hash",
                                            "packed_linear": fast})
    plan = _plan(num_data, num_model, table_rows=model.cfg.padded_buckets, ep_mode=mode,
                 tp_mlp=tp)
    step = make_sparse_step(model, learning_rate=0.01, plan=plan) if fast else None
    trainer = Trainer(model, adam(0.01), None, None, tempfile.mkdtemp(),
                      TrainConfig(batch_size=STEP_B, seed=11), plan=plan, fast_step=step)
    load_params(model, plan.shard_params(params))
    trainer.opt_state = (step[0] if fast else trainer.optimizer.init)(flat_params(model))
    n, pos = plan.batch_shards, plan.batch_index
    calls, losses = [], []
    for i, b in enumerate(step_inputs()):
        local = {k: torch.from_numpy(v[pos * (STEP_B // n):(pos + 1) * (STEP_B // n)])
                 for k, v in b.items()}
        if record:
            with CollectiveLog() as log:
                loss = trainer.train_step(local, i)
            calls.append(log.calls)
        else:
            loss = trainer.train_step(local, i)
        losses.append(float(plan.global_value(loss)))
    return (calls if record else None), np.asarray(losses), _global_params(model, plan)


def collective_record_results(num_data: int, num_model: int) -> dict:
    """Each RECORD_CASES step on this mesh recorded (the collectives of each
    step) and run again without the log (losses and params of both)."""
    res = {}
    for name, (mode, tp, fast) in RECORD_CASES.items():
        calls, losses, params = _trainer_steps(num_data, num_model, mode, tp, fast, True)
        _, plain_losses, plain_params = _trainer_steps(num_data, num_model, mode, tp, fast,
                                                       False)
        res[name] = {"calls": calls, "losses": losses, "params": params,
                     "plain_losses": plain_losses, "plain_params": plain_params}
    return res


def raw_collective_results() -> dict:
    """Each ``raw_*`` collective over the world axis of a 1 x world mesh, on
    rank-dependent inputs of several dtypes and layouts (a transposed view
    among them), beside the ``torch.distributed`` call it stands for and
    beside itself under a ``CollectiveLog``; the input after the call."""
    import torch
    import torch.distributed as dist

    from rectpu_torch.parallel import collectives as c
    from rectpu_torch.parallel.mesh import make_mesh
    from rectpu_torch.train.dispatch import CollectiveLog

    mesh = make_mesh(1, dist.get_world_size())
    axis, r, world = mesh.model, mesh.rank, mesh.model.size
    base = torch.arange(4 * world * 6, dtype=torch.float32).reshape(4 * world, 6) * 0.37 + r
    inputs = {"f32": base, "bf16": base.to(torch.bfloat16), "i32": (base * 3).to(torch.int32),
              "f32_3d": base.reshape(4 * world, 2, 3), "f32_t": base.reshape(6, 4 * world).t()}

    def direct(op, x):
        x = x.contiguous()
        if op == "all_gather":
            out = x.new_empty((world * x.shape[0], *x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=axis.group)
        elif op == "psum_scatter":
            out = x.new_empty((x.shape[0] // world, *x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=axis.group)
        elif op == "all_to_all":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=axis.group)
        else:
            out = x.clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
        return out

    res = {}
    for op in c.OPS:
        fn = getattr(c, f"raw_{op}")
        for tag, x in inputs.items():
            before = x.clone()
            got = fn(x, axis)
            with CollectiveLog() as log:
                logged = fn(x, axis)
            res[(op, tag)] = {"got": got.float().numpy(), "want": direct(op, x).float().numpy(),
                              "logged": logged.float().numpy(), "calls": log.calls,
                              "dtype": str(got.dtype), "input_kept": bool(torch.equal(x, before))}
    return res


CASES = {
    "record": collective_record_results,
    "raw_collectives": raw_collective_results,
    "dispatch": dispatch_results,
    "lookups": lookup_case_results,
    "collectives": collectives_results,
    "steps": step_results,
    "dense_cases": dense_case_results,
    "sparse_rows": sparse_rows_results,
    "sparse_steps": sparse_step_results,
    "tp_cases": tp_case_results,
    "tp_roundtrip": tp_roundtrip_results,
}


# -- the trainer CLI under torchrun ------------------------------------------------------


def cli_command(nproc: int, *flags) -> list:
    """The DeepFM CLI on the CPU: in one process, or under
    ``torch.distributed.run --standalone`` with ``nproc`` ranks."""
    import sys

    module = ["-m", "rectpu_torch.trainers.deep_fm", "--device", "cpu", *map(str, flags)]
    if nproc == 1:
        return [sys.executable, *module]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", *module]


def cli_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return env


def run_cli(nproc: int, *flags, timeout: float = 300.0):
    """Run the CLI to its end -> (final eval metrics, {param key: array} of
    the job dir's newest checkpoint)."""
    import ast
    import subprocess

    proc = subprocess.run(cli_command(nproc, *flags), capture_output=True, text=True,
                          timeout=timeout, env=cli_env())
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"CLI with {nproc} rank(s) failed:\n{log[-4000:]}")
    done = [line for line in log.splitlines() if "rectpu_torch.trainers :: done: " in line]
    metrics = ast.literal_eval(done[0].split("done: ", 1)[1])
    job_dir = Path(flags[list(flags).index("--job-dir") + 1])
    return metrics, checkpoint_params(job_dir)


def checkpoint_params(job_dir) -> dict:
    from rectpu_torch.train.checkpoint import Checkpointer, _load_flat_npz

    step = Checkpointer(job_dir).latest_step()
    flat = _load_flat_npz(Path(job_dir) / f"ckpt-{step}" / "arrays.npz")
    return {k: v.float().numpy() for k, v in flat.items() if k.startswith("params/")}


def param_digest(params: dict) -> float:
    """rectpu's ``tests/mp_worker.py`` digest: the sum of |x| over the params."""
    return float(sum(np.abs(v.astype(np.float64)).sum() for v in params.values()))
