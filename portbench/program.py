"""The system under test: ``rectpu_torch``'s Trainer, built as the family's
trainer CLI builds it.

The configuration's ``flags`` go through the family's own parser
(``rectpu_torch.trainers.<family>.build_parser``) with the traffic's batch,
the run's seed and the device; ``build_model``, ``resolve_optimizer`` and
``resolve_fast_step`` are the CLI's (``--fast-step auto``); the TrainConfig
has the CLI's values (``dispatch_mode`` "auto"). Two things differ from the
CLI, because the CLI reads the ml-100k CSVs: the feature set is the
configuration's Criteo schema (26 identity fields of its row counts and its
dense fields), and the train set is the benchmark's, given to the Trainer
as ``CsvDataset.from_arrays``; it fits ``data_placement_max_bytes``, so the
Trainer keeps it on the device. The start values are the benchmark's too
(``weights``), loaded with the program's ``convert.load_params``; the
optimizer state is made as ``Trainer._train_and_evaluate`` makes it.

The window drives ``Trainer.loop_runner``'s function one loop at a time,
as ``_train_and_evaluate`` does.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from portbench import weights


@dataclass
class Program:
    trainer: object
    model: object
    args: object
    run: object  # the loop runner: run(batches, step, k) -> (losses [k], DataState)
    batches: object  # the Trainer's batch stream
    specs: dict
    plan: object = None  # the ParallelPlan of a run over several cards
    shard: dict = None  # {table leaf: (first row, end row)} this rank holds, when sharded

    def key(self, leaf: str) -> str:
        """A reading's name: a table shard's carries its rank."""
        return f"{leaf}@{self.plan.process_index}" if self.shard and leaf in self.shard else leaf


def feature_set(conf: dict):
    from rectpu_torch.features.schema import FeatureSet, IdentityFeature, NumericFeature

    return FeatureSet(
        categorical=tuple(IdentityFeature(f"C{i + 1}", int(r))
                          for i, r in enumerate(conf["sparse_rows"])),
        numeric=tuple(NumericFeature(f"I{i + 1}") for i in range(conf["dense_features"])))


def parse_flags(conf: dict, batch_size: int, seed: int, device: str, job_dir: str):
    from rectpu_torch.trainers.common import apply_preset

    cli = importlib.import_module(f"rectpu_torch.trainers.{conf['family']}")
    argv = list(conf["flags"]) + ["--batch-size", str(batch_size), "--seed", str(seed),
                                  "--device", device, "--job-dir", job_dir]
    return cli, apply_preset(cli.build_parser().parse_args(argv))


def check_flags(conf: dict, args) -> None:
    """The flags the program is built from state the widths the reference
    is built from."""
    for key in ("embedding_size", "hidden_units", "bot_hidden_units", "cin_units"):
        if key in conf and getattr(args, key) != conf[key]:
            raise ValueError(f"{conf['name']}: flag {key}={getattr(args, key)} but the "
                             f"configuration states {conf[key]}")


def build(conf: dict, traffic: dict, ref, data: dict, seed: int, device: str,
          job_dir: str) -> Program:
    from rectpu_torch.convert import flat_params, load_params
    from rectpu_torch.device import resolve_device
    from rectpu_torch.io.loader import CsvDataset
    from rectpu_torch.train.loop import TrainConfig, Trainer
    from rectpu_torch.train.optimizers import get_optimizer
    from rectpu_torch.trainers.common import resolve_fast_step, resolve_optimizer

    cli, args = parse_flags(conf, int(traffic["batch_size"]), seed, device, job_dir)
    check_flags(conf, args)
    fs = feature_set(conf)
    model = cli.build_model(args)
    model.cfg.feature_set = fs  # the Criteo schema in place of the CLI's ml-100k one
    optimizer = resolve_optimizer(args, model, get_optimizer(args.optimizer,
                                                             args.learning_rate))
    dev = resolve_device(args.device)
    plan = None
    if dist.is_initialized():  # a run over several cards: the CLI's plan
        from rectpu_torch.parallel.plan import ParallelPlan

        plan = ParallelPlan.create(
            args.num_data_shards, args.num_model_shards, device=dev.type,
            table_rows=model.cfg.padded_buckets, ep_mode=args.ep_mode,
            ep_comm_compress=args.ep_comm_compress, tp_mlp=args.tp_mlp,
            scatter_impl=args.scatter_impl)
        if args.tp_mlp or args.ep_peer_capacity is not None:
            raise NotImplementedError("tensor-parallel towers and a dedup capacity")
    fast_step = resolve_fast_step(args, model, optimizer, plan)
    host = {k: v.cpu().numpy() for k, v in data.items()}
    train_ds = CsvDataset.from_arrays(host["cat_ids"], host["labels"], host["num_vals"],
                                      feature_set=fs)
    config = TrainConfig(
        batch_size=args.batch_size, train_steps=args.train_steps,
        eval_batch_size=args.eval_batch_size, save_checkpoints_secs=args.save_checkpoints_secs,
        save_checkpoints_steps=args.save_checkpoints_steps, steps_per_loop=args.steps_per_loop,
        seed=args.seed, loss_reduction=args.loss_reduction, eval_auc=args.eval_auc,
        data_placement=args.data_placement)
    trainer = Trainer(model, optimizer, train_ds, None, job_dir, config, exporter=None,
                      device=dev, fast_step=fast_step, plan=plan)
    dev = trainer.device
    specs = ref.param_specs(conf, model.cfg.padded_buckets)
    shard = {}
    if plan is not None:  # the rows of the leaves plan.shard_params cuts, by its rule
        n = model.cfg.padded_buckets // plan.mesh.num_model
        i = plan.mesh.model.index
        shard = {k: (i * n, (i + 1) * n) for k, (shape, _) in specs.items()
                 if plan.is_table_leaf(torch.empty(shape, device="meta"))}
    load_params(model, weights.nest(weights.make_flat(specs, seed, dev, shard)), dev)
    got = {k: tuple(p.shape) for k, p in flat_params(model).items()}
    want = {k: ((shard[k][1] - shard[k][0],) + tuple(s[0][1:]) if k in shard else tuple(s[0]))
            for k, s in specs.items()}
    if got != want:
        raise ValueError(f"the reference's leaves {want} are not the model's {got}")
    if fast_step is not None:
        raise NotImplementedError("the check reads the dense optimizer's state; a cell on "
                                  "the sparse fast step needs its own reading")
    trainer.opt_state = optimizer.init(flat_params(model))
    if getattr(optimizer, "prepare", None) is not None:
        raise NotImplementedError("a stored-parameter optimizer (bf16_param_store)")
    model.train()
    resident = trainer._resident()
    batches = trainer._host_batches(None, resident)
    return Program(trainer, model, args, trainer.loop_runner(resident), batches, specs, plan,
                   shard)


def optimizer_spec(prog: Program) -> dict:
    """The optimizer's hyperparameters as the reference's update takes them."""
    opt = prog.trainer.optimizer
    spec = {"name": opt.name, "learning_rate": prog.args.learning_rate}
    if opt.name == "Adam":
        spec.update(beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon)
    return spec


@torch.no_grad()
def first_grad_norms(prog: Program) -> dict:
    """Each leaf's first gradient as the optimizer got it, read after one
    step: Adam's from its state (m / (1 - beta1)); SGD, which keeps no
    state, from the gradient the step left on the parameter (under a plan
    summed over the ranks in place). A table shard's reading is its own."""
    from rectpu_torch.convert import flat_params

    opt = prog.trainer.optimizer
    if opt.name == "Adam":
        return {prog.key(k): float(m.double().norm()) / (1 - opt.beta1)
                for k, m in prog.trainer.opt_state["m"].items()}
    if opt.name == "SGD":
        return {prog.key(k): 0.0 if p.grad is None else float(p.grad.double().norm())
                for k, p in flat_params(prog.model).items()}
    raise NotImplementedError(f"no first-gradient reading for {opt.name}")


@torch.no_grad()
def change_norms(prog: Program, seed: int) -> dict:
    """||p - p0|| of each leaf (a table shard: of its rows), p0 made again
    block by block from the seed."""
    from rectpu_torch.convert import flat_params

    out = {}
    for key, p in flat_params(prog.model).items():
        spec = prog.specs[key]
        if not spec[0]:
            out[key] = float((p.float() - weights.leaf_block(spec, key, seed, 0, p.device))
                             .double().norm())
            continue
        lo, hi = (prog.shard or {}).get(key, (0, spec[0][0]))
        sq = torch.zeros((), dtype=torch.float64, device=p.device)
        for b in range(lo // weights.BLOCK, -(-hi // weights.BLOCK)):
            a, z = max(lo, b * weights.BLOCK), min(hi, (b + 1) * weights.BLOCK)
            p0 = weights.leaf_block(spec, key, seed, b, p.device)[a - b * weights.BLOCK:
                                                                  z - b * weights.BLOCK]
            sq += (p[a - lo:z - lo].float() - p0).double().square().sum()
        out[prog.key(key)] = float(sq.sqrt())
    return out
