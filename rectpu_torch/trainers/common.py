"""Shared CLI harness for the trainers: the port of ``rectpu/trainers/common.py``.

The same flags and defaults as rectpu's parser (``common.py:20-222``), so a
rectpu command line runs here unchanged, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels). The JAX
compilation cache flag is accepted and has nothing to configure.

Sharding (``--num-data-shards``, ``--num-model-shards`` and the EP flags)
runs one process per rank: launch the CLI under ``torchrun
--nproc-per-node N`` with N = data x model shards (a world of another size
raises). ``build_trainer`` starts the process group
(``parallel/mesh.distributed_init``) and builds the ``ParallelPlan`` as
rectpu's ``common.py:353-500`` does: the ``--packed-col-pad`` + flat guard,
``--ep-row-placement freq`` (saved to ``<job-dir>/row_perm.npy`` by rank 0,
with rectpu's restore guards), ``--ep-peer-capacity auto`` counted after the
remap, ``--fast-step`` over EP, and ``--tp-mlp`` (the tensor-parallel
towers; without a plan, a run of one process, it changes nothing, as in
rectpu). Rank 0 clears and writes the job dir.
``--streaming-io`` reads both CSVs through ``io.loader.StreamingCsvDataset``
and ``--exporter best`` exports only when ``--best-exporter-metric``
improves (``serve.export.make_exporter``), as rectpu's
(``common.py:388-392, 530-532``). ``run`` trains with the
model's ``default_optimizer`` when given none (the canned estimators':
FTRL, Adagrad, per-tower), and ``--table-store bfloat16`` wraps the
optimizer in ``bf16_param_store`` after rectpu's two checks
(``common.py:513-528``). ``--autotune`` times the port's kernels at the run's shapes
before the trainer is built and pins the winners (``ops/autotune.py``);
``--profile-dir`` traces the second logging window (``train/loop.py``). A
job dir that holds ``row_perm.npy`` (a stored row placement) has its train
and eval ids relabelled through it, and every export carries it, as in
rectpu (``common.py:453-459, 530-532``).
``--fast-step`` and ``--sparse-scatter`` build the sparse lazy-Adam step
(``train/fast_step.py``) as rectpu's ``_resolve_fast_step`` does.
"""

from __future__ import annotations

import os
import shutil
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from rectpu_torch.device import resolve_device
from rectpu_torch.utils.logging import get_logger

logger = get_logger("rectpu_torch.trainers")


def add_common_args(parser: ArgumentParser, job_dir_default: str) -> None:
    parser.add_argument("--train-csv", default="data/ml-100k/train.csv",
                        help="path to the training csv data (default: %(default)s)")
    parser.add_argument("--test-csv", default="data/ml-100k/test.csv",
                        help="path to the test csv data (default: %(default)s)")
    parser.add_argument("--job-dir", default=job_dir_default,
                        help="job directory (default: %(default)s)")
    parser.add_argument("--restore", action="store_true",
                        help="whether to restore from job_dir")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="batch size (default: %(default)s)")
    parser.add_argument("--train-steps", type=int, default=20000,
                        help="number of training steps (default: %(default)s)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default: the hand-written kernels on the card) or "
                             "'cpu' (their plain PyTorch versions)")
    parser.add_argument("--eval-batch-size", type=int, default=None,
                        help="eval batch size (default: max(batch, 512))")
    parser.add_argument("--save-checkpoints-secs", type=float, default=60.0,
                        help="wall-clock checkpoint+eval cadence (default: %(default)s)")
    parser.add_argument("--save-checkpoints-steps", type=int, default=None,
                        help="step-based checkpoint+eval cadence (overrides secs)")
    parser.add_argument("--steps-per-loop", type=int, default=100,
                        help="steps per host loop (default: %(default)s): the log line "
                             "and the losses' read-back come once per loop; below batch "
                             "2048 a loop's steps run from fixed device buffers, on the "
                             "card as replays of a CUDA graph of the step (rectpu's "
                             "dispatch_mode 'auto')")
    parser.add_argument("--seed", type=int, default=42, help="PRNG seed")
    parser.add_argument("--loss-reduction", default="mean", choices=["mean", "sum"],
                        help="per-batch loss reduction; 'sum' = TF-1.x head semantics")
    parser.add_argument("--embedding-impl", default="auto",
                        choices=["auto", "take", "onehot", "pallas", "split"],
                        help="rectpu's lookup choice; every value runs the port's one "
                             "lookup (default: %(default)s)")
    parser.add_argument("--fm-impl", default="auto", choices=["auto", "xla", "pallas"],
                        help="rectpu's FM choice; every value runs the port's one FM "
                             "(default: %(default)s)")
    parser.add_argument("--compute-dtype", default=None, choices=[None, "bfloat16"],
                        help="tower compute dtype (default: float32)")
    parser.add_argument("--table-grad-dtype", default=None, choices=[None, "bfloat16"],
                        help="dtype the dense embedding-table gradient is rounded to "
                             "(default: float32)")
    parser.add_argument("--table-dtype", default="float32", choices=["float32", "bfloat16"],
                        help="storage dtype of the embedding-table MASTER param (bfloat16: "
                             "fp32 Adam math + stochastically rounded downcast; Adam "
                             "only). default: %(default)s")
    parser.add_argument("--table-store", default="float32", choices=["float32", "bfloat16"],
                        help="storage dtype of the table the forward reads. bfloat16 keeps "
                             "the fp32 master in the optimizer state (fp32 training) and "
                             "stores a bf16 copy the gather reads. Requires "
                             "--compute-dtype bfloat16. default: %(default)s")
    parser.add_argument("--data-placement", choices=["auto", "host", "device"],
                        default="auto",
                        help="'device' keeps the encoded train set on the device and "
                             "ships only row indices per step; 'auto' = device when it "
                             "fits 1 GB. Training is the same either way")
    parser.add_argument("--streaming-io", action="store_true",
                        help="out-of-core input pipeline: windows of CSV chunks parsed on "
                             "demand, shuffled by chunk and within a window")
    parser.add_argument("--num-data-shards", type=int, default=1,
                        help="data-parallel mesh size; with --num-model-shards, run "
                             "under torchrun with data x model processes")
    parser.add_argument("--num-model-shards", type=int, default=1,
                        help="embedding (EP) mesh size: the table's rows are sharded "
                             "over this many ranks")
    parser.add_argument("--tp-mlp", action="store_true",
                        help="tensor-parallel dense towers: MLP kernels alternate "
                             "column and row sharding over the 'model' axis (Megatron "
                             "style); needs --num-model-shards > 1")
    parser.add_argument("--ep-mode", default="2d", choices=["1d", "2d", "dedup"],
                        help="EP exchange (used only with --num-model-shards > 1): 1d "
                             "masked gather + psum, 2d reduce_scatter, dedup unique-row "
                             "all_to_all")
    parser.add_argument("--ep-peer-capacity", default=None,
                        help="dedup EP exchange slots per peer: an int, or 'auto' (from "
                             "the training set's row frequencies); ids past it drop "
                             "(default: the lossless min(N, V/m))")
    parser.add_argument("--ep-row-placement", default="none", choices=["none", "freq"],
                        help="'freq' relabels each field's rows so the hot rows spread "
                             "over the table shards (saved to <job-dir>/row_perm.npy)")
    parser.add_argument("--ep-comm-compress", default=None, choices=["bf16", "int8"],
                        help="EP wire format: 'bf16' (any --ep-mode but 1d) or per-row "
                             "'int8' (--ep-mode dedup; cotangents ride bf16)")
    parser.add_argument("--warm-start-from", default=None,
                        help="initialize params from a previous run's export dir, job "
                             "dir, or ckpt-N directory (either package's)")
    parser.add_argument("--warm-start-vars", nargs="*", default=None,
                        help="tree-path prefixes to warm start (e.g. 'emb' 'linear'); "
                             "default: every matching leaf")
    parser.add_argument("--exporter", choices=["latest", "best"], default="latest",
                        help="'latest' exports after every eval; 'best' only when the "
                             "eval metric improves (tf.estimator BestExporter)")
    parser.add_argument("--best-exporter-metric", default="auc",
                        help="eval metric the 'best' exporter compares (average_loss "
                             "and loss: lower is better; others: higher)")
    parser.add_argument("--eval-auc", choices=["streaming", "exact"], default="streaming",
                        help="'streaming' = 200-threshold tf.metrics.auc parity; 'exact' = "
                             "rank-based AUC on the gathered eval probabilities")
    parser.add_argument("--autotune", action="store_true",
                        help="time the port's kernels and launch geometries at this run's "
                             "shapes and pin the fastest before training")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the second logging window "
                             "here")
    parser.add_argument("--compilation-cache-dir", default="/tmp/jax_cache",
                        help="rectpu's persistent XLA cache; the port compiles nothing "
                             "per shape and ignores it")


def add_deep_args(parser: ArgumentParser) -> None:
    parser.add_argument("--embedding-size", type=int, default=4,
                        help="embedding size (default: %(default)s)")
    parser.add_argument("--hidden-units", type=int, nargs="+", default=[16, 16],
                        help="hidden layer specification (default: %(default)s)")
    parser.add_argument("--dropout", type=float, default=0.1,
                        help="dropout rate (default: %(default)s)")
    parser.add_argument("--dropout-impl", choices=["threefry", "hash"], default="threefry",
                        help="dropout mask source: 'hash' = rectpu's counter-hash mask, "
                             "bit for bit; 'threefry' = a torch.Generator Bernoulli stream")
    parser.add_argument("--flat-layout", action="store_true",
                        help="rectpu's flat-layout numerics (fp32 FM logit); "
                             "incompatible with --numeric-columns")
    parser.add_argument("--scatter-impl", choices=["xla", "mxu", "auto"], default="xla",
                        help="rectpu's table-cotangent builder; the port always runs its "
                             "one scatter kernel. 'mxu'/'auto' set table_padding=2048 "
                             "as rectpu does")
    parser.add_argument("--preset", choices=["scaled"], default=None,
                        help="flag bundle. 'scaled' = bench.py's configuration: "
                             "--flat-layout, --scatter-impl mxu, --compute-dtype bfloat16, "
                             "--table-grad-dtype bfloat16, --dropout-impl hash, "
                             "--packed-linear, --optimizer-slot-dtype bfloat16-sr. Only "
                             "knobs still at their defaults are overridden")
    parser.add_argument("--fast-step", choices=["auto", "on", "off"], default="auto",
                        help="sparse lazy-Adam training step (train/fast_step): "
                             "gathers rows outside the differentiated function and "
                             "updates only the touched table rows — TF "
                             "_apply_sparse semantics. 'auto' = on when the table "
                             "exceeds ~850M elements PER SHARD (~13M rows at "
                             "K=64, rectpu's measured crossover with lane-aligned "
                             "state) and the run is Adam-compatible; 'on' forces it "
                             "(errors on incompatibility). Adam only; fp32 "
                             "table/slots")
    parser.add_argument("--sparse-scatter", choices=["auto", "xla", "dma"],
                        default="auto",
                        help="state scatter backend for the sparse fast step: "
                             "xla (.at[].set semantics) or dma (the row-set "
                             "kernel of ops/scatter_dma; bitwise-equal). On the "
                             "card both run the row-set kernel. auto = xla "
                             "(default: %(default)s)")


# --preset scaled: knob -> (parser default, preset value) (rectpu common.py:227-235)
_SCALED_PRESET = {
    "compute_dtype": (None, "bfloat16"),
    "table_grad_dtype": (None, "bfloat16"),
    "flat_layout": (False, True),
    "packed_linear": (False, True),
    "scatter_impl": ("xla", "mxu"),
    "dropout_impl": ("threefry", "hash"),
    "optimizer_slot_dtype": (None, "bfloat16-sr"),
}

# rectpu's dense-sweep / sparse-step crossover (common.py:293-298)
_FAST_STEP_ELEMS = 850_000_000


def apply_preset(args):
    """Resolve --preset into concrete flag values (call first, before the
    TowerConfig is built); only knobs still at their default change."""
    if getattr(args, "preset", None) != "scaled":
        return args
    applied = []
    for knob, (default, value) in _SCALED_PRESET.items():
        if hasattr(args, knob) and getattr(args, knob) == default:
            setattr(args, knob, value)
            applied.append(knob)
    args._preset_applied = tuple(applied)
    logger.info("preset scaled: %s", ", ".join(f"{k}={getattr(args, k)}" for k in applied))
    return args


def resolve_optimizer(args, model, optimizer):
    """The run's optimizer: ``optimizer``, else the model's default; under
    ``--table-store bfloat16`` wrapped in ``bf16_param_store``
    (``rectpu/trainers/common.py:513-528``)."""
    optimizer = optimizer or model.default_optimizer()
    if getattr(args, "table_store", "float32") == "bfloat16":
        import torch

        from rectpu_torch.train.optimizers import bf16_param_store

        if model.cfg.torch_compute_dtype != torch.bfloat16:
            # the forward must have been casting its gathers to bf16 already,
            # or a bf16 store silently changes the model
            raise ValueError("--table-store bfloat16 requires --compute-dtype bfloat16")
        if model.cfg.torch_table_dtype == torch.bfloat16:
            raise ValueError("--table-store bfloat16 is redundant with --table-dtype bfloat16 "
                             "(the master itself is already bf16)")
        optimizer = bf16_param_store(optimizer)
    return optimizer


def resolve_fast_step(args, model, optimizer, plan=None):
    """The (init, step) pair for --fast-step, or None (rectpu's
    ``_resolve_fast_step``, ``trainers/common.py:264-338``).

    'auto' turns the sparse step on past the dense-sweep crossover (850M
    table elements per shard) when the run is compatible, and otherwise logs
    and keeps the dense step; 'on' raises on an incompatibility instead.
    Under a ``plan`` the step runs sharded (``train/fast_step.py``)."""
    mode = getattr(args, "fast_step", "off") or "off"
    if mode == "off":
        return None

    def fail(msg):
        if mode == "on":
            raise ValueError(f"--fast-step on: {msg}")
        logger.info("--fast-step auto: staying on the dense step (%s)", msg)
        return None

    if not hasattr(model, "apply_looked"):
        return fail(f"{model.name} has no apply_looked hook")
    cols = model.cfg.embedding_size + (1 if getattr(model, "use_linear", False) else 0)
    elems_per_shard = (model.cfg.padded_buckets * cols
                       // max(getattr(args, "num_model_shards", 1), 1))
    if mode == "auto" and elems_per_shard < _FAST_STEP_ELEMS:
        return None
    if optimizer.name != "Adam":
        return fail(f"requires Adam (got {optimizer.name}); the sparse step IS "
                    "lazy Adam (tf _apply_sparse semantics)")
    slot_dtype = "float32"
    if getattr(args, "optimizer_slot_dtype", None):
        if "optimizer_slot_dtype" in getattr(args, "_preset_applied", ()):
            # --preset scaled injected it for the dense sweep; the sparse step
            # keeps fp32 rows unless the flag is typed
            logger.info("fast step: ignoring the preset's bf16-sr slot dtype "
                        "(sparse rows keep fp32 m/v; pass the flag "
                        "explicitly for the bf16 slab)")
        elif args.optimizer_slot_dtype in ("bfloat16-sr", "bfloat16_sr"):
            slot_dtype = "bfloat16_sr"
            logger.info("fast step: bf16 m|v slab (v stochastically rounded)")
        else:
            return fail("sparse rows support float32 or bfloat16-sr slots; "
                        f"got {args.optimizer_slot_dtype}")
    if getattr(args, "table_dtype", "float32") != "float32" or \
            getattr(args, "table_store", "float32") != "float32":
        return fail("needs fp32 tables (no bf16 master/store)")
    if plan is not None and getattr(model, "use_linear", False) \
            and not getattr(model, "packed", False):
        return fail("sharding with a linear tower needs the single fused table leaf; "
                    "add --packed-linear")
    from rectpu_torch.train.fast_step import make_sparse_step

    fns = make_sparse_step(
        model,
        learning_rate=getattr(args, "learning_rate", 0.001),
        loss_reduction=getattr(args, "loss_reduction", "mean"),
        scatter_backend=getattr(args, "sparse_scatter", "auto"),
        slot_dtype=slot_dtype,
        plan=plan,
    )
    logger.info("fast step on: sparse lazy-Adam table updates%s",
                " over the EP exchange" if (plan is not None and plan.ep) else "")
    return fns


def _has_checkpoint(job_dir) -> bool:
    from rectpu_torch.train.checkpoint import Checkpointer

    return Checkpointer(job_dir).latest_step() is not None


def _write_atomic_npy(path: Path, arr) -> None:
    tmp = path.parent / f".{path.stem}.{os.getpid()}.tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def _row_placement(args, model, train_ds, eval_ds, perm_path: Path, rank0: bool):
    """(row_perm or None, post-relabel row counts or None): rectpu's
    ``--ep-row-placement freq`` and stored-placement branches
    (``common.py:402-459``). Every rank derives the same map from the same
    CSV; rank 0 writes it."""
    from rectpu_torch.parallel.placement import count_row_frequencies, frequency_permutation

    if getattr(args, "ep_row_placement", "none") == "freq":
        if args.num_model_shards <= 1:
            raise ValueError("--ep-row-placement freq requires --num-model-shards > 1")
        if perm_path.exists():
            # restored run: the relabeling must match the checkpointed table
            row_perm, post = np.load(perm_path), None
        else:
            if args.restore and _has_checkpoint(args.job_dir):
                raise ValueError(
                    "--ep-row-placement freq with --restore, but the job dir has a "
                    "checkpoint and no row_perm.npy: the checkpoint was trained without "
                    "placement. Drop the flag or start fresh.")
            if not hasattr(train_ds, "cat_ids"):
                raise ValueError(
                    "--ep-row-placement freq needs a resident dataset (incompatible with "
                    "--streaming-io: counting requires a full pass; precompute "
                    "row_perm.npy offline instead)")
            fs = model.cfg.feature_set
            counts = count_row_frequencies(train_ds.cat_ids, model.cfg.padded_buckets)
            row_perm = frequency_permutation(
                counts, (tuple(int(o) for o in fs.offsets), tuple(fs.field_sizes)),
                args.num_model_shards, model.cfg.padded_buckets)
            if rank0:
                _write_atomic_npy(perm_path, row_perm)
            post = np.zeros_like(counts)
            post[row_perm[: counts.shape[0]]] = counts
    elif perm_path.exists():
        # the checkpoint or export in this job dir was trained with placement;
        # ignoring the stored map would index the permuted table with raw ids
        logger.info("applying stored row placement from %s", perm_path)
        row_perm, post = np.load(perm_path), None
    else:
        return None, None
    train_ds.apply_row_permutation(row_perm)
    eval_ds.apply_row_permutation(row_perm)
    return row_perm, post


def _peer_capacity(args, model, train_ds, post_perm_counts):
    """--ep-peer-capacity as an int or None; 'auto' sizes it from the row
    frequencies after any remap (rectpu's ``common.py:461-480``)."""
    cap = getattr(args, "ep_peer_capacity", None)
    if cap != "auto":
        return None if cap is None else int(cap)
    from rectpu_torch.parallel.placement import count_row_frequencies, suggest_peer_capacity

    counts = post_perm_counts
    if counts is None:
        if not hasattr(train_ds, "cat_ids"):
            raise ValueError("--ep-peer-capacity auto needs a resident dataset")
        counts = count_row_frequencies(train_ds.cat_ids, model.cfg.padded_buckets)
    n_inst = args.num_data_shards * args.num_model_shards
    # one lookup_fn serves the train and the eval steps: size for the larger slice
    eval_bs = args.eval_batch_size or max(args.batch_size, 512)
    lookups = (max(args.batch_size, eval_bs) // max(n_inst, 1)) * model.cfg.num_fields
    cap = suggest_peer_capacity(counts, args.num_model_shards, model.cfg.padded_buckets,
                                lookups)
    logger.info("ep_peer_capacity auto -> %d", cap)
    return cap


def build_trainer(args, model, optimizer=None):
    """Datasets + Trainer + exporter from parsed args and a model (and the
    model's default optimizer when ``optimizer`` is None)."""
    from rectpu_torch.io.loader import CsvDataset, StreamingCsvDataset
    from rectpu_torch.serve.export import make_exporter
    from rectpu_torch.train.loop import TrainConfig, Trainer

    import torch.distributed as dist

    if (getattr(args, "packed_col_pad", 0) and args.num_model_shards > 1
            and getattr(args, "flat_layout", False)):
        raise ValueError(
            "--packed-col-pad + --flat-layout is not supported with --num-model-shards > 1: "
            "the flat EP exchange variants infer K from the table width. Drop one of the "
            "two.")
    optimizer = resolve_optimizer(args, model, optimizer)
    device = resolve_device(args.device)
    sharded = args.num_data_shards * args.num_model_shards > 1
    owns_group = False
    if sharded or int(os.environ.get("WORLD_SIZE", 1)) > 1:
        from rectpu_torch.parallel.mesh import distributed_init

        owns_group = not dist.is_initialized() and distributed_init(device.type)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    fs = model.cfg.feature_set
    if args.autotune:
        from rectpu_torch.ops.autotune import autotune

        autotune(batch=args.batch_size, num_fields=model.cfg.num_fields,
                 embedding_size=model.cfg.embedding_size, vocab_rows=model.cfg.padded_buckets,
                 field_info=(tuple(int(o) for o in fs.offsets), tuple(fs.field_sizes)),
                 device=device)
    if not args.restore and rank0:
        shutil.rmtree(args.job_dir, ignore_errors=True)
    Path(args.job_dir).mkdir(parents=True, exist_ok=True)
    if dist.is_initialized():
        dist.barrier()  # the job dir is cleared before any rank reads it
    dataset = StreamingCsvDataset if args.streaming_io else CsvDataset
    train_ds = dataset(args.train_csv, fs)
    eval_ds = dataset(args.test_csv, fs)
    perm_path = Path(args.job_dir) / "row_perm.npy"
    row_perm, post_perm_counts = _row_placement(args, model, train_ds, eval_ds, perm_path,
                                                rank0)
    plan = None
    if sharded or dist.is_initialized():  # a world unlike the mesh raises in make_mesh
        from rectpu_torch.parallel.plan import ParallelPlan

        plan = ParallelPlan.create(
            args.num_data_shards, args.num_model_shards, device=device.type,
            table_rows=model.cfg.padded_buckets, ep_mode=args.ep_mode,
            ep_comm_compress=args.ep_comm_compress,
            ep_peer_capacity=_peer_capacity(args, model, train_ds, post_perm_counts),
            tp_mlp=args.tp_mlp, scatter_impl=getattr(args, "scatter_impl", "xla"))
        plan.barrier()  # rank 0's row_perm.npy is on disk
    fast_step = resolve_fast_step(args, model, optimizer, plan)
    config = TrainConfig(
        batch_size=args.batch_size,
        train_steps=args.train_steps,
        eval_batch_size=args.eval_batch_size,
        save_checkpoints_secs=args.save_checkpoints_secs,
        save_checkpoints_steps=args.save_checkpoints_steps,
        steps_per_loop=args.steps_per_loop,
        seed=args.seed,
        loss_reduction=args.loss_reduction,
        eval_auc=args.eval_auc,
        data_placement=args.data_placement,
    )

    exporter = make_exporter(model, args.job_dir, row_perm=row_perm, mode=args.exporter,
                             compare_metric=args.best_exporter_metric)
    trainer = Trainer(model, optimizer, train_ds, eval_ds, args.job_dir, config,
                      exporter=exporter, device=device, fast_step=fast_step, plan=plan)
    trainer.owns_process_group = owns_group
    trainer.profile_dir = args.profile_dir
    trainer.warm_start_from = args.warm_start_from
    trainer.warm_start_vars = args.warm_start_vars
    return trainer


def run(args, model, optimizer=None):
    """Build the trainer and train (with the model's default optimizer when
    ``optimizer`` is None); returns (final metrics, trainer)."""
    if args.table_dtype == "bfloat16" and (optimizer is None or optimizer.name != "Adam"):
        # only Adam rounds a bf16 master stochastically; Adagrad or FTRL would
        # build bf16 accumulators
        raise ValueError("--table-dtype bfloat16 requires the Adam optimizer")
    trainer = build_trainer(args, model, optimizer)
    try:
        metrics = trainer.train_and_evaluate(restore=args.restore)
    finally:
        if trainer.owns_process_group:
            import torch.distributed as dist

            dist.destroy_process_group()
    logger.info("done: %s", metrics)
    return metrics, trainer
