"""The training loop: the port of ``rectpu/train/loop.py``.

``Trainer.train_and_evaluate`` runs rectpu's cadence (``loop.py:497-708``):
train steps; every ``save_checkpoints_steps`` steps (or
``save_checkpoints_secs`` seconds) a checkpoint with keep-N rotation, an
eval pass and an export of the latest model; at the end a last checkpoint,
the final eval and the export. Checkpoints and exports are in rectpu's
layout, so either package restores or serves the other's.

Dispatch (``TrainConfig.dispatch_mode``, rectpu's ``loop.py:55-61,
268-272``; ``train/dispatch.py``): "pipelined" dispatches each step on its
own, with one batch staged ahead of the step (rectpu's depth-2 prefetch);
"scan" runs a loop's ``steps_per_loop`` steps from fixed device buffers
(the loop's batches and per-step scalars, copied in once per loop), on the
card as replays of a CUDA graph of one step, captured after a few eager
warm-up steps (``StepGraph``), the counterpart of rectpu's one ``lax.scan``
dispatch; "auto" pipelines from batch 2048 up, else scans, under a plan as
without one. Both modes train bit for bit alike. Under a plan on the card
the captured step is cut at its collectives into segment graphs, with the
collectives run eagerly between their replays (``StepGraph``).
Either way the per-step losses are read back from the device once per loop,
with the loop's log line.

What differs from rectpu, and why:

  - Each step's dropout seed is ``models.base.step_seed32(seed, step)``.
  - ``data_placement`` "device" (and "auto" when the encoded train set fits
    ``data_placement_max_bytes``) uploads the encoded train set once and
    ships only each batch's row indices; both placements consume the same
    index stream, so training is the same either way.

Sharded (``plan``, a ``parallel.ParallelPlan``; rectpu's ``loop.py:528-552,
595-630``): every rank runs this loop on its own process. The model's hooks
are set from the plan (``lookup_fn``; ``row_offset``, the first global row
of the rank's batch slice, so hash dropout masks the global batch's rows;
``tp_plan`` under ``tp_mlp``, the tensor-parallel towers). Each rank takes
its block of every global batch from the loader (``cfg.batch_size`` stays
the global batch), holds its table rows, and after
backward sums the gradients through ``plan.reduce_grads``; each step's loss
is the global batch's (the ranks' shares summed once per loop). The eval
walks a rank's rows ``[i::n]`` and sums the metric state over the batch
ranks. Under ``tp_mlp`` the towers and their optimizer state are cut by the
plan after init and after a restore, like the table. A save all_gathers the
table and tower shards to every rank (a collective:
every rank saves at the same steps; the wall-clock cadence is rank 0's),
and rank 0 alone writes the checkpoint, the export and the event file, in
rectpu's single-device layout. A restore reads the full checkpoint on every
rank and keeps the rank's rows, so a checkpoint moves between sharded and
single runs of either package.

Events: the Trainer writes rectpu's TensorBoard event file into the job dir
(``utils/events.py``, ``loop.py:124-131, 380-398, 657-692``): ``loss`` and
``examples_per_sec`` at each log, ``eval/<metric>`` after each eval and the
final one, and after each eval before the last a ``params/<path>`` histogram
and ``params/<path>/fraction_of_zero_values`` of every parameter (a leaf of
more than 65,536 elements sampled every ``size // 65536``-th). The exporter
(``serve/export.make_exporter``) is called as ``exporter(params, step,
metrics=...)`` with the latest eval metrics, which the best exporter compares.

``profile_dir``, when set, traces the second logging window of the run (the
``steps_per_loop`` steps after the first, so that kernel builds and warm-up
stay out of the trace) with ``utils.profiling.trace``, stops once that
window's losses are on the host, logs the trace's path and clears the field
(``loop.py:581-584, 641-646``).

A step is forward, ``sigmoid_xent`` reduced by mean or sum (``loop.py:140-147``),
backward, and the optimizer's in-place update. Given ``fast_step`` (the
``(init_opt_state, step)`` pair of ``train/fast_step.make_sparse_step``), the
sparse lazy-Adam step replaces all three and its ``init_opt_state`` makes the
optimizer state (``loop.py:105-113, 152-158, 505-508``); the optimizer then
only names the semantics. An optimizer with a ``prepare`` hook
(``bf16_param_store``) has it applied once after ``init``, before a restore
(``loop.py:509-513``). Checkpoints hold the optimizer state in rectpu's tree
(``convert.opt_state_tree``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from rectpu_torch.convert import (
    flat_params,
    flatten_tree,
    load_params,
    opt_state_from_tree,
    opt_state_tree,
    params_tree,
    sparse_state_from_tree,
    sparse_state_tree,
)
from rectpu_torch.io.loader import DataState
from rectpu_torch.models.base import step_seed32
from rectpu_torch.train import metrics as metrics_lib
from rectpu_torch.train.checkpoint import Checkpointer, _load_flat_npz
from rectpu_torch.train.dispatch import (BatchBlock, ScalarBlock, StepGraph, StepScalars,
                                         opt_counter, resolve_dispatch_mode, set_opt_counter)
from rectpu_torch.utils.events import EventWriter
from rectpu_torch.utils.logging import get_logger
from rectpu_torch.utils.profiling import trace

logger = get_logger(__name__)

EVAL_INTERVAL = 60  # seconds, reference parity (conf_utils.py:3)


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 32
    train_steps: int = 20000
    eval_batch_size: int | None = None  # default max(batch_size, 512)
    save_checkpoints_secs: float | None = EVAL_INTERVAL
    save_checkpoints_steps: int | None = None  # overrides secs if set
    keep_checkpoint_max: int = 5
    log_every_steps: int = 100
    steps_per_loop: int = 100
    seed: int = 42
    final_eval: bool = True
    async_checkpoint: bool = True  # background disk writes (the host copy is synchronous)
    loss_reduction: str = "mean"  # or "sum" (TF-1.x head semantics)
    eval_auc: str = "streaming"  # or "exact" (rank-based; streaming kept as auc_streaming)
    data_placement: str = "auto"  # "host", "device" or "auto"
    data_placement_max_bytes: int = 1 << 30
    # how a loop's steps reach the device: "scan" (fixed buffers; on the card
    # a CUDA graph of the step replayed per step), "pipelined" (each step
    # dispatched on its own) or "auto" (pipelined from batch 2048 up)
    dispatch_mode: str = "auto"


class _NoEvents:
    """The event writer of a rank other than 0: writes nothing."""

    def add_scalar(self, *args) -> None:
        pass

    add_scalars = add_histogram = add_scalar

    def close(self) -> None:
        pass


class Trainer:
    def __init__(self, model, optimizer, train_ds, eval_ds, job_dir: str | Path,
                 config: TrainConfig, exporter=None, device=None, fast_step=None, plan=None):
        self.model = model
        self.plan = plan
        self.optimizer = optimizer
        self.fast_step = fast_step
        self.train_ds = train_ds
        self.eval_ds = eval_ds
        self.job_dir = Path(job_dir)
        self.config = config
        self.exporter = exporter
        self.events: EventWriter | None = None  # open while train_and_evaluate runs
        self.device = torch.device("cpu") if device is None else torch.device(device)
        if plan is not None:
            self.device = plan.mesh.device
            model.lookup_fn = plan.lookup_fn
            model.row_offset = plan.batch_index * (config.batch_size // plan.batch_shards)
            model.tp_plan = plan if plan.tp_mlp else None
        resolve_dispatch_mode(config.dispatch_mode, config.batch_size)  # a bad mode raises
        self.step_graph: StepGraph | None = None  # scan mode's step, once training ran
        self.ckpt = Checkpointer(self.job_dir, keep=config.keep_checkpoint_max,
                                 async_write=config.async_checkpoint)
        self.warm_start_from: str | None = None
        self.warm_start_vars: list | None = None
        self.owns_process_group = False  # the CLI started the plan's process group
        self.profile_dir: str | None = None  # set to trace the second logging window
        self.step_losses: list[float] = []  # every step's loss, read back once per loop
        self.opt_state: dict | None = None
        self._eval_cache = None

    @property
    def dispatch(self) -> str:
        """"scan" or "pipelined": ``config.dispatch_mode`` resolved
        (``train/dispatch.resolve_dispatch_mode``)."""
        return resolve_dispatch_mode(self.config.dispatch_mode, self.config.batch_size)

    # -- one step ----------------------------------------------------------------

    def loss(self, batch: dict, train: bool, step: int = 0, seed32=None) -> torch.Tensor:
        """The batch's loss; in train mode with dropout seeded by ``seed32``
        (default ``step_seed32`` of ``step``)."""
        if train and seed32 is None:
            seed32 = step_seed32(self.config.seed, step)
        logits = self.model(batch["cat_ids"], batch["num_vals"], train=train,
                            seed32=seed32 if train else None)
        losses = metrics_lib.sigmoid_xent(logits, batch["labels"])
        if self.plan is not None:
            return self.plan.local_loss(losses, self.config.loss_reduction)
        return losses.sum() if self.config.loss_reduction == "sum" else losses.mean()

    def train_step(self, batch: dict, scalars) -> torch.Tensor:
        """Forward, backward and the optimizer update of one step; returns the
        loss (a device scalar, not waited for; sharded, this rank's share).
        ``scalars``: the step's scalars (``train/dispatch``: host numbers, or
        the device tensors that scan mode's steps read), or the step's index
        (host scalars: its ``step_seed32`` and the optimizer's next ``t``).
        The pipelined and scan loops and a CUDA graph's capture all run this
        function."""
        if isinstance(scalars, int):
            scalars = StepScalars.after(self.opt_state, step_seed32(self.config.seed, scalars))
        if self.plan is not None:
            scalars.placement = self.plan.sr_index  # SR keys on the global arrays' indices
        params = flat_params(self.model)
        if self.fast_step is not None:
            return self.fast_step[1](params, self.opt_state, batch, scalars)
        for p in params.values():
            p.grad = None
        loss = self.loss(batch, train=True, seed32=scalars.seed32)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if self.plan is not None:
            self.plan.reduce_grads(grads, self.model.cfg.torch_table_grad_dtype)
        self.optimizer.update(grads, self.opt_state, params, scalars)
        return loss.detach()

    # -- data ----------------------------------------------------------------------

    def _to_device(self, batch: dict) -> dict:
        def put(v):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":  # a pinned copy does not wait for the card
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

        return {k: put(v) for k, v in batch.items()}

    def _resident(self):
        """The encoded train set on the device, or None for host staging."""
        mode, ds = self.config.data_placement, self.train_ds
        if mode == "host":
            return None
        resident = hasattr(ds, "cat_ids")  # a StreamingCsvDataset holds no encoded set
        nbytes = ds.cat_ids.nbytes + ds.num_vals.nbytes + ds.labels.nbytes if resident else 0
        if not resident or nbytes > self.config.data_placement_max_bytes:
            if mode == "device":
                raise ValueError("data_placement='device' needs a resident (non-streaming) "
                                 "train set within data_placement_max_bytes "
                                 f"({self.config.data_placement_max_bytes} B)")
            return None
        return self._to_device({"cat_ids": ds.cat_ids, "num_vals": ds.num_vals,
                                "labels": ds.labels})

    def _shards(self) -> tuple[int, int]:
        """(batch shards, this rank's index among them): (1, 0) unsharded."""
        if self.plan is None:
            return 1, 0
        return self.plan.batch_shards, self.plan.batch_index

    def _host_batches(self, data_state, resident):
        """This rank's train batches as the loader gives them, each with the
        DataState after it: row indices into ``resident`` (the train set on
        the device), else {key: array}."""
        cfg = self.config
        n, pos = self._shards()
        if cfg.batch_size % n:
            raise ValueError(f"batch_size {cfg.batch_size} is not divisible by {n} batch "
                             "shards")
        shard = {"shard_id": pos, "num_shards": n} if n > 1 else {}
        if resident is None:
            return self.train_ds.train_batches(cfg.batch_size // n, state=data_state,
                                               seed=cfg.seed, **shard)
        return self.train_ds.train_index_batches(cfg.batch_size // n, state=data_state,
                                                 seed=cfg.seed, **shard)

    def _stage(self, item, resident) -> dict:
        """One batch of ``_host_batches`` on the device (pipelined dispatch)."""
        if resident is None:
            return self._to_device(item)
        idx = self._to_device({"idx": item})["idx"]
        return {k: v.index_select(0, idx) for k, v in resident.items()}

    def _batches(self, data_state):
        """The train batches on the device, one by one, each with the
        DataState after it."""
        resident = self._resident()
        for item, st in self._host_batches(data_state, resident):
            yield self._stage(item, resident), st

    def loop_runner(self, resident):
        """The function that runs one loop of the train loop in this
        Trainer's dispatch mode: ``run(batches, step, k)`` takes the next k
        batches of ``batches`` (``_host_batches`` over ``resident``, the
        train set on the device or None), runs steps ``step`` ...
        ``step + k - 1`` and returns their [k] losses on the device (this
        rank's shares) and the DataState after the last batch."""
        logger.info("dispatch: %s", self.dispatch)
        if self.dispatch == "scan":
            return self._scan_runner(resident)
        return lambda batches, step, k: self._run_pipelined(batches, resident, step, k)

    def _run_pipelined(self, batches, resident, step: int, k: int):
        """Steps ``step`` ... ``step + k - 1`` dispatched one by one, with
        rectpu's depth-2 prefetch (``loop.py:585-620``): the batch of step
        i + 1 is staged before step i is dispatched. Returns the [k] losses
        on the device and the DataState after the last batch."""
        staged, data_state = [], None

        def stage():
            nonlocal data_state
            item, data_state = next(batches)
            staged.append(self._stage(item, resident))

        for _ in range(min(2, k)):
            stage()
        losses = []
        for i in range(k):
            losses.append(self.train_step(staged.pop(0), step + i))
            if i + 2 < k:
                stage()
        return torch.stack(losses).float(), data_state

    def _scan_runner(self, resident):
        """Scan dispatch (``train/dispatch.py``): a function that runs a
        loop's k steps from fixed buffers (the loop's batches and scalars,
        copied in first), each as one call of ``self.step_graph``, and
        returns the [k] losses on the device and the DataState after the
        last batch. The only host work between two steps is the threefry
        generators' reseed and the call (on the card a graph replay; under a
        plan the segments' replays and the collectives between them)."""
        cfg = self.config
        block = ScalarBlock(cfg.steps_per_loop, self.device, cfg.seed)
        data = BatchBlock(cfg.steps_per_loop, self.device, resident)
        losses = torch.zeros(cfg.steps_per_loop, dtype=torch.float32, device=self.device)

        def one_step():
            loss = self.train_step(data.batch(block.counter), block.view())
            losses.index_copy_(0, block.counter, loss.reshape(1).float())
            block.advance()

        self.step_graph = StepGraph(one_step, block, self.device)

        def run(batches, step: int, k: int):
            items, data_state = [], None
            for _ in range(k):
                item, data_state = next(batches)
                items.append(item)
            data.load(items)
            t0 = opt_counter(self.opt_state)
            block.load(step, t0, k)
            for seed32 in block.host_seeds():
                block.sites.begin(seed32)
                self.step_graph()
            set_opt_counter(self.opt_state, t0 + k)
            return losses[:k].clone(), data_state

        return run

    # -- eval ------------------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self) -> dict:
        """One full pass over the eval set -> metric dict (floats)."""
        cfg = self.config
        n, pos = self._shards()
        if self._eval_cache is None:
            eval_bs = cfg.eval_batch_size or max(cfg.batch_size, 512)
            shard = {"shard_id": pos, "num_shards": n} if n > 1 else {}
            self._eval_cache = [self._to_device(b) for b in
                                self.eval_ds.eval_batches(max(eval_bs // n, 1), **shard)]
        state = metrics_lib.init_state(device=self.device)
        probs_all = []
        for batch in self._eval_cache:
            logits = self.model(batch["cat_ids"], batch["num_vals"], train=False)
            preds = metrics_lib.binary_predictions(logits)
            losses = metrics_lib.sigmoid_xent(logits, batch["labels"])
            state = metrics_lib.update_state(state, preds["probabilities"], batch["labels"],
                                             losses=losses, weights=batch["weights"])
            probs_all.append(preds["probabilities"])
        if self.plan is not None:
            state = metrics_lib.psum_state(state, self.plan)
        result = metrics_lib.finalize(state)
        if cfg.eval_auc == "exact":
            # the rank statistic does not depend on the order of the union
            gather = self.plan.gather_batch_values if self.plan is not None else (lambda x: x)
            probs = gather(torch.cat(probs_all)).cpu().numpy()
            labels = gather(torch.cat([b["labels"] for b in self._eval_cache])).cpu().numpy()
            valid = gather(torch.cat([b["weights"] for b in self._eval_cache])).cpu().numpy() > 0
            result["auc_streaming"] = result["auc"]
            result["auc"] = metrics_lib.exact_auc(probs[valid], labels[valid])
        return result

    # -- warm start ------------------------------------------------------------------

    def _warm_start(self, params: dict) -> dict:
        """Initialize from a previous run's artifact (tf WarmStartSettings
        parity, ``loop.py:419-495``): an export dir, a ckpt-N dir, or a job
        dir (its newest export, else its newest checkpoint), written by
        either package. Leaves match by key path; a shape mismatch raises;
        leaves absent from the artifact keep their fresh init."""
        from rectpu_torch.serve.export import latest_export

        src = Path(self.warm_start_from)
        if (src / "model.json").exists():
            meta = json.loads((src / "model.json").read_text())
            if meta.get("table_quant"):
                raise ValueError(f"cannot warm-start from a quantized export ({src}); "
                                 "use the fp export it was derived from")
            flat_src = _load_flat_npz(src / "arrays.npz")
        elif (src / "arrays.npz").exists():
            flat_src = {k[len("params/"):]: v for k, v in _load_flat_npz(src / "arrays.npz").items()
                        if k.startswith("params/")}
        else:
            exp = latest_export(src)
            if exp is not None:
                flat_src = _load_flat_npz(exp / "arrays.npz")
            else:
                snap = Checkpointer(src).restore()
                if snap is None:
                    raise FileNotFoundError(
                        f"warm-start source {src} has neither exports nor checkpoints")
                flat_src = flatten_tree(snap[0]["params"])
        if self.warm_start_vars:
            flat_src = {k: v for k, v in flat_src.items()
                        if any(k == p or k.startswith(p.rstrip("/") + "/")
                               for p in self.warm_start_vars)}
        flat_tpl = flatten_tree(params)
        used, missing, out = 0, [], {}
        for key, tpl in flat_tpl.items():
            if key in flat_src:
                got = flat_src[key]
                if tuple(got.shape) != tuple(tpl.shape):
                    raise ValueError(f"warm-start shape mismatch for {key!r}: "
                                     f"{tuple(got.shape)} vs {tuple(tpl.shape)}")
                out[key] = got.to(tpl.dtype)
                used += 1
            else:
                missing.append(key)
                out[key] = tpl
        if used == 0:
            raise ValueError("warm-start artifact shares no parameters with the model")
        if missing:
            logger.warning("warm start: %d leaves kept fresh init (%s)", len(missing),
                           ", ".join(missing[:5]))
        logger.info("warm-started %d/%d parameter leaves", used, len(flat_tpl))
        from rectpu_torch.train.checkpoint import _rebuild, _treedef_template

        return _rebuild(_treedef_template(params), out)

    # -- the loop --------------------------------------------------------------------

    @property
    def _rank0(self) -> bool:
        return self.plan is None or self.plan.process_index == 0

    def _save(self, step: int, data_state) -> dict:
        """Checkpoint {params, opt_state} in rectpu's layout; returns the
        (global) params tree. Sharded, every rank calls it (the gather is a
        collective) and rank 0 writes."""
        params = params_tree(self.model)
        opt_state = (sparse_state_tree(self.model, self.opt_state) if self.fast_step is not None
                     else opt_state_tree(self.opt_state))
        if self.plan is not None:
            params = self.plan.gather_params(params)
            opt_state = self.plan.gather_params(opt_state)
        if self._rank0:
            self.ckpt.save(step, {"params": params, "opt_state": opt_state},
                           extra_meta={"data_state": dataclasses.asdict(data_state)
                                       if data_state else None,
                                       "model": getattr(self.model, "name", "model")})
        return params

    def _export(self, params: dict, step: int, metrics: dict) -> None:
        if self.exporter is not None and self._rank0:
            self.exporter(params, step, metrics=metrics)

    def _log_histograms(self, params: dict, step: int, max_elems: int = 65536) -> None:
        """A histogram and the share of zeros of every parameter leaf, in
        rectpu's order and tags (``loop.py:380-398``); a leaf of more than
        ``max_elems`` elements is sampled."""
        for name, leaf in flatten_tree(params).items():
            arr = leaf.float().numpy().ravel()
            if arr.size == 0:
                continue
            if arr.size > max_elems:
                arr = arr[:: max(arr.size // max_elems, 1)]
            self.events.add_histogram(f"params/{name}", arr, step)
            self.events.add_scalar(f"params/{name}/fraction_of_zero_values",
                                   float((arr == 0).mean()), step)

    def train_and_evaluate(self, restore: bool = True) -> dict:
        """Train, evaluate and export (the module docstring's cadence);
        returns the final eval's metrics."""
        self.events = EventWriter(self.job_dir) if self._rank0 else _NoEvents()
        try:
            return self._train_and_evaluate(restore)
        finally:
            self.events.close()
            self.events = None

    def _train_and_evaluate(self, restore: bool) -> dict:
        cfg = self.config
        params = self.model.init(torch.Generator().manual_seed(cfg.seed))
        if self.warm_start_from:
            # TF semantics: warm start seeds a fresh run; a restored
            # checkpoint (below) overwrites it
            params = self._warm_start(params)
        if self.plan is not None:
            params = self.plan.shard_params(params)
        load_params(self.model, params, self.device)
        if self.fast_step is not None:
            self.opt_state = self.fast_step[0](flat_params(self.model))
        else:
            self.opt_state = self.optimizer.init(flat_params(self.model))
        prepare = getattr(self.optimizer, "prepare", None)
        if prepare is not None:
            # e.g. bf16_param_store: init took the fp32 masters, now store the
            # leaves the forward reads (a restored checkpoint below holds
            # both trees in stored form already)
            load_params(self.model, prepare(params), self.device)
        step, data_state = 0, None
        if restore:
            snapshot = self.ckpt.restore()
            if snapshot is not None:
                tree, meta = snapshot
                if self.plan is not None:
                    tree = self.plan.shard_params(tree)  # this rank's rows
                load_params(self.model, tree["params"], self.device)
                if self.fast_step is not None:
                    self.opt_state = sparse_state_from_tree(tree["opt_state"], self.device)
                else:
                    self.opt_state = opt_state_from_tree(tree["opt_state"], self.opt_state)
                step = meta["step"]
                if meta.get("data_state"):
                    data_state = DataState(**meta["data_state"])
                logger.info("restored checkpoint at step %s", step)
        if self.plan is not None:
            self.plan.barrier()  # every rank restores (or not) before any rank trains
        self.model.train()

        resident = self._resident()
        batches = self._host_batches(data_state, resident)
        run_loop = self.loop_runner(resident)
        last_save = time.time()
        t_loop = time.time()
        examples = 0
        last_metrics: dict = {}
        windows = 0
        while step < cfg.train_steps:
            k = min(cfg.steps_per_loop, cfg.train_steps - step)
            traced = bool(self.profile_dir) and windows == 1 and self._rank0
            with (trace(self.profile_dir, cuda=self.device.type == "cuda") if traced
                  else contextlib.nullcontext()) as capture:
                stacked, data_state = run_loop(batches, step, k)
                if self.plan is not None:
                    stacked = self.plan.global_value(stacked)  # the ranks' shares, summed
                self.step_losses.extend(stacked.cpu().tolist())
            if traced:
                logger.info("profile trace written to %s", capture.path)
                self.profile_dir = None
            step += k
            windows += 1
            examples += k * cfg.batch_size
            if cfg.log_every_steps and step % cfg.log_every_steps < cfg.steps_per_loop:
                dt = time.time() - t_loop
                eps = examples / max(dt, 1e-9)
                logger.info("step %d: loss = %.5f (%.1f examples/sec)", step,
                            self.step_losses[-1], eps)
                self.events.add_scalar("loss", self.step_losses[-1], step)
                self.events.add_scalar("examples_per_sec", eps, step)
                t_loop, examples = time.time(), 0

            due_steps = cfg.save_checkpoints_steps and step % cfg.save_checkpoints_steps == 0
            due_secs = (cfg.save_checkpoints_steps is None
                        and cfg.save_checkpoints_secs is not None
                        and time.time() - last_save >= cfg.save_checkpoints_secs)
            if self.plan is not None and cfg.save_checkpoints_steps is None:
                due_secs = self.plan.agree(due_secs)
            if (due_steps or due_secs) and step < cfg.train_steps:
                host_params = self._save(step, data_state)
                last_save = time.time()
                last_metrics = self.evaluate()
                logger.info("eval at step %d: %s", step, _fmt_metrics(last_metrics))
                self.events.add_scalars({f"eval/{k}": v for k, v in last_metrics.items()},
                                        step)
                if self._rank0:
                    self._log_histograms(host_params, step)
                self._export(host_params, step, last_metrics)

        batches.close()  # a streaming dataset's prefetch thread stops here
        host_params = self._save(step, data_state)
        if cfg.final_eval:
            last_metrics = self.evaluate()
            logger.info("final eval at step %d: %s", step, _fmt_metrics(last_metrics))
            self.events.add_scalars({f"eval/{k}": v for k, v in last_metrics.items()}, step)
        self._export(host_params, step, last_metrics)
        self.ckpt.close()
        return last_metrics


def _fmt_metrics(m: dict) -> str:
    return ", ".join(f"{k} = {v:.5f}" for k, v in sorted(m.items()))
