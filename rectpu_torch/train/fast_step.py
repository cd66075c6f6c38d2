"""Training step with sparse table updates: the port of ``rectpu/train/fast_step.py``.

The generic step differentiates through the embedding gather, so the table
gradient is a dense [V, W] and Adam sweeps every row. This step instead:

  1. gathers the (fused linear + embedding) rows OUTSIDE autograd
     (``ops.embedding.gather_rows``: the lookup kernel on the card);
  2. differentiates the model's ``apply_looked`` hook with respect to the
     gathered rows (cast to the compute dtype) and the small dense params;
  3. deduplicates the batch ids (stable sort + fp32 segment sum, at most
     ``unique_capacity`` rows) and applies TF-style lazy Adam to exactly the
     touched rows, m and v packed as one slab per table leaf
     (``train/sparse.py``), written back with the row-set kernel;
  4. takes a dense Adam step on the rest (MLPs, biases), with ``lr_t``.

Semantics: identical to dense Adam on step 1 from zero state; after that
lazy Adam (untouched rows keep stale m/v and take no step), matching
``tf.train.AdamOptimizer._apply_sparse``.

``make_sparse_step`` returns ``(init_opt_state, step)``:
``init_opt_state(params)`` takes the flat ``{key path: tensor}`` parameters
(``convert.flat_params``) and returns rectpu's tree ``{"m": {"rest": ...},
"v": {"rest": ...}, "mv_sparse": {"table" | "emb" [, "w"]: slab}, "t":
int32}`` with each rest subtree flat, keyed by parameter path
(``convert.sparse_state_tree`` nests it as rectpu does);
``step(params, opt_state, batch, scalars)`` updates the parameters and the
state in place and returns the loss. ``scalars`` are the step's
(``train/dispatch``: the dropout seed, ``t`` and ``lr_t``, host numbers or
the device tensors a CUDA graph of the step reads), as the Trainer's dense
step takes them; a dropout seed32 or None in their place takes the step
after the state's counter on the host, with that seed.

Sharded (``plan``, a ``parallel.ParallelPlan``; rectpu's ``fast_step.py:
55-240``): each rank runs the step on its batch slice. Under EP the rows come
through the plan's exchange (``plan.lookup_fn``) from the rank's [V/M, W]
shard, and the touched rows' lazy-Adam step runs through
``parallel/sparse_ep.make_sparse_rows_ep`` (its exchange of deduplicated
rows and the row sets into the shard); without EP (data parallelism alone)
the same update gathers every rank's rows over 'data'. The small params'
gradients are summed by ``plan.reduce_grads`` (over the batch ranks; the
towers' over 'data' under ``tp_mlp``), and the returned loss is the rank's
share of the global batch's loss. Under ``tp_mlp`` the table keeps this
sparse path and ``apply_looked`` takes the towers tensor-parallel (the
model's ``tp_plan``, which the Trainer sets), as rectpu's fast step does
under a TP plan.
"""

from __future__ import annotations

import torch

from rectpu_torch.ops.embedding import gather_rows
from rectpu_torch.train import metrics as metrics_lib
from rectpu_torch.train.dispatch import StepScalars
from rectpu_torch.train.sparse import dedupe_rows, sparse_adam_rows_packed, unique_capacity

_LINEAR_W = "linear/w"


def make_sparse_step(model, learning_rate: float = 0.001, beta1: float = 0.9,
                     beta2: float = 0.999, epsilon: float = 1e-8, plan=None,
                     loss_reduction: str = "mean", scatter_backend: str = "auto",
                     state_pad: bool | None = None, slot_dtype: str = "float32"):
    """Build (init_opt_state, step) for a model with an ``apply_looked`` hook
    (DeepFM, DLRM, xDeepFM) and Adam. A model with a linear tower needs
    ``packed_linear`` (one [V, K+1] ``table``) or ``fuse_linear_lookup``
    (``emb`` and ``linear.w`` concatenated per step); a model without one
    updates its [V, K] ``emb``."""
    cfg = model.cfg
    if not hasattr(model, "apply_looked"):
        raise ValueError(f"{model.name}: sparse fast step needs an apply_looked hook")
    use_linear = bool(getattr(model, "use_linear", False))
    packed = bool(getattr(model, "packed", False))
    if use_linear and not (packed or cfg.fuse_linear_lookup):
        raise ValueError(
            "sparse fast step requires fuse_linear_lookup=True or packed_linear=True")
    ep = plan is not None and getattr(plan, "ep", False)
    if plan is not None and use_linear and not packed:
        raise ValueError(
            "sparse EP fast step with a linear tower needs packed_linear=True "
            "(one sharded [V, K+1] leaf; per-step concat of a sharded emb with "
            "a replicated w would dense-materialize the table)")
    if loss_reduction not in ("mean", "sum"):
        raise ValueError(f"loss_reduction must be mean|sum, got {loss_reduction}")
    k = cfg.embedding_size
    fs = cfg.feature_set
    field_sizes = tuple(int(s) for s in fs.field_sizes)
    table_key = "table" if packed else "emb"

    # the first droppable row id: real ids live in [0, total_buckets); the
    # rows up to padded_buckets are the pad region
    v_valid = int(fs.offsets[-1]) + int(fs.field_sizes[-1])
    pad_rows = cfg.padded_buckets - v_valid
    if scatter_backend not in ("auto", "xla", "dma"):
        raise ValueError(f"scatter_backend must be auto|xla|dma, got {scatter_backend!r}")
    if scatter_backend == "auto":
        scatter_backend = "xla"  # rectpu's mapping (fast_step.py:121-122)
    elif scatter_backend == "dma":
        if pad_rows < 8:
            raise ValueError(
                f"scatter_backend='dma' needs >= 8 pad rows past the id "
                f"space (padded_buckets {cfg.padded_buckets} - ids "
                f"{v_valid} = {pad_rows}); raise table_padding")
    if state_pad is None:
        # lane-padded m|v halves, rectpu's rule (fast_step.py:131-136): the
        # slab width is part of the checkpoint, so the port keeps it
        state_pad = scatter_backend == "dma" or cfg.padded_buckets >= 1_000_000
    if ep and getattr(cfg, "packed_col_pad", 0) and cfg.flat_layout:
        raise ValueError(
            "packed_col_pad + flat_layout is not supported under EP "
            "sharding: the flat exchange variants infer K from the table "
            "width (parallel/embedding_ep). Drop flat_layout or the pad.")
    if slot_dtype not in ("float32", "bfloat16_sr"):
        raise ValueError(f"slot_dtype must be float32|bfloat16_sr, got {slot_dtype!r}")
    if slot_dtype == "bfloat16_sr" and ep:
        raise ValueError("bf16 slots are not wired into the EP exchange yet")
    sharded_update = None
    if plan is not None:
        from rectpu_torch.parallel.sparse_ep import make_sparse_rows_ep

        if slot_dtype == "bfloat16_sr":
            raise ValueError("bf16 slots are not wired into the sharded row update yet")
        sharded_update = make_sparse_rows_ep(plan.mesh, batch_2d=plan.batch_2d, beta1=beta1,
                                             beta2=beta2, epsilon=epsilon,
                                             field_sizes=field_sizes)
    mv_dtype = torch.bfloat16 if slot_dtype == "bfloat16_sr" else None
    unpacked_linear = use_linear and not packed

    # {rectpu's sparse-tree name: flat parameter key}
    sparse_keys = {table_key: table_key, **({"w": _LINEAR_W} if unpacked_linear else {})}

    def rest_of(params: dict) -> dict:
        return {key: p for key, p in params.items() if key not in sparse_keys.values()}

    def init_opt_state(params: dict) -> dict:
        def mv0(leaf):
            w = leaf.shape[1] if leaf.dim() == 2 else 1
            wp = -(-w // 128) * 128 if (state_pad and leaf.dim() == 2) else w
            dt = mv_dtype if (mv_dtype is not None and leaf.dim() == 2) else leaf.dtype
            return torch.zeros(leaf.shape[0], 2 * wp, dtype=dt, device=leaf.device)

        rest = rest_of(params)
        return {"m": {"rest": {key: torch.zeros_like(p.detach()) for key, p in rest.items()}},
                "v": {"rest": {key: torch.zeros_like(p.detach()) for key, p in rest.items()}},
                "mv_sparse": {name: mv0(params[key].detach())
                              for name, key in sparse_keys.items()},
                "t": torch.zeros((), dtype=torch.int32)}

    def step(params: dict, opt_state: dict, batch: dict, scalars) -> torch.Tensor:
        if scalars is None or isinstance(scalars, int):  # a dropout seed32, or none
            scalars = StepScalars.after(opt_state, scalars)
        ids = batch["cat_ids"]
        dtype = cfg.torch_compute_dtype
        with torch.no_grad():
            if unpacked_linear:
                table = torch.cat([params["emb"], params[_LINEAR_W][:, None]], dim=1)
            else:
                table = params[table_key].detach()
            looked = plan.lookup_fn(table, ids) if ep else gather_rows(table, ids)
        looked.requires_grad_(True)
        rest = rest_of(params)
        lp = looked.to(dtype) if dtype is not None else looked
        logits = model.apply_looked(lp, batch.get("num_vals"), train=True,
                                    seed32=scalars.seed32)
        losses = metrics_lib.sigmoid_xent(logits, batch["labels"])
        if "weights" in batch:
            w = batch["weights"]
            w_sum = torch.sum(w) if plan is None else plan.global_value(torch.sum(w))
            loss = torch.sum(losses * w) / torch.clamp(w_sum, min=1.0)
        elif plan is not None:
            loss = plan.local_loss(losses, loss_reduction)
        elif loss_reduction == "sum":
            loss = losses.sum()
        else:
            loss = losses.mean()
        grads = torch.autograd.grad(loss, [looked, *rest.values()], allow_unused=True)
        dlooked = grads[0]
        if plan is not None:
            rest_grads = {key: torch.zeros_like(p) if g is None else g
                          for (key, p), g in zip(rest.items(), grads[1:])}
            plan.reduce_grads(rest_grads)
            grads = (dlooked, *rest_grads.values())

        t = scalars.t
        lr_t = scalars.lr_t(learning_rate, beta1, beta2)
        with torch.no_grad():
            # dense Adam on the small params
            for (key, p), g in zip(rest.items(), grads[1:]):
                g = torch.zeros_like(p) if g is None else g
                m, v = opt_state["m"]["rest"][key], opt_state["v"]["rest"][key]
                m_new = beta1 * m + (1 - beta1) * g
                v_new = beta2 * v + (1 - beta2) * g * g
                p.copy_(p - lr_t * m_new / (torch.sqrt(v_new) + epsilon))
                m.copy_(m_new)
                v.copy_(v_new)

            # lazy Adam on exactly the touched table rows (m|v packed per leaf)
            mv = opt_state["mv_sparse"]
            if sharded_update is not None:
                sharded_update(params[table_key].detach(), mv[table_key], ids, dlooked, lr_t)
                scalars.commit(opt_state)
                return loss.detach()
            cols = dlooked.shape[-1]
            cap = unique_capacity(field_sizes, ids.shape[0], ids.shape[0] * ids.shape[1])
            rows, row_grads = dedupe_rows(ids.reshape(-1),
                                          dlooked.reshape(-1, cols).float(),
                                          table.shape[0], num_out=cap)
            if not unpacked_linear:
                sparse_adam_rows_packed(params[table_key].detach(), mv[table_key], rows,
                                        row_grads, lr_t, beta1, beta2, epsilon,
                                        scatter_backend=scatter_backend, v_valid=v_valid,
                                        sr_seed=t)
            else:
                # rectpu's unpacked branch passes no scatter_backend (its "xla")
                sparse_adam_rows_packed(params["emb"].detach(), mv["emb"], rows,
                                        row_grads[:, :k], lr_t, beta1, beta2, epsilon)
                sparse_adam_rows_packed(params[_LINEAR_W].detach(), mv["w"], rows,
                                        row_grads[:, k], lr_t, beta1, beta2, epsilon)
        scalars.commit(opt_state)
        return loss.detach()

    return init_opt_state, step


# rectpu's historical name (``rectpu/train/fast_step.py:327``): the step was
# DeepFM-only before the zoo grew apply_looked
make_sparse_deepfm_step = make_sparse_step
