"""ParallelPlan: the glue between the Trainer and the mesh, the port of
``rectpu/parallel/plan.py``.

Every sharding decision, as in rectpu:

  - the batch: each rank takes its slice. Under EP in "2d" or "dedup" the
    batch is sharded over every rank (rank r takes slice r of B/(D*M),
    rectpu's ``P(('data', 'model'))``); otherwise over 'data' alone (slice d
    of B/D, the same on every model rank);
  - parameters: a 2-D leaf of ``table_rows`` rows (and its optimizer-state
    twins) keeps rows [m*V/M, (m+1)*V/M) on model index m under EP; every
    other leaf is replicated;
  - ``lookup_fn``: the EP exchange, with ``.flat_variant`` for the flat
    layout.

rectpu leaves the data-parallel gradient sum to GSPMD. Here it is explicit,
after backward (``reduce_grads``): the gradients of replicated leaves are
summed over the batch axes (every rank under 2d/dedup, 'data' under 1d and
plain data parallelism), each table shard's over 'data'. Each rank's loss
is its share of the global batch's loss (``local_loss``: its sum over the
global batch size under the mean reduction), so the summed gradient is the
single-process gradient of the global batch, not an average of means.

``tp_mlp``: rectpu's Megatron towers (``plan.py:140-184``). ``tp_spec`` is
rectpu's ``_tp_spec`` rule for the ``<tower>[i].{kernel,bias}`` leaves of
the ``mlp``, ``top`` and ``bot`` towers (and their optimizer-state twins,
matched by path suffix): even layers column-shard the kernel and the bias,
odd layers and the width-1 logit row-shard the kernel and replicate the
bias, a dim that 'model' does not divide stays replicated. It takes
precedence over the table rule, as in rectpu. ``shard_params`` records each
tower leaf's sharded dim, by path suffix, from the global tree it cuts;
``gather_params``, ``reduce_grads`` and the towers' forward
(``tower_parallel``, read by ``models/base.apply_mlp``) and ``sr_index`` (a
shard's place in its global array, which stochastic rounding keys on) read
that record.
rectpu leaves the towers' collectives to GSPMD; ``apply_mlp`` places them
explicitly. The towers run on the rows of a 'data' group: under 2d/dedup
each rank all_gathers the tower input over 'model' and keeps its own rows
of the output. So a tower leaf's gradient (a shard's, and a replicated
tower leaf's, which every model rank computes alike from the same rows) is
summed over 'data' alone; every other replicated leaf's over the batch
ranks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from rectpu_torch.parallel.collectives import raw_all_gather, raw_psum
from rectpu_torch.parallel.embedding_ep import (make_ep_lookup, make_ep_lookup_2d,
                                                make_ep_lookup_2d_flat, make_ep_lookup_dedup,
                                                make_ep_lookup_dedup_flat, make_ep_lookup_flat)
from rectpu_torch.parallel.mesh import MODEL_AXIS, Axis, Mesh, make_mesh
from rectpu_torch.utils.hash32 import GlobalIndex

SCATTER_IMPLS = ("xla", "mxu", "auto")


class _LocalRows(torch.autograd.Function):
    """Rows [m*V/M, (m+1)*V/M) of a replicated [V] leaf (the unpacked linear
    weight a fused table concatenates to its embedding shard). Its transpose
    pads the cotangent with zeros, and under 1d also sums it over 'model':
    the model ranks of a data row then hold the same whole-row gradient, as
    every replicated leaf's, before the sum over 'data'."""

    @staticmethod
    def forward(ctx, w, mi, v_shard, model, sum_model):
        ctx.meta = (mi, v_shard, w.shape[0], model, sum_model)
        return w[mi * v_shard:(mi + 1) * v_shard]

    @staticmethod
    def backward(ctx, g):
        mi, v_shard, rows, model, sum_model = ctx.meta
        full = g.new_zeros((rows, *g.shape[1:]))
        full[mi * v_shard:(mi + 1) * v_shard] = g
        if sum_model:
            full = raw_psum(full, model)
        return full, None, None, None, None


def _map_tree(tree, fn, path=()):
    """``fn(path, leaf)`` over a dict/list tree; ``path`` holds the dict keys
    and the list indices (ints) from the root, as JAX's key paths do."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


TP_TOWER_KEYS = frozenset({"mlp", "top", "bot"})


def key_path(key: str) -> tuple:
    """A ``/``-joined key path (``mlp/0/kernel``) as path keys, indices as ints."""
    return tuple(int(p) if p.isdigit() else p for p in key.split("/") if p)


def tower_suffix(path) -> tuple | None:
    """(tower, layer, "kernel" | "bias") of a ``<tower>[i].{kernel,bias}``
    leaf path (its last tower key followed by an index, rectpu's match), else
    None."""
    keys = list(path)
    if not keys or keys[-1] not in ("kernel", "bias"):
        return None
    found = None
    for j in range(len(keys) - 1):
        if keys[j] in TP_TOWER_KEYS and isinstance(keys[j + 1], int):
            found = (keys[j], keys[j + 1], keys[-1])
    return found


def tp_spec(path, leaf, num_model: int) -> tuple | None:
    """rectpu's ``ParallelPlan._tp_spec`` (``plan.py:140-176``) over
    ``num_model`` model shards, as the entries of its PartitionSpec:
    ``(None, "model")`` column-sharded, ``("model", None)`` row-sharded,
    ``("model",)`` a sharded bias, ``()`` replicated; None for a leaf that
    is not a tower kernel or bias."""
    suffix = tower_suffix(path)
    if suffix is None:
        return None
    _, layer, kind = suffix
    ndim = getattr(leaf, "ndim", 0)

    def fits(dim):
        return dim % num_model == 0

    if kind == "kernel" and ndim == 2:
        col = layer % 2 == 0 and leaf.shape[1] > 1
        if col and fits(leaf.shape[1]):
            return (None, MODEL_AXIS)
        if not col and fits(leaf.shape[0]):
            return (MODEL_AXIS, None)
        return ()
    if kind == "bias" and ndim == 1:
        if layer % 2 == 0 and leaf.shape[0] > 1 and fits(leaf.shape[0]):
            return (MODEL_AXIS,)
        return ()
    return None


def _sharded_dim(spec: tuple) -> int | None:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


@dataclass(frozen=True)
class TowerParallel:
    """A tower's tensor-parallel form for ``models/base.apply_mlp``: the
    'model' axis, whether its rows are gathered over 'model' first (the
    2d/dedup batch), and each layer's kernel dim sharded over 'model' (1
    column-parallel, 0 row-parallel, None replicated)."""

    axis: Axis
    gather_rows: bool
    kernel_dims: tuple


@dataclass
class ParallelPlan:
    mesh: Mesh
    ep: bool  # row-shard the table over 'model'
    lookup_fn: object | None
    table_rows: int | None = None  # the padded table row count, the EP key
    ep_mode: str = "2d"
    ep_comm_compress: str | None = None
    ep_peer_capacity: int | None = None
    tp_mlp: bool = False
    scatter_impl: str = "xla"
    # {(tower, layer, kind): the leaf's dim sharded over 'model', or None}
    tower_dims: dict = field(default_factory=dict)

    @classmethod
    def create(cls, num_data_shards: int, num_model_shards: int = 1, device="cpu",
               table_rows: int | None = None, ep_mode: str = "2d",
               ep_comm_compress: str | None = None, ep_peer_capacity: int | None = None,
               tp_mlp: bool = False, scatter_impl: str = "xla", mesh: Mesh | None = None):
        """rectpu's arguments, defaults and checks (``plan.py:64-112``);
        ``device`` ("cpu" or "cuda") and ``mesh`` (default ``make_mesh``
        over the process group) replace rectpu's ``devices``."""
        if scatter_impl not in SCATTER_IMPLS:
            raise ValueError(f"scatter_impl must be one of {SCATTER_IMPLS}")
        if scatter_impl == "auto":
            scatter_impl = "xla"  # rectpu's unpinned _FLAT_SCATTER_AUTO, resolved once
        if ep_peer_capacity is not None and ep_mode != "dedup":
            raise ValueError("ep_peer_capacity only applies to ep_mode='dedup'")
        if mesh is None:
            mesh = make_mesh(num_data_shards, num_model_shards, device)
        elif (mesh.num_data, mesh.num_model) != (num_data_shards, num_model_shards):
            raise ValueError(f"mesh {mesh.num_data}x{mesh.num_model} is not the plan's "
                             f"{num_data_shards}x{num_model_shards}")
        ep = num_model_shards > 1
        cc = ep_comm_compress
        if ep and table_rows is not None and table_rows % num_model_shards:
            raise ValueError(f"table_rows={table_rows} is not divisible by "
                             f"{num_model_shards} model shards")
        if not ep:
            lookup_fn = None
        elif ep_mode == "2d":
            lookup_fn = make_ep_lookup_2d(mesh, comm_compress=cc)
            lookup_fn.flat_variant = make_ep_lookup_2d_flat(mesh, comm_compress=cc,
                                                            scatter_impl=scatter_impl)
        elif ep_mode == "dedup":
            lookup_fn = make_ep_lookup_dedup(mesh, peer_capacity=ep_peer_capacity,
                                             comm_compress=cc, scatter_impl=scatter_impl)
            lookup_fn.flat_variant = make_ep_lookup_dedup_flat(
                mesh, peer_capacity=ep_peer_capacity, comm_compress=cc,
                scatter_impl=scatter_impl)
        else:
            if cc is not None:
                raise ValueError("ep_comm_compress requires ep_mode '2d' or 'dedup'")
            lookup_fn = make_ep_lookup(mesh)
            lookup_fn.flat_variant = make_ep_lookup_flat(mesh, scatter_impl=scatter_impl)
        if tp_mlp and num_model_shards <= 1:
            raise ValueError("tp_mlp requires num_model_shards > 1")
        plan = cls(mesh=mesh, ep=ep, lookup_fn=lookup_fn, table_rows=table_rows,
                   ep_mode=ep_mode, ep_comm_compress=ep_comm_compress,
                   ep_peer_capacity=ep_peer_capacity, tp_mlp=tp_mlp,
                   scatter_impl=scatter_impl)
        if lookup_fn is not None:
            lookup_fn.local_rows = plan.local_rows
        return plan

    # -- the batch ------------------------------------------------------------

    @property
    def batch_2d(self) -> bool:
        """The batch is sharded over every rank (2d/dedup EP)."""
        return self.ep and self.ep_mode in ("2d", "dedup")

    @property
    def batch_axis(self) -> Axis:
        """The ranks that hold distinct batch slices."""
        return self.mesh.world if self.batch_2d else self.mesh.data

    @property
    def batch_shards(self) -> int:
        return self.batch_axis.size

    @property
    def batch_index(self) -> int:
        """This rank's slice of the global batch."""
        return self.batch_axis.index

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch {name: [B, ...] array}, on its device."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
            n = v.shape[0] // self.batch_shards
            out[k] = v[self.batch_index * n:(self.batch_index + 1) * n].to(self.mesh.device)
        return out

    @property
    def process_index(self) -> int:
        return self.mesh.rank

    # -- parameters -----------------------------------------------------------

    def is_table_leaf(self, leaf, local: bool = False) -> bool:
        """rectpu's ``_param_spec`` rule: a 2-D leaf of ``table_rows`` rows
        (``local``: of this rank's V/M rows) is row-sharded under EP."""
        if not (self.ep and self.table_rows is not None):
            return False
        rows = self.table_rows // self.mesh.num_model if local else self.table_rows
        return getattr(leaf, "ndim", 0) == 2 and leaf.shape[0] == rows

    def _tower_dim(self, path) -> tuple[bool, int | None]:
        """(is a tower leaf under ``tp_mlp``, its sharded dim) from the
        record ``shard_params`` made of the global tree."""
        suffix = tower_suffix(path) if self.tp_mlp else None
        if suffix is None:
            return False, None
        if suffix not in self.tower_dims:
            raise KeyError(f"tower leaf {'/'.join(map(str, path))} was never cut by "
                           "shard_params, so its global layout is unknown")
        return True, self.tower_dims[suffix]

    def tower_parallel(self, tower: str) -> TowerParallel | None:
        """The tensor-parallel form of ``tower``'s layers (None without
        ``tp_mlp``)."""
        if not self.tp_mlp:
            return None
        n = 1 + max((layer for (t, layer, _) in self.tower_dims if t == tower), default=-1)
        if n == 0:
            raise KeyError(f"tower {tower!r} was never cut by shard_params")
        return TowerParallel(self.mesh.model, self.batch_2d,
                             tuple(self.tower_dims[(tower, i, "kernel")] for i in range(n)))

    def shard_params(self, tree):
        """This rank's view of a global tree (params or optimizer state):
        tower leaves cut by ``tp_spec`` (recorded for the gather), the
        table's rows by the table rule, everything else as it is."""
        mi, mn = self.mesh.model.index, self.mesh.num_model
        v_shard = (self.table_rows or 0) // mn

        def place(path, leaf):
            spec = tp_spec(path, leaf, mn) if self.tp_mlp else None
            if spec is not None:
                dim = _sharded_dim(spec)
                self.tower_dims[tower_suffix(path)] = dim
                if dim is None:
                    return leaf
                w = leaf.shape[dim] // mn
                return leaf[mi * w:(mi + 1) * w] if dim == 0 else leaf[:, mi * w:(mi + 1) * w]
            if self.is_table_leaf(leaf):
                return leaf[mi * v_shard:(mi + 1) * v_shard]
            return leaf

        return _map_tree(tree, place)

    def gather_params(self, tree):
        """The global tree from this rank's view: every table shard and
        tower shard all_gathered over 'model' (a collective: every rank
        calls it) on the rank's device, and returned where the shard was
        (host copies stay host copies)."""

        def gather(path, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            tower, dim = self._tower_dim(path)
            if tower and dim is None:
                return leaf
            if not tower and not self.is_table_leaf(leaf, local=True):
                return leaf
            x = leaf.detach().to(self.mesh.device)
            if dim == 1:
                full = raw_all_gather(x.t().contiguous(), self.mesh.model).t().contiguous()
            else:
                full = raw_all_gather(x.contiguous(), self.mesh.model)
            return full.to(leaf.device)

        return _map_tree(tree, gather)

    def sr_index(self, key: str, leaf) -> GlobalIndex | None:
        """Where this rank's ``leaf`` (the parameter, or its update, at the
        ``/``-joined key path ``key``) sits in its global array, so that
        stochastic rounding keys each element on rectpu's global flat index:
        a table shard's rows over 'model' and a tower leaf cut by rows start
        at a row offset, a tower kernel cut by columns at a column offset of
        the global width; None for a leaf every rank holds whole."""
        tower, dim = self._tower_dim(key_path(key))
        if tower:
            if dim is None:
                return None
        elif self.is_table_leaf(leaf, local=True):
            dim = 0
        else:
            return None
        mi, shape = self.mesh.model.index, tuple(leaf.shape)
        if dim == 1:
            return GlobalIndex(0, mi * shape[1], shape[1] * self.mesh.num_model)
        return GlobalIndex(mi * shape[0], 0, int(np.prod(shape[1:], dtype=np.int64)))

    def local_rows(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a replicated [V] leaf, differentiable (see
        ``_LocalRows``)."""
        v_shard = w.shape[0] // self.mesh.num_model
        return _LocalRows.apply(w, self.mesh.model.index, v_shard, self.mesh.model,
                                not self.batch_2d)

    # -- reductions ---------------------------------------------------------------

    def local_loss(self, losses: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
        """This rank's share of the global batch's loss: summed over the
        ranks of ``batch_axis``, the shares give the single-process loss."""
        if reduction == "sum":
            return losses.sum()
        return losses.sum() / (losses.shape[0] * self.batch_shards)

    def global_value(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a per-rank value (a loss share, a metric count) over the batch ranks."""
        return raw_psum(x, self.batch_axis)

    def reduce_grads(self, grads: dict, table_grad_dtype=None) -> dict:
        """Sum the gradients ({key path: tensor}) in place: table shards over
        'data', tower leaves under ``tp_mlp`` over 'data' (each is computed
        from its data group's rows), other leaves over the batch axes (one
        flat buffer a dtype and axis). Under EP a table shard's gradient is
        then rounded to ``table_grad_dtype`` and back, as the single-process
        lookup rounds its dense cotangent."""
        groups: dict = {}
        for key, g in grads.items():
            if self._tower_dim(key_path(key))[0]:
                groups.setdefault((self.mesh.data, g.dtype), []).append(g)
            elif self.is_table_leaf(g, local=True):
                g.copy_(raw_psum(g, self.mesh.data))
                if table_grad_dtype is not None:
                    g.copy_(g.to(table_grad_dtype).to(g.dtype))
            else:
                groups.setdefault((self.batch_axis, g.dtype), []).append(g)
        for (axis, _), gs in groups.items():
            if axis.size == 1:
                continue
            summed = raw_psum(torch.cat([g.reshape(-1) for g in gs]), axis)
            offset = 0
            for g in gs:
                g.copy_(summed[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        return grads

    def reduce_metric_state(self, state: dict) -> dict:
        """Metric accumulators summed over the batch ranks."""
        return {k: self.global_value(v) for k, v in state.items()}

    def gather_batch_values(self, x: torch.Tensor) -> torch.Tensor:
        """Every batch rank's [n] values, concatenated (n equal on every rank)."""
        return raw_all_gather(x.contiguous(), self.batch_axis)

    def agree(self, flag: bool) -> bool:
        """Rank 0's decision, on every rank (the wall-clock checkpoint cadence)."""
        if self.mesh.world.size == 1:
            return flag
        mine = float(flag) if self.mesh.rank == 0 else 0.0
        return bool(raw_psum(torch.tensor([mine], device=self.mesh.device),
                             self.mesh.world).item() > 0)

    def barrier(self) -> None:
        if self.mesh.world.size > 1:
            dist.barrier()
