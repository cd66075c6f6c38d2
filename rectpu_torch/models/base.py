"""Model building blocks: the port of ``rectpu/models/base.py``.

``TowerConfig`` keeps every field of rectpu's, so an export's ``model.json``
parses unchanged; the fields that only pick a TPU layout or kernel
(``split_threshold``, ``scatter_impl``, ``mxu_dense_threshold``, ...) are
carried and change nothing here: the port has one lookup and one scatter.
``apply_mlp`` is the tower with rectpu's ``compute_dtype`` casts and, in
train mode, dropout from ``hash_dropout_mask`` (bit for bit rectpu's) or from
a ``torch.Generator`` (the "threefry" impl: a different but equally valid
Bernoulli stream, since JAX's threefry has no PyTorch twin). The matmuls are
``torch.matmul``, as rectpu left them to XLA. The init helpers take an
explicit ``torch.Generator`` and follow rectpu's (TF's) initializers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from rectpu_torch.features.schema import FeatureSet
from rectpu_torch.ops.embedding import dequant_gather, lookup
from rectpu_torch.utils.hash32 import MASK32, counter_hash, flat_index, mul32, mul_u32


def truncated_normal(generator: torch.Generator, shape, stddev: float) -> torch.Tensor:
    """Normal truncated at 2 sigma (TF truncated_normal_initializer), by the
    inverse CDF of a uniform draw."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (stddev * z.clamp(-2.0, 2.0)).float()


def glorot_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


_ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default form
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,  # slope 0.01, as jax.nn.leaky_relu
}


def get_activation(name):
    if callable(name):
        return name
    return _ACTIVATIONS[name]


def init_mlp(generator: torch.Generator, in_dim: int, hidden_units, out_dim: int = 1):
    """Hidden dense stack + final logit layer, in rectpu's tree layout:
    [{"kernel": [in, out], "bias": [out]}, ...]."""
    dims = [in_dim] + list(hidden_units) + [out_dim]
    return [
        {"kernel": glorot_uniform(generator, (dims[i], dims[i + 1])),
         "bias": torch.zeros(dims[i + 1])}
        for i in range(len(dims) - 1)
    ]


def hash_dropout_mask(seed32, shape, rate: float, device=None,
                      row_offset: int = 0) -> torch.Tensor:
    """Counter-hash Bernoulli(1 - rate) keep mask, bit for bit rectpu's
    (``rectpu/models/base.py:72-135``): for an even last width one hash per
    two elements, its low 16 bits for columns [0, last/2) and its high 16
    bits for [last/2, last), each against a 16-bit threshold; for an odd last
    width one hash per element with the murmur finalizer and a 32-bit
    threshold.

    ``row_offset``: ``shape`` is rows [row_offset, row_offset + shape[0]) of
    the global batch, and the hashes key on the global element index, so a
    rank's slice gets the rows of the global mask (rectpu masks the global
    array under GSPMD).

    ``seed32`` is a Python int or a 0-d int64 tensor on ``device`` holding
    the same uint32 value (a step that reads its scalars on the device);
    both give the same bits."""
    shape = tuple(int(d) for d in shape)
    if rate <= 0.0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    keep_p = 1.0 - rate
    last = shape[-1] if shape else 0
    if len(shape) >= 1 and last % 2 == 0 and last > 0:
        hashed = shape[:-1] + (last // 2,)
        start = row_offset * (math.prod(hashed[1:]) if len(hashed) > 1 else 1)
        h = counter_hash(flat_index(hashed, device, start), seed32)
        thresh = max(1, min(0xFFFF, int(round(keep_p * 65536.0))))
        return torch.cat([(h & 0xFFFF) < thresh, (h >> 16) < thresh], dim=-1)
    start = row_offset * (math.prod(shape[1:]) if len(shape) > 1 else 1)
    h = counter_hash(flat_index(shape, device, start), seed32)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    thresh = min(0xFFFFFFFF, int(round(keep_p * 4294967296.0)))
    return h < thresh


def step_seed32(seed: int, step: int) -> int:
    """The dropout seed of one train step. rectpu draws it with
    ``jax.random.bits(fold_in(PRNGKey(seed), step))`` (base.py:150), which has
    no PyTorch twin; the port mixes (seed, step) with its own counter hash, so
    a step's masks are a function of the run's seed and the step alone (a
    restored run draws the same masks): the murmur3 finalizer over a counter
    mix of the two."""
    h = (seed * 0x9E3779B9 + step * 2654435761 + 0x7F4A7C15) & MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def tower_seed32(seed32, salt: int):
    """The dropout seed of one tower of a model with several (DLRM's top
    MLP): rectpu folds a salt into the step's key (``fold_in(rng, 2)``,
    ``rectpu/models/dlrm.py:164``); the port mixes the salt into the step's
    seed32 with the murmur3 finalizer. None stays None (no dropout seed); a
    ``DeviceSeed`` gives a ``DeviceSeed``."""
    if seed32 is None:
        return None
    if isinstance(seed32, DeviceSeed):
        return seed32.map(lambda s: tower_seed32(s, salt))
    h = (seed32 ^ ((salt * 0x9E3779B9) & MASK32)) & MASK32
    h ^= h >> 16
    h = mul_u32(h, 0x85EBCA6B)
    h ^= h >> 13
    h = mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _layer_seed(seed32, i: int):
    """rectpu's per-layer salt: seed32 + 0x7FEB352D * (i + 1) in uint32 (base.py:164-165)."""
    if isinstance(seed32, DeviceSeed):
        return seed32.map(lambda s: _layer_seed(s, i))
    return (seed32 + 0x7FEB352D * (i + 1)) & MASK32


class ThreefrySites:
    """The threefry dropout generators of a step whose seed lives on the
    device (``DeviceSeed``): one ``torch.Generator`` per dropout call of the
    step, in call order, kept across steps. ``begin(seed32)`` reseeds each
    with its call's seed for the step's host seed32, which is what a fresh
    ``Generator(...).manual_seed(seed)`` per call (the host path) draws
    from; a CUDA graph that registered the generators replays its draws from
    the seeds set this way. A call first seen is seeded when it is made, and
    none may appear once ``frozen`` (a graph holds the sites)."""

    def __init__(self):
        self.sites: list = []  # (generator, host function of the step's seed32)
        self.frozen = False
        self._seed32 = 0
        self._next = 0

    def begin(self, seed32: int) -> None:
        self._seed32, self._next = seed32, 0
        for gen, host in self.sites:
            gen.manual_seed(host(seed32))

    def reseed(self) -> None:
        """Seed the generators again for the current step."""
        self.begin(self._seed32)

    def generator(self, device, host) -> torch.Generator:
        i = self._next
        self._next += 1
        if i == len(self.sites):
            if self.frozen:
                raise RuntimeError("a threefry dropout call appeared after the step's CUDA "
                                   "graph was captured")
            gen = torch.Generator(device=device)
            gen.manual_seed(host(self._seed32))
            self.sites.append((gen, host))
        return self.sites[i][0]


class DeviceSeed:
    """A step's dropout seed read on the device: ``value``, the 0-d int64
    tensor holding the uint32 seed that the hash masks take, and ``host``,
    the same value as a function of the step's host seed32, from which a
    threefry call's generator (``sites``) is seeded. ``map`` applies a seed
    function (``_layer_seed``, ``tower_seed32``) to both."""

    def __init__(self, value: torch.Tensor, host, sites: ThreefrySites):
        self.value, self.host, self.sites = value, host, sites

    def map(self, fn) -> DeviceSeed:
        host = self.host
        return DeviceSeed(fn(self.value), lambda s: fn(host(s)), self.sites)


def _dot(x: torch.Tensor, kernel: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``jnp.dot(x, kernel, preferred_element_type=float32).astype(out_dtype)``.

    Same-typed bf16 operands go to one bf16 matmul, which accumulates in fp32
    and rounds once (with ``resolve_device``'s settings on the card); any
    other mix runs in fp32, where products of bf16 values are exact."""
    if x.dtype == kernel.dtype == out_dtype:
        return torch.matmul(x, kernel)
    return torch.matmul(x.float(), kernel.float()).to(out_dtype)


def _dropout(x: torch.Tensor, dropout: float, salt: int, dropout_impl: str, row_offset: int,
             columns=None) -> torch.Tensor:
    """x / (1 - rate) where the keep mask keeps, else 0, in x's dtype.
    ``columns`` (first, width): x holds those columns of the global
    activation; the mask of all of its columns is drawn and those kept, so a
    column shard's mask is the global mask's columns."""
    shape = tuple(x.shape)
    if columns is not None:
        shape = shape[:-1] + (columns[1],)
    if dropout_impl == "hash":
        seed = salt.value if isinstance(salt, DeviceSeed) else salt
        keep = hash_dropout_mask(seed, shape, dropout, device=x.device, row_offset=row_offset)
    else:
        if isinstance(salt, DeviceSeed):
            host = salt.host
            gen = salt.sites.generator(
                x.device, lambda s: (host(s) + 0x9E3779B9 * row_offset) & MASK32)
        else:
            gen = torch.Generator(device=x.device).manual_seed(
                (salt + 0x9E3779B9 * row_offset) & MASK32)
        keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - dropout
    if columns is not None:
        keep = keep[..., columns[0]:columns[0] + x.shape[-1]]
    scale = torch.full((), 1.0 - dropout, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def apply_mlp(layers, x: torch.Tensor, activation, compute_dtype=None, *,
              dropout: float = 0.0, train: bool = False, seed32: int | None = None,
              dropout_impl: str = "threefry", row_offset: int = 0, tp=None) -> torch.Tensor:
    """Forward through the hidden layers (activation, then dropout in train
    mode), then the linear logit.

    ``layers`` is a list of (kernel [in, out], bias [out]). Mirrors rectpu's
    casts (``rectpu/models/base.py:138-176``): under a compute dtype, x,
    the kernels and the hidden biases take it, each hidden matmul
    accumulates in fp32 and is rounded to x's dtype before the bias add, and
    the logit layer accumulates in fp32 and adds its bias in fp32. Dropout
    keeps x / (1 - rate) where the mask keeps, in x's dtype (the rate meets x
    as JAX's weak type). ``seed32`` (``step_seed32``) seeds both dropout
    impls: "hash" through ``hash_dropout_mask`` with rectpu's per-layer salt,
    "threefry" through a ``torch.Generator`` seeded with the same salted
    value. A ``DeviceSeed`` (a step that reads its scalars on the device)
    gives the same masks: the hash takes its tensor, threefry the
    generators of its ``ThreefrySites``. ``row_offset`` is the first global
    batch row of ``x`` (a rank's slice under a ParallelPlan): the hash mask
    keys on global rows, and the threefry stream is salted with it (0 leaves
    it as it is). ``tp`` (a ``parallel.plan.TowerParallel``) runs the tower
    tensor-parallel (``_apply_mlp_tp``). Returns [B, out] fp32."""
    if tp is not None:
        return _apply_mlp_tp(layers, x, activation, compute_dtype, dropout, train, seed32,
                             dropout_impl, row_offset, tp)
    act = get_activation(activation)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    drop = dropout > 0 and train
    if drop and seed32 is None:
        raise ValueError("dropout requires a seed32 in train mode")
    for i, (kernel, bias) in enumerate(layers[:-1]):
        if compute_dtype is not None:
            kernel = kernel.to(compute_dtype)
            bias = bias.to(compute_dtype)
        x = act(_dot(x, kernel, x.dtype) + bias)
        if drop:
            x = _dropout(x, dropout, _layer_seed(seed32, i), dropout_impl, row_offset)
    kernel, bias = layers[-1]
    if compute_dtype is not None:
        kernel = kernel.to(compute_dtype)
    return (_dot(x, kernel, torch.float32) + bias.float()).float()


def _apply_mlp_tp(layers, x, activation, compute_dtype, dropout, train, seed32, dropout_impl,
                  row_offset, tp) -> torch.Tensor:
    """``apply_mlp`` with its kernels sharded over 'model' by rectpu's
    ``_tp_spec`` (``tp.kernel_dims``), the collectives that GSPMD places in
    rectpu placed here (Megatron's pairs):

      - a column-parallel layer (kernel [in, out/M], bias [out/M]) takes the
        input every model rank holds through ``pvary`` and gives this rank's
        columns;
      - a row-parallel layer (kernel [in/M, out], bias whole) takes this
        rank's columns (``local_columns`` converts a value every rank holds),
        sums its fp32 partial products over 'model' (``psum``), rounds once
        to the layer's type and adds the bias after the sum, as ``_dot``
        rounds the unsharded product;
      - a replicated layer (a dim 'model' does not divide) runs as unsharded;
      - a column-parallel last layer's output is all_gathered on its columns.

    The tower runs on the rows of the rank's 'data' group. Under the 2d and
    dedup exchanges the model ranks of a group hold different rows (rank r
    at (r // M, r % M), so the group's rows are contiguous): the input is
    all_gathered over 'model' first, the mask rows start at the group's
    first row, and the rank keeps its own rows of the output through
    ``own_rows``, whose transpose all_gathers the row cotangents, so each
    weight gradient sees every row of the group. When the first layer is
    column-parallel its input cotangents are the ranks' shares, and the
    gather's transpose (``psum_scatter``) sums them, in place of ``pvary``.
    A column-sharded hidden layer's dropout mask is the global mask's
    columns."""
    from rectpu_torch.parallel import collectives as coll

    act = get_activation(activation)
    axis = tp.axis
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    drop = dropout > 0 and train
    if drop and seed32 is None:
        raise ValueError("dropout requires a seed32 in train mode")
    first_col = tp.kernel_dims[0] == 1
    if tp.gather_rows:
        row_offset -= axis.index * x.shape[0]
        x = coll.all_gather(x, axis) if first_col else coll.gather_rows(x, axis)
    sharded = False  # x holds this rank's columns (else every rank holds it whole)
    last = len(layers) - 1
    for i, ((kernel, bias), dim) in enumerate(zip(layers, tp.kernel_dims)):
        if compute_dtype is not None:
            kernel = kernel.to(compute_dtype)
            if i < last:
                bias = bias.to(compute_dtype)
        out_dtype = torch.float32 if i == last else x.dtype
        if dim == 0:
            if not sharded:
                x = coll.local_columns(x, axis)
            part = torch.matmul(x.float(), kernel.float())
            y = coll.psum(part, axis).to(out_dtype)
            sharded = False
        else:
            if sharded:
                raise AssertionError("a column shard feeds a layer that is not row-parallel")
            if dim == 1 and not (i == 0 and tp.gather_rows):
                x = coll.pvary(x, axis)
            y = _dot(x, kernel, out_dtype)
            sharded = dim == 1
        if i == last:
            x = y + bias.float()
            break
        x = act(y + bias)
        if drop:
            cols = (axis.index * x.shape[-1], x.shape[-1] * axis.size) if sharded else None
            x = _dropout(x, dropout, _layer_seed(seed32, i), dropout_impl, row_offset, cols)
    if sharded:  # a last layer wider than 1 (DLRM's bottom MLP) may be column-parallel
        x = coll.gather_columns(x, axis)
    if tp.gather_rows:
        x = coll.own_rows(x, axis)
    return x.float()


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: None}


@dataclass
class TowerConfig:
    """Common knobs shared by the model zoo (same fields as rectpu's)."""

    feature_set: FeatureSet
    embedding_size: int = 4
    hidden_units: tuple = (16, 16)
    activation: str = "relu"
    dropout: float = 0.0
    embedding_impl: str = "auto"
    fm_impl: str = "auto"
    compute_dtype: str | None = None  # e.g. "bfloat16" for the towers
    table_padding: int = 128
    fuse_linear_lookup: bool = True
    packed_linear: bool = False
    packed_col_pad: int = 0
    table_grad_dtype: str | None = None
    table_dtype: str = "float32"
    split_threshold: int = 4096
    flat_layout: bool = False
    scatter_impl: str = "xla"
    mxu_dense_threshold: int = 16384
    dropout_impl: str = "threefry"

    @property
    def num_fields(self) -> int:
        return self.feature_set.num_fields

    @property
    def num_numeric(self) -> int:
        return self.feature_set.num_numeric

    @property
    def padded_buckets(self) -> int:
        v = self.feature_set.total_buckets
        p = self.table_padding
        return (v + p - 1) // p * p

    @property
    def torch_compute_dtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def torch_table_dtype(self):
        return _DTYPES[self.table_dtype]

    @property
    def torch_table_grad_dtype(self):
        return _DTYPES[self.table_grad_dtype]


def init_linear_tower(cfg: TowerConfig) -> dict:
    """Zero per-bucket weights ``w`` [V_pad] and bias ``b``, and zero ``w_num``
    [N] when there are numeric fields (TF linear_model; rectpu's
    ``init_linear_tower``, base.py:274-283)."""
    tower = {"w": torch.zeros(cfg.padded_buckets), "b": torch.zeros(())}
    if cfg.num_numeric:
        tower["w_num"] = torch.zeros(cfg.num_numeric)
    return tower


def init_embedding_table(generator: torch.Generator, cfg: TowerConfig) -> torch.Tensor:
    """[V_pad, K] truncated normal with stddev 1/sqrt(K) (TF embedding_column),
    stored in cfg.table_dtype (rectpu's ``init_embedding_table``, base.py:315)."""
    k = cfg.embedding_size
    return truncated_normal(generator, (cfg.padded_buckets, k), k ** -0.5).to(
        cfg.torch_table_dtype)


def pack_fused_table(emb: torch.Tensor, w: torch.Tensor, pad_cols: int = 0) -> torch.Tensor:
    """[V, K+1(+pad)] = [embedding | linear weight | zero pad], the packed
    single-table layout of ``rectpu/models/base.py:294``."""
    t = torch.cat([emb, w.reshape(-1, 1).to(emb.dtype)], dim=1)
    if pad_cols:
        wp = -(-t.shape[1] // pad_cols) * pad_cols
        t = F.pad(t, (0, wp - t.shape[1]))
    return t


def is_quantized(table) -> bool:
    """A quantized table leaf (``serve/quant.py``): {"q": int8 [V, W], "s": fp32 [V]}."""
    return isinstance(table, (dict, torch.nn.ParameterDict)) and "q" in table and "s" in table


class RecModel(nn.Module):
    """Base of the model zoo: the hooks a ``parallel.ParallelPlan`` sets.

    ``lookup_fn`` (None: the local gather) replaces the table gather with the
    plan's EP exchange, as rectpu's ``apply(..., lookup_fn=...)``; its
    ``flat_variant`` serves the flat layout. ``row_offset`` is the first
    global batch row of this rank's slice, which the dropout masks key on.
    ``tp_plan`` (a plan with ``tp_mlp``) runs the towers tensor-parallel
    (``tower_tp``)."""

    lookup_fn = None
    row_offset = 0
    tp_plan = None

    def tower_tp(self, tower: str):
        """The tensor-parallel form of tower ``tower`` (``mlp``, ``top`` or
        ``bot``) under a plan with ``tp_mlp``, else None."""
        return None if self.tp_plan is None else self.tp_plan.tower_parallel(tower)

    def ep_table(self, emb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """[V, K+1] = [emb | w] (``pack_fused_table``), assembled per call;
        under EP ``emb`` is this rank's shard and ``w`` (replicated) gives
        its rows of the shard."""
        if self.lookup_fn is not None:
            w = self.lookup_fn.local_rows(w)
        return pack_fused_table(emb, w)

    def flat_lookup(self, table, cat_ids: torch.Tensor, has_lin: bool):
        """The flat layout's rows from ``table`` [V, K(+1)]: (emb [B, F, K]
        in the compute dtype, lin [B] fp32 or None). Under EP the plan's flat
        exchange, else the local gather, whose lin sums column K over the
        fields in fp32."""
        cfg = self.cfg
        k = cfg.embedding_size
        if self.lookup_fn is not None:
            emb_flat, lin = self.lookup_fn.flat_variant(table, cat_ids, has_lin=has_lin)
            emb = emb_flat.reshape(emb_flat.shape[0], -1, k)
            dtype = cfg.torch_compute_dtype
            return (emb.to(dtype) if dtype is not None else emb), lin
        looked = lookup_fields(table, cat_ids, cfg)
        return looked[..., :k], (looked[..., k].float().sum(dim=-1) if has_lin else None)


def lookup_fields(table, cat_ids: torch.Tensor, cfg: TowerConfig,
                  lookup_fn=None) -> torch.Tensor:
    """[B, F] ids -> [B, F, W] field rows, in the compute dtype when one is
    set: the table is cast to it before the gather (``gather_dtype``,
    ``rectpu/ops/embedding.py:501``), and the dense table cotangent is rounded
    to ``table_grad_dtype`` before its cast back to the table's dtype.

    A quantized table leaf takes the gather's int8 mode (``dequant_gather``):
    rectpu's ``lookup_fn=dequant_lookup`` then the cast to the compute dtype
    (``rectpu/models/base.py:324-337``), serving only.

    ``lookup_fn`` (a plan's EP exchange) gathers instead, from the table in
    its own dtype, and the rows are then cast, as rectpu's ``lookup_fields``."""
    dtype = cfg.torch_compute_dtype
    if lookup_fn is not None:
        emb = lookup_fn(table, cat_ids)
        return emb.to(dtype) if dtype is not None else emb
    if is_quantized(table):
        return dequant_gather(table["q"], table["s"], cat_ids, dtype or torch.float32)
    emb = lookup(table, cat_ids, impl=cfg.embedding_impl, gather_dtype=dtype,
                 grad_dtype=cfg.torch_table_grad_dtype)
    return emb.to(dtype) if dtype is not None else emb


def linear_tower_logit(linear, cat_ids: torch.Tensor, num_vals: torch.Tensor | None,
                       impl: str = "auto") -> torch.Tensor:
    """rectpu's ``apply_linear_tower`` (base.py:286-291): sum_f w[id] + b
    (+ num_vals . w_num) -> [B] fp32, the [V] weight gathered as a [V, 1]
    table by the lookup (rectpu's ``jnp.take``; on the card the gather
    kernel, whose backward is the scatter)."""
    lin = lookup(linear["w"].reshape(-1, 1), cat_ids, impl=impl)[..., 0].sum(dim=1)
    lin = lin + linear["b"]
    if "w_num" in linear and num_vals is not None:
        lin = lin + num_vals.float() @ linear["w_num"]
    return lin


def numeric_field_embeddings(num_emb: torch.Tensor, num_vals: torch.Tensor) -> torch.Tensor:
    """Numeric-feature embedding trick (reference deep_fm.py:60-69):
    value * learned vector -> [B, N, K]."""
    return num_vals.to(num_emb.dtype)[:, :, None] * num_emb
