"""Model building blocks for inference: the port of ``rectpu/models/base.py``.

``TowerConfig`` keeps every field of rectpu's, so an export's ``model.json``
parses unchanged; the fields that only steer the TPU's training step
(``split_threshold``, ``flat_layout``, ``scatter_impl``, ...) are carried and
not read here. ``apply_mlp`` is the inference forward (dropout is never on
the serving path) with rectpu's ``compute_dtype`` casts; the matmuls are
``torch.matmul``, as rectpu left them to XLA. The init helpers take an
explicit ``torch.Generator`` and follow rectpu's (TF's) initializers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from rectpu_torch.features.schema import FeatureSet
from rectpu_torch.ops.embedding import lookup


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


def _dot(x: torch.Tensor, kernel: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``jnp.dot(x, kernel, preferred_element_type=float32).astype(out_dtype)``.

    Same-typed bf16 operands go to one bf16 matmul, which accumulates in fp32
    and rounds once (with ``resolve_device``'s settings on the card); any
    other mix runs in fp32, where products of bf16 values are exact."""
    if x.dtype == kernel.dtype == out_dtype:
        return torch.matmul(x, kernel)
    return torch.matmul(x.float(), kernel.float()).to(out_dtype)


def apply_mlp(layers, x: torch.Tensor, activation, compute_dtype=None) -> torch.Tensor:
    """Inference forward through the hidden layers, then the linear logit.

    ``layers`` is a list of (kernel [in, out], bias [out]). Mirrors rectpu's
    casts (``rectpu/models/base.py:138-176``): under a compute dtype, x,
    the kernels and the hidden biases take it, each hidden matmul
    accumulates in fp32 and is rounded to x's dtype before the bias add, and
    the logit layer accumulates in fp32 and adds its bias in fp32. Returns
    [B, out] fp32."""
    act = get_activation(activation)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for kernel, bias in layers[:-1]:
        if compute_dtype is not None:
            kernel = kernel.to(compute_dtype)
            bias = bias.to(compute_dtype)
        x = act(_dot(x, kernel, x.dtype) + bias)
    kernel, bias = layers[-1]
    if compute_dtype is not None:
        kernel = kernel.to(compute_dtype)
    return (_dot(x, kernel, torch.float32) + bias.float()).float()


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


def pack_fused_table(emb: torch.Tensor, w: torch.Tensor, pad_cols: int = 0) -> torch.Tensor:
    """[V, K+1(+pad)] = [embedding | linear weight | zero pad], the packed
    single-table layout of ``rectpu/models/base.py:294``."""
    t = torch.cat([emb, w.reshape(-1, 1).to(emb.dtype)], dim=1)
    if pad_cols:
        wp = -(-t.shape[1] // pad_cols) * pad_cols
        t = F.pad(t, (0, wp - t.shape[1]))
    return t


def lookup_fields(table: torch.Tensor, cat_ids: torch.Tensor, cfg: TowerConfig) -> torch.Tensor:
    """[B, F] ids -> [B, F, W] field rows, in the compute dtype when one is set
    (the served table is already stored in it: casting the table once at load
    is elementwise the same as rectpu's cast before each gather)."""
    emb = lookup(table, cat_ids, impl=cfg.embedding_impl)
    dtype = cfg.torch_compute_dtype
    return emb.to(dtype) if dtype is not None else emb


def numeric_field_embeddings(num_emb: torch.Tensor, num_vals: torch.Tensor) -> torch.Tensor:
    """Numeric-feature embedding trick (reference deep_fm.py:60-69):
    value * learned vector -> [B, N, K]."""
    return num_vals.to(num_emb.dtype)[:, :, None] * num_emb
