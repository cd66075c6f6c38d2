"""DNN CTR model: the port of ``rectpu/models/dnn.py``.

``tf.estimator.DNNClassifier`` over embedding columns (reference
trainers/deep.py:32-38): the per-field embeddings (and value x vector for
each numeric field) are concatenated and fed through a dense stack with
dropout, Adagrad(0.05) by default (the canned estimator's default). Its
parameter tree is rectpu's ``{"emb": [V_pad, K], "mlp": [...], ["num_emb":
[1, N, K]]}``.

rectpu's flat layout (``cfg.flat_layout`` without numeric fields) feeds the
lane-packed [B, F*K] gather of ``lookup_flat`` straight to the MLP; that
layout is the TPU's, and the port computes the same values from the
[B, F, K] gather, so one path serves both.
"""

from __future__ import annotations

import torch

from rectpu_torch.models.base import (
    RecModel,
    TowerConfig,
    apply_mlp,
    init_embedding_table,
    init_mlp,
    lookup_fields,
    numeric_field_embeddings,
    truncated_normal,
)


def append_numeric(model, emb: torch.Tensor, num_vals: torch.Tensor | None) -> torch.Tensor:
    """[B, F, K] field rows -> [B, F+N, K]: each numeric field's value x its
    ``num_emb`` vector appended (none without numeric fields)."""
    if not model.cfg.num_numeric:
        return emb
    num = numeric_field_embeddings(model.num_emb, num_vals)
    return torch.cat([emb, num.to(emb.dtype)], dim=1)


def deep_tower_logit(model, emb: torch.Tensor, num_vals: torch.Tensor | None, train: bool,
                     seed32) -> torch.Tensor:
    """The DNN tower of ``model`` (its ``mlp`` and, with numeric fields, its
    ``num_emb``) over [B, F, K] field rows -> [B] fp32 (rectpu's
    ``apply_looked`` math)."""
    cfg = model.cfg
    emb = append_numeric(model, emb, num_vals)
    layers = [(layer["kernel"], layer["bias"]) for layer in model.mlp]
    return apply_mlp(layers, emb.reshape(emb.shape[0], -1), cfg.activation,
                     compute_dtype=cfg.torch_compute_dtype, dropout=cfg.dropout,
                     train=train, seed32=seed32, dropout_impl=cfg.dropout_impl,
                     row_offset=model.row_offset, tp=model.tower_tp("mlp"))[:, 0]


def init_dnn(generator: torch.Generator, cfg: TowerConfig) -> dict:
    """A fresh DNN tree in rectpu's layout: truncated-normal embeddings
    (stddev 1/sqrt(K)), glorot-uniform kernels, zero biases."""
    k = cfg.embedding_size
    params = {"emb": init_embedding_table(generator, cfg),
              "mlp": init_mlp(generator, (cfg.num_fields + cfg.num_numeric) * k,
                              cfg.hidden_units)}
    if cfg.num_numeric:
        params["num_emb"] = truncated_normal(generator, (1, cfg.num_numeric, k), k ** -0.5)
    return params


class DNNModel(RecModel):
    name = "deep"
    EXPORT_KWARGS = ()

    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: torch.Generator) -> dict:
        return init_dnn(generator, self.cfg)

    def input_layer(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None) -> torch.Tensor:
        """[B, F(+N), K] field rows: the gather, then the numeric fields' rows."""
        return append_numeric(self, lookup_fields(self.emb, cat_ids, self.cfg, self.lookup_fn),
                              num_vals)

    def apply_looked(self, looked: torch.Tensor, num_vals: torch.Tensor | None, *,
                     train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """Tower math from gathered [B, F, K] rows (the sparse fast step's hook)."""
        return deep_tower_logit(self, looked, num_vals, train, seed32)

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None, *,
                train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """cat_ids [B, F] int32 global row ids, num_vals [B, N] -> logits [B]
        fp32. ``train`` turns dropout on, seeded by ``seed32``."""
        looked = lookup_fields(self.emb, cat_ids, self.cfg, self.lookup_fn)
        return deep_tower_logit(self, looked, num_vals, train, seed32)

    def default_optimizer(self):
        """TF DNNClassifier's default: Adagrad(lr=0.05)."""
        from rectpu_torch.train.optimizers import adagrad

        return adagrad(learning_rate=0.05)
