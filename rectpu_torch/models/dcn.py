"""DCN-v2: the port of ``rectpu/models/dcn.py`` (Wang et al., arXiv:2008.13535).

    x0      = flat embedding vector                 [B, D], D = (F+N)*K
    x_{l+1} = x0 * (W_l x_l + b_l) + x_l            (cross layers)
    logit   = top MLP(x_L)                          (stacked structure)

The weights are ``nn.Parameter``s named after rectpu's leaves: ``emb``
[V, K], ``cross.<i>.w`` [D, D] (or ``cross.<i>.u`` / ``cross.<i>.v`` [D, r]
with ``low_rank``) and ``cross.<i>.b`` [D], ``top.<i>.kernel`` /
``top.<i>.bias`` and, with numeric fields, ``num_emb`` [1, N, K]
(``rectpu_torch.convert`` carries the tree). Adam(1e-3) by default.

A cross layer keeps rectpu's rounding (``dcn.py:86-98``): the weight is cast
to x's dtype, the product accumulates in fp32, the fp32 bias is added, and
the sum is rounded to x's dtype once; ``x0 * xw + x`` runs in x's dtype. The
low-rank form rounds ``x V`` to x's dtype before its product with U^T. Under
a bf16 compute dtype each product is therefore an fp32 matmul of bf16
values (``models.base._dot``), whose products are exact.

rectpu's flat layout (``cfg.flat_layout`` without numeric fields) takes x0
straight from the lane-packed [B, F*K] gather of ``lookup_flat``; that layout
is the TPU's, and the port reshapes the [B, F, K] gather, which holds the same
values, so one path serves both.
"""

from __future__ import annotations

import torch

from rectpu_torch.models.base import (
    RecModel,
    TowerConfig,
    _dot,
    apply_mlp,
    glorot_uniform,
    init_embedding_table,
    init_mlp,
    lookup_fields,
    truncated_normal,
)
from rectpu_torch.models.dnn import append_numeric


class DCNModel(RecModel):
    name = "dcn"
    EXPORT_KWARGS = ("num_cross_layers", "low_rank")

    def __init__(self, cfg: TowerConfig, num_cross_layers: int = 3,
                 low_rank: int | None = None):
        super().__init__()
        if cfg.num_fields + cfg.num_numeric == 0:
            raise ValueError("DCN needs at least one feature column")
        if num_cross_layers < 1:
            raise ValueError("num_cross_layers must be >= 1")
        self.cfg = cfg
        self.num_cross_layers = int(num_cross_layers)
        self.low_rank = None if low_rank is None else int(low_rank)

    @property
    def d(self) -> int:
        return (self.cfg.num_fields + self.cfg.num_numeric) * self.cfg.embedding_size

    def init(self, generator: torch.Generator) -> dict:
        """A fresh tree in rectpu's layout: a truncated-normal table (stddev
        1/sqrt(K)), glorot-uniform cross weights and top tower, zero biases."""
        cfg, d, k = self.cfg, self.d, self.cfg.embedding_size
        cross = []
        for _ in range(self.num_cross_layers):
            if self.low_rank is None:
                layer = {"w": glorot_uniform(generator, (d, d))}
            else:
                layer = {"u": glorot_uniform(generator, (d, self.low_rank)),
                         "v": glorot_uniform(generator, (d, self.low_rank))}
            layer["b"] = torch.zeros(d)
            cross.append(layer)
        params = {"emb": init_embedding_table(generator, cfg), "cross": cross,
                  "top": init_mlp(generator, d, cfg.hidden_units)}
        if cfg.num_numeric:
            params["num_emb"] = truncated_normal(generator, (1, cfg.num_numeric, k), k ** -0.5)
        return params

    @staticmethod
    def _cross(layer, x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x0 * (W x + b) + x, rounded as rectpu's ``_cross``."""
        if "w" in layer:
            xw = _dot(x, layer["w"].to(x.dtype), torch.float32)
        else:  # low rank: (x V) U^T, xV rounded to x's dtype
            xv = _dot(x, layer["v"].to(x.dtype), x.dtype)
            xw = _dot(xv, layer["u"].to(x.dtype).t(), torch.float32)
        xw = (xw + layer["b"].float()).to(x.dtype)
        return x0 * xw + x

    def _apply_x0(self, x0: torch.Tensor, train: bool, seed32) -> torch.Tensor:
        cfg = self.cfg
        if cfg.torch_compute_dtype is not None:
            x0 = x0.to(cfg.torch_compute_dtype)
        x = x0
        for layer in self.cross:
            x = self._cross(layer, x0, x)
        layers = [(layer["kernel"], layer["bias"]) for layer in self.top]
        return apply_mlp(layers, x, cfg.activation, compute_dtype=cfg.torch_compute_dtype,
                         dropout=cfg.dropout, train=train, seed32=seed32,
                         dropout_impl=cfg.dropout_impl, row_offset=self.row_offset,
                         tp=self.tower_tp("top"))[:, 0]

    def apply_looked(self, looked: torch.Tensor, num_vals: torch.Tensor | None, *,
                     train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """Tower math from gathered [B, F, K] rows (the sparse fast step's hook)."""
        emb = append_numeric(self, looked, num_vals)
        return self._apply_x0(emb.reshape(emb.shape[0], -1), train, seed32)

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None, *,
                train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """cat_ids [B, F] int32 global row ids, num_vals [B, N] -> logits [B]
        fp32. ``train`` turns the top tower's dropout on, seeded by ``seed32``."""
        return self.apply_looked(lookup_fields(self.emb, cat_ids, self.cfg, self.lookup_fn),
                                 num_vals,
                                 train=train, seed32=seed32)

    def default_optimizer(self):
        """Adam(1e-3), the zoo's deep-model convention."""
        from rectpu_torch.train.optimizers import adam

        return adam(learning_rate=0.001)
