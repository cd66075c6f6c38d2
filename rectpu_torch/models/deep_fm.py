"""DeepFM: the port of ``rectpu/models/deep_fm.py``.

    logits = linear + FM second order (+ order 3) + DNN

over a shared per-field embedding input layer (reference deep_fm.py:11-125).
The components toggle with use_linear / use_mf / use_dnn; numeric features
enter the shared input layer as value x learned vector.

The module's weights are ``nn.Parameter``s named after the leaves of rectpu's
parameter tree: ``table`` (packed [V, K+1(+pad)]) or ``emb`` [V, K],
``linear.w`` / ``linear.b`` / ``linear.w_num``, ``num_emb`` [1, N, K] and
``mlp.<i>.kernel`` / ``mlp.<i>.bias``; a parameter's name with "." read as
"/" is its rectpu key path. ``rectpu_torch.convert`` carries a tree across
both ways, the fp32 masters unchanged. ``init`` makes such a tree from a
``torch.Generator``.

Two forward forms, as in rectpu:

  - rectpu's ``apply`` / ``apply_looked`` (:101-129, :186-227): one gather of
    the fused ``[V, K+1]`` table (embedding | linear weight) feeds every
    tower; the FM logit is in the towers' dtype (bf16 under a bf16 compute
    dtype). Serving always runs this form: an export does not record the
    flat layout.
  - ``cfg.flat_layout`` (packed table, no numeric fields): rectpu's
    ``_apply_flat`` numerics (:131-174): the linear logit from column K, the
    FM logit in fp32 (``fm_cross_flat``), the same MLP on the [B, F*K]
    embeddings. rectpu's lane-packed [B, F*K] gather is a TPU layout; the
    port computes the same values from the [B, F, K+1] gather. One
    difference in bf16: rectpu sums the small fields' linear weights in fp32
    inside its multihot matmul and rounds that partial sum to bf16
    (embedding.py:436); the port sums the gathered bf16 weights in fp32.

Under a bf16 compute dtype the fp32 master table is cast to bf16 before the
gather (``gather_dtype``), as rectpu does; the dense table cotangent is
rounded to ``table_grad_dtype`` and then cast back to the master's dtype.
"""

from __future__ import annotations

import torch

from rectpu_torch.models.base import (
    RecModel,
    TowerConfig,
    apply_mlp,
    init_embedding_table,
    init_linear_tower,
    init_mlp,
    linear_tower_logit,
    lookup_fields,
    numeric_field_embeddings,
    pack_fused_table,
    truncated_normal,
)
from rectpu_torch.ops.fm import fm_cross, fm_cross3_xla


class DeepFMModel(RecModel):
    name = "deep_fm"
    EXPORT_KWARGS = ("use_linear", "use_mf", "use_dnn", "fm_order")

    def __init__(
        self,
        cfg: TowerConfig,
        use_linear: bool = True,
        use_mf: bool = True,
        use_dnn: bool = True,
        fm_order: int = 2,
    ):
        super().__init__()
        if cfg.num_fields + cfg.num_numeric == 0:
            raise ValueError(
                "At least 1 feature column of categorical_columns or numeric_columns "
                "must be specified."
            )
        if not (use_linear or use_mf or use_dnn):
            raise ValueError("At least 1 of linear, mf or dnn component must be used.")
        if fm_order not in (2, 3):
            raise ValueError(f"fm_order must be 2 or 3, got {fm_order}")
        self.cfg = cfg
        self.use_linear = use_linear
        self.use_mf = use_mf
        self.use_dnn = use_dnn
        self.fm_order = fm_order

    @property
    def packed(self) -> bool:
        """rectpu's tree holds one [V, K+1] ``table`` (emb columns + linear weight)."""
        return (
            self.cfg.packed_linear
            and self.cfg.fuse_linear_lookup
            and self.use_linear
            and (self.use_mf or self.use_dnn)
        )

    @property
    def fused(self) -> bool:
        """The linear weight rides the embedding gather as column K."""
        return self.cfg.fuse_linear_lookup and self.use_linear and (self.use_mf or self.use_dnn)

    @property
    def flat(self) -> bool:
        """The flat-layout numerics (rectpu's ``_apply_flat``) apply."""
        return self.cfg.flat_layout and self.packed and self.cfg.num_numeric == 0

    def init(self, generator: torch.Generator) -> dict:
        """A fresh parameter tree in rectpu's layout (CPU tensors, stored in
        cfg.table_dtype for the table): truncated-normal embeddings with
        stddev 1/sqrt(K), glorot-uniform dense kernels, zero biases and zero
        linear weights (TF's initializers, as rectpu's ``init``)."""
        cfg = self.cfg
        k = cfg.embedding_size
        params = {}
        if self.use_linear:
            params["linear"] = init_linear_tower(cfg)
        if self.use_mf or self.use_dnn:
            emb = init_embedding_table(generator, cfg)
            if self.packed:
                w = params["linear"].pop("w")
                params["table"] = pack_fused_table(emb, w, cfg.packed_col_pad)
            else:
                params["emb"] = emb
            if cfg.num_numeric:
                params["num_emb"] = truncated_normal(generator, (1, cfg.num_numeric, k),
                                                     k ** -0.5)
        if self.use_dnn:
            params["mlp"] = init_mlp(generator, (cfg.num_fields + cfg.num_numeric) * k,
                                     cfg.hidden_units)
        return params

    def fused_table(self) -> torch.Tensor:
        """[V, K+1(+pad)] = [embedding | linear weight]: the parameter itself
        when packed, else assembled per call (differentiable in both)."""
        if self.packed:
            return self.table
        return self.ep_table(self.emb, self.linear["w"])

    def _mlp_layers(self):
        return [(layer["kernel"], layer["bias"]) for layer in self.mlp]

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None, *,
                train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """cat_ids [B, F] int32 global row ids, num_vals [B, N] -> logits [B]
        fp32. ``train`` turns dropout on, seeded by ``seed32``
        (``models.base.step_seed32``)."""
        if self.flat:
            return self._forward_flat(cat_ids, train, seed32)
        logits = torch.zeros(cat_ids.shape[0], dtype=torch.float32, device=cat_ids.device)
        if self.use_linear and not self.fused:
            logits = logits + linear_tower_logit(self.linear, cat_ids, num_vals,
                                                 self.cfg.embedding_impl)
        if self.use_mf or self.use_dnn:
            table = self.fused_table() if self.fused else self.emb
            looked = lookup_fields(table, cat_ids, self.cfg, self.lookup_fn)
            logits = logits + self.apply_looked(looked, num_vals, train=train, seed32=seed32)
        return logits

    def _mlp(self, flat: torch.Tensor, train: bool, seed32) -> torch.Tensor:
        cfg = self.cfg
        return apply_mlp(self._mlp_layers(), flat, cfg.activation,
                         compute_dtype=cfg.torch_compute_dtype, dropout=cfg.dropout,
                         train=train, seed32=seed32, dropout_impl=cfg.dropout_impl,
                         row_offset=self.row_offset, tp=self.tower_tp("mlp"))[:, 0]

    def apply_looked(self, looked: torch.Tensor, num_vals: torch.Tensor | None, *,
                     train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """Tower math from gathered rows: ``looked`` is [B, F, K+1(+pad)] when
        the linear tower is fused (column K = linear weight), else [B, F, K]."""
        cfg = self.cfg
        k = cfg.embedding_size
        logits = torch.zeros(looked.shape[0], dtype=torch.float32, device=looked.device)
        if self.use_linear and cfg.fuse_linear_lookup:
            emb = looked[..., :k]  # a strided view; the FM kernels take it as is
            lin = looked[..., k].float()
            logits = logits + lin.sum(dim=-1) + self.linear["b"]
            if "w_num" in self.linear and num_vals is not None:
                logits = logits + num_vals.float() @ self.linear["w_num"]
        else:
            emb = looked

        if cfg.num_numeric:
            num = numeric_field_embeddings(self.num_emb, num_vals)
            emb = torch.cat([emb, num.to(emb.dtype)], dim=1)  # [B, F+N, K]

        if self.use_mf:
            logits = logits + fm_cross(emb, impl=cfg.fm_impl).float()
            if self.fm_order >= 3:
                logits = logits + fm_cross3_xla(emb)

        if self.use_dnn:
            logits = logits + self._mlp(emb.reshape(emb.shape[0], -1), train, seed32)
        return logits

    def _forward_flat(self, cat_ids: torch.Tensor, train: bool, seed32) -> torch.Tensor:
        """rectpu's ``_apply_flat`` numerics from the [B, F, K+1] gather."""
        cfg = self.cfg
        k = cfg.embedding_size
        if self.table.shape[1] > k + 1:
            raise NotImplementedError(
                f"the flat layout does not take a lane-padded packed table (width "
                f"{self.table.shape[1]} > K+1={k + 1}), as rectpu's lookup_flat does not")
        emb, lin = self.flat_lookup(self.table, cat_ids, has_lin=True)
        logits = lin + self.linear["b"]
        if self.use_mf:
            logits = logits + fm_cross(emb, impl=cfg.fm_impl, out_dtype=torch.float32)
            if self.fm_order >= 3:
                logits = logits + fm_cross3_xla(emb)
        if self.use_dnn:
            logits = logits + self._mlp(emb.reshape(emb.shape[0], -1), train, seed32)
        return logits

    def default_optimizer(self):
        """Reference default: Adam(lr=1e-3) (reference deep_fm.py:24-26)."""
        from rectpu_torch.train.optimizers import adam

        return adam(learning_rate=0.001)
