"""DeepFM for serving: the port of ``rectpu/models/deep_fm.py``'s non-flat path.

    logits = linear + FM second order (+ order 3) + DNN

over a shared per-field embedding input layer (reference deep_fm.py:11-125).
The components toggle with use_linear / use_mf / use_dnn; numeric features
enter the shared input layer as value x learned vector. This is rectpu's
``apply`` / ``apply_looked`` (``deep_fm.py:101-129``, ``:186-227``): one gather
of the fused ``[V, K+1]`` table (embedding | linear weight) feeds every tower.
rectpu's lane-packed ``_apply_flat`` is a TPU layout of the same model; an
export does not record it, so serving never takes it, and the port always
runs this form.

The module holds its weights as buffers, filled from a rectpu-layout
parameter tree by ``rectpu_torch.convert.deep_fm_state`` and ``load_state``.
``init`` makes such a tree from a ``torch.Generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from rectpu_torch.models.base import (
    TowerConfig,
    apply_mlp,
    init_mlp,
    lookup_fields,
    numeric_field_embeddings,
    pack_fused_table,
    truncated_normal,
)
from rectpu_torch.ops.embedding import lookup
from rectpu_torch.ops.fm import fm_cross, fm_cross3_xla


class DeepFMModel(nn.Module):
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

    def init(self, generator: torch.Generator) -> dict:
        """A fresh parameter tree in rectpu's layout (CPU tensors, stored in
        cfg.table_dtype for the table): truncated-normal embeddings with
        stddev 1/sqrt(K), glorot-uniform dense kernels, zero biases and zero
        linear weights (TF's initializers, as rectpu's ``init``)."""
        cfg = self.cfg
        k = cfg.embedding_size
        params = {}
        if self.use_linear:
            params["linear"] = {"w": torch.zeros(cfg.padded_buckets), "b": torch.zeros(())}
            if cfg.num_numeric:
                params["linear"]["w_num"] = torch.zeros(cfg.num_numeric)
        if self.use_mf or self.use_dnn:
            emb = truncated_normal(generator, (cfg.padded_buckets, k), k ** -0.5)
            emb = emb.to(cfg.torch_table_dtype)
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

    def load_state(self, state: dict) -> "DeepFMModel":
        """Register the converted weights (``convert.deep_fm_state``) as buffers."""
        for name, tensor in state.items():
            self.register_buffer(name, tensor)
        return self

    def _mlp_layers(self):
        n = len(self.cfg.hidden_units) + 1
        return [(getattr(self, f"mlp_{i}_kernel"), getattr(self, f"mlp_{i}_bias"))
                for i in range(n)]

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None) -> torch.Tensor:
        """cat_ids [B, F] int32 global row ids, num_vals [B, N] -> logits [B] fp32."""
        logits = torch.zeros(cat_ids.shape[0], dtype=torch.float32, device=cat_ids.device)
        if self.use_linear and not self.fused:
            # rectpu's apply_linear_tower: a [V]-weight gather, here the
            # lookup kernel over the weight viewed as a [V, 1] table
            lin = lookup(self.linear_w, cat_ids, impl=self.cfg.embedding_impl)
            lin = lin[..., 0].sum(dim=1) + self.linear_b
            if hasattr(self, "linear_w_num") and num_vals is not None:
                lin = lin + num_vals.float() @ self.linear_w_num
            logits = logits + lin
        if self.use_mf or self.use_dnn:
            looked = lookup_fields(self.table, cat_ids, self.cfg)
            logits = logits + self.apply_looked(looked, num_vals)
        return logits

    def apply_looked(self, looked: torch.Tensor, num_vals: torch.Tensor | None) -> torch.Tensor:
        """Tower math from gathered rows: ``looked`` is [B, F, K+1(+pad)] when
        the linear tower is fused (column K = linear weight), else [B, F, K]."""
        cfg = self.cfg
        k = cfg.embedding_size
        logits = torch.zeros(looked.shape[0], dtype=torch.float32, device=looked.device)
        if self.use_linear and cfg.fuse_linear_lookup:
            emb = looked[..., :k]  # a strided view; the FM kernel takes it as is
            lin = looked[..., k].float()
            logits = logits + lin.sum(dim=-1) + self.linear_b
            if hasattr(self, "linear_w_num") and num_vals is not None:
                logits = logits + num_vals.float() @ self.linear_w_num
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
            flat = emb.reshape(emb.shape[0], -1)
            dnn_logit = apply_mlp(self._mlp_layers(), flat, cfg.activation,
                                  compute_dtype=cfg.torch_compute_dtype)
            logits = logits + dnn_logit[:, 0]
        return logits
