"""xDeepFM: the port of ``rectpu/models/xdeep_fm.py`` (Lian et al., arXiv:1803.05170).

    x^0      = per-field embeddings                         [B, M, K]
    x^{l+1}[b,o,k] = sum_{h,m} W^l[h,m,o] * x^l[b,h,k] * x^0[b,m,k]
    p        = concat_l sum_k x^l[:, :, k]                  [B, sum H_l]
    logit    = linear + w_cin . p + b_cin + DNN(flat embeddings)

Each CIN layer is ``ops.cin.cin_core`` (or ``cin_core_kmajor`` for
``cin_layout="kmajor"``): the hand-written contraction and weight-gradient
kernels on the card, whose gradients never form the [B, H, M, K] expansion.
The components toggle with use_linear / use_cin / use_dnn, numeric features
enter as value x learned vector, and the linear weight rides the embedding
gather as column K (one [V, K+1] gather feeds linear, CIN and DNN), as a
packed ``table`` parameter with ``packed_linear``.

The weights are ``nn.Parameter``s named after rectpu's leaves: ``table`` or
``emb``, ``linear.*``, ``num_emb``, ``cin.<l>.w`` [H_l, M, H_{l+1}],
``cin_out.w`` [sum H, 1], ``cin_out.b`` [1] and ``mlp.<i>.*``.

Forward forms as in rectpu: ``apply`` / ``apply_looked`` (:179-273) on the
[B, M, K+1] gather, and with ``cfg.flat_layout`` (packed, no numeric fields)
``_apply_flat`` (:206-240): the linear logit from column K in fp32, the CIN
on the [B, F, K] view and the DNN on the flat embeddings. rectpu's lane-packed
[B, F*K] gather is a TPU layout; the port reads the same values from the
[B, F, K+1] gather (the kernels take the strided view in place). Serving
always runs the first form: an export does not record the flat layout.
"""

from __future__ import annotations

import torch

from rectpu_torch.models.base import (
    RecModel,
    TowerConfig,
    apply_mlp,
    glorot_uniform,
    init_mlp,
    linear_tower_logit,
    lookup_fields,
    numeric_field_embeddings,
    pack_fused_table,
    truncated_normal,
)
from rectpu_torch.ops.cin import cin_core, cin_core_kmajor


class XDeepFMModel(RecModel):
    name = "xdeep_fm"
    EXPORT_KWARGS = ("use_linear", "use_cin", "use_dnn", "cin_units", "cin_layout")

    def __init__(self, cfg: TowerConfig, use_linear: bool = True, use_cin: bool = True,
                 use_dnn: bool = True, cin_units: tuple = (64, 64),
                 cin_layout: str = "legacy"):
        super().__init__()
        if cfg.num_fields + cfg.num_numeric == 0:
            raise ValueError("xDeepFM needs at least one feature column")
        if not (use_linear or use_cin or use_dnn):
            raise ValueError("At least 1 of linear, cin or dnn component must be used.")
        if use_cin and (not cin_units or any(int(h) < 1 for h in cin_units)):
            raise ValueError(f"cin_units must be positive, got {cin_units!r}")
        if cin_layout not in ("legacy", "kmajor"):
            raise ValueError(f"cin_layout must be legacy|kmajor, got {cin_layout}")
        self.cfg = cfg
        self.use_linear = use_linear
        self.use_cin = use_cin
        self.use_dnn = use_dnn
        self.cin_units = tuple(int(h) for h in cin_units)
        self.cin_layout = cin_layout

    @property
    def packed(self) -> bool:
        """rectpu's tree holds one [V, K+1] ``table`` (emb columns + linear weight)."""
        return (self.cfg.packed_linear and self.cfg.fuse_linear_lookup and self.use_linear
                and (self.use_cin or self.use_dnn))

    @property
    def fused(self) -> bool:
        """The linear weight rides the embedding gather as column K."""
        return self.cfg.fuse_linear_lookup and self.use_linear and (self.use_cin or self.use_dnn)

    @property
    def flat(self) -> bool:
        """rectpu's ``_apply_flat`` applies."""
        return self.cfg.flat_layout and self.packed and self.cfg.num_numeric == 0

    @property
    def num_vectors(self) -> int:
        return self.cfg.num_fields + self.cfg.num_numeric

    def init(self, generator: torch.Generator) -> dict:
        """A fresh parameter tree in rectpu's layout: zero linear weights,
        truncated-normal embeddings (stddev 1/sqrt(K)), glorot-uniform CIN
        weights over each layer's (H*M -> H') contraction, the CIN output
        layer and the DNN, zero biases."""
        cfg = self.cfg
        k = cfg.embedding_size
        params = {}
        if self.use_linear:
            params["linear"] = {"w": torch.zeros(cfg.padded_buckets), "b": torch.zeros(())}
            if cfg.num_numeric:
                params["linear"]["w_num"] = torch.zeros(cfg.num_numeric)
        if self.use_cin or self.use_dnn:
            emb = truncated_normal(generator, (cfg.padded_buckets, k), k ** -0.5)
            emb = emb.to(cfg.torch_table_dtype)
            if self.packed:
                params["table"] = pack_fused_table(emb, params["linear"].pop("w"),
                                                   cfg.packed_col_pad)
            else:
                params["emb"] = emb
            if cfg.num_numeric:
                params["num_emb"] = truncated_normal(generator, (1, cfg.num_numeric, k),
                                                     k ** -0.5)
        if self.use_cin:
            m = self.num_vectors
            layers, h_in = [], m
            for h_out in self.cin_units:
                layers.append({"w": glorot_uniform(generator, (h_in * m, h_out))
                               .reshape(h_in, m, h_out)})
                h_in = h_out
            params["cin"] = layers
            params["cin_out"] = {"w": glorot_uniform(generator, (sum(self.cin_units), 1)),
                                 "b": torch.zeros(1)}
        if self.use_dnn:
            params["mlp"] = init_mlp(generator, self.num_vectors * k, cfg.hidden_units)
        return params

    # -- CIN -----------------------------------------------------------------

    def _cin_logit(self, emb: torch.Tensor) -> torch.Tensor:
        """emb [B, M, K] -> the CIN logit [B] fp32 (rectpu's ``_cin_logit``)."""
        if self.cin_layout == "kmajor":
            x0 = emb.transpose(1, 2)  # [B, K, M]: a view, the kernels read it in place
            sum_axis, core = 1, cin_core_kmajor
        else:
            x0 = emb
            sum_axis, core = 2, cin_core
        x, pools = x0, []
        for layer in self.cin:
            x = core(x, x0, layer["w"].to(x.dtype))
            pools.append(x.float().sum(dim=sum_axis))  # [B, H_l]
        p = torch.cat(pools, dim=1)
        return (p @ self.cin_out["w"].float() + self.cin_out["b"])[:, 0]

    # -- forward -------------------------------------------------------------

    def _mlp(self, flat: torch.Tensor, train: bool, seed32) -> torch.Tensor:
        cfg = self.cfg
        layers = [(layer["kernel"], layer["bias"]) for layer in self.mlp]
        return apply_mlp(layers, flat, cfg.activation, compute_dtype=cfg.torch_compute_dtype,
                         dropout=cfg.dropout, train=train, seed32=seed32,
                         dropout_impl=cfg.dropout_impl, row_offset=self.row_offset,
                         tp=self.tower_tp("mlp"))[:, 0]

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None, *,
                train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """cat_ids [B, F] int32 global row ids, num_vals [B, N] -> logits [B]
        fp32. ``train`` turns dropout on, seeded by ``seed32``."""
        if self.flat:
            return self._forward_flat(cat_ids, train, seed32)
        logits = torch.zeros(cat_ids.shape[0], dtype=torch.float32, device=cat_ids.device)
        if self.use_linear and not self.fused:
            logits = logits + linear_tower_logit(self.linear, cat_ids, num_vals,
                                                 self.cfg.embedding_impl)
        if self.use_cin or self.use_dnn:
            if self.packed:
                table = self.table
            elif self.fused:
                table = self.ep_table(self.emb, self.linear["w"])
            else:
                table = self.emb
            looked = lookup_fields(table, cat_ids, self.cfg, self.lookup_fn)
            logits = logits + self.apply_looked(looked, num_vals, train=train, seed32=seed32)
        return logits

    def apply_looked(self, looked: torch.Tensor, num_vals: torch.Tensor | None, *,
                     train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """Tower math from gathered rows: [B, M, K+1(+pad)] when the linear
        tower is fused (column K = linear weight), else [B, M, K]."""
        cfg = self.cfg
        k = cfg.embedding_size
        logits = torch.zeros(looked.shape[0], dtype=torch.float32, device=looked.device)
        if self.use_linear and cfg.fuse_linear_lookup:
            emb = looked[..., :k]
            logits = logits + looked[..., k].float().sum(dim=-1) + self.linear["b"]
            if "w_num" in self.linear and num_vals is not None:
                logits = logits + num_vals.float() @ self.linear["w_num"]
        else:
            emb = looked
        if cfg.num_numeric:
            num = numeric_field_embeddings(self.num_emb, num_vals)
            emb = torch.cat([emb, num.to(emb.dtype)], dim=1)
        if cfg.torch_compute_dtype is not None:
            emb = emb.to(cfg.torch_compute_dtype)
        if self.use_cin:
            logits = logits + self._cin_logit(emb)
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
        if self.use_cin:
            logits = logits + self._cin_logit(emb)
        if self.use_dnn:
            logits = logits + self._mlp(emb.reshape(emb.shape[0], -1), train, seed32)
        return logits

    def default_optimizer(self):
        """Adam(1e-3), the zoo's deep-model convention."""
        from rectpu_torch.train.optimizers import adam

        return adam(learning_rate=0.001)
