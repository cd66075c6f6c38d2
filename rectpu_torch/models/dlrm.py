"""DLRM: the port of ``rectpu/models/dlrm.py`` (Naumov et al., arXiv:1906.00091).

    dense features --bottom MLP--> d0            [B, K]
    sparse fields  --embedding---> e1..eF        [B, F, K]
    interactions   = pairwise dots of {e1..eF, d0}   (upper triangle)
    logit          = top MLP(concat[d0, interactions])

Without numeric features there is no d0 and the top MLP sees the
interactions alone. The weights are ``nn.Parameter``s named after rectpu's
leaves: ``emb`` [V, K], ``top.<i>.kernel`` / ``top.<i>.bias`` and, with
numeric features, ``bot.<i>.*`` (``rectpu_torch.convert`` carries the tree).

Two forward forms, as in rectpu, both through ``ops.interaction``:

  - the 3D form (rectpu's ``apply_looked``, :171-193): the gathered [B, F, K]
    rows with d0 appended as one more vector, and the exact-product
    interaction (rectpu's einsum ``_interact``, :88-100, which the kernel's
    exact mode computes). Serving always runs this form: an export does not
    record the flat layout.
  - ``cfg.flat_layout`` (rectpu's ``_apply_from_flat``, :137-169): the
    [B, F*K] activation with d0 appended as one more K-wide block, and
    ``interact_flat`` with ``interaction_impl``. rectpu's lane-packed gather
    is a TPU layout; the port reshapes the [B, F, K] gather, which is the same
    values.

The bottom MLP runs without dropout and its output is activated (the paper's
form). rectpu salts the top tower's dropout with ``fold_in(rng, 2)``; the port
salts the step's seed32 with ``tower_seed32(seed32, 2)``.
"""

from __future__ import annotations

import torch

from rectpu_torch.models.base import (
    RecModel,
    TowerConfig,
    apply_mlp,
    get_activation,
    init_mlp,
    lookup_fields,
    tower_seed32,
    truncated_normal,
)
from rectpu_torch.ops.interaction import IMPLS, interact, interact_flat, num_pairs


class DLRMModel(RecModel):
    name = "dlrm"
    EXPORT_KWARGS = ("bot_hidden_units", "arch_interaction_itself", "interaction_impl")

    def __init__(self, cfg: TowerConfig, bot_hidden_units=(64,),
                 arch_interaction_itself: bool = False, interaction_impl: str = "auto"):
        super().__init__()
        if cfg.num_fields + cfg.num_numeric == 0:
            raise ValueError("DLRM needs at least one sparse or dense feature")
        if interaction_impl not in IMPLS:
            raise ValueError(f"unknown interaction_impl: {interaction_impl}")
        self.cfg = cfg
        self.bot_hidden_units = tuple(int(h) for h in bot_hidden_units)
        self.arch_interaction_itself = bool(arch_interaction_itself)
        self.interaction_impl = interaction_impl

    @property
    def n_vectors(self) -> int:
        return self.cfg.num_fields + (1 if self.cfg.num_numeric else 0)

    @property
    def top_in_dim(self) -> int:
        dense_dim = self.cfg.embedding_size if self.cfg.num_numeric else 0
        return dense_dim + num_pairs(self.n_vectors, self.arch_interaction_itself)

    def init(self, generator: torch.Generator) -> dict:
        """A fresh parameter tree in rectpu's layout: a truncated-normal
        [V, K] table (stddev 1/sqrt(K), stored in cfg.table_dtype) and
        glorot-uniform towers with zero biases."""
        cfg = self.cfg
        k = cfg.embedding_size
        emb = truncated_normal(generator, (cfg.padded_buckets, k), k ** -0.5)
        params = {"emb": emb.to(cfg.torch_table_dtype),
                  "top": init_mlp(generator, self.top_in_dim, cfg.hidden_units)}
        if cfg.num_numeric:
            params["bot"] = init_mlp(generator, cfg.num_numeric, self.bot_hidden_units,
                                     out_dim=k)
        return params

    @staticmethod
    def _layers(tower):
        return [(layer["kernel"], layer["bias"]) for layer in tower]

    def _dense_vector(self, num_vals: torch.Tensor) -> torch.Tensor:
        """The bottom MLP's activated output d0 [B, K] fp32 (no dropout)."""
        cfg = self.cfg
        d0 = apply_mlp(self._layers(self.bot), num_vals, cfg.activation,
                       compute_dtype=cfg.torch_compute_dtype, row_offset=self.row_offset,
                       tp=self.tower_tp("bot"))
        return get_activation(cfg.activation)(d0)

    def _top_logit(self, top_in: torch.Tensor, train: bool, seed32) -> torch.Tensor:
        cfg = self.cfg
        return apply_mlp(self._layers(self.top), top_in, cfg.activation,
                         compute_dtype=cfg.torch_compute_dtype, dropout=cfg.dropout,
                         train=train, seed32=tower_seed32(seed32, 2),
                         dropout_impl=cfg.dropout_impl, row_offset=self.row_offset,
                         tp=self.tower_tp("top"))[:, 0]

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None, *,
                train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """cat_ids [B, F] int32 global row ids, num_vals [B, N] -> logits [B]
        fp32. ``train`` turns dropout on, seeded by ``seed32``."""
        if self.cfg.flat_layout and self.cfg.num_fields > 0:
            emb, _ = self.flat_lookup(self.emb, cat_ids, has_lin=False)  # [B, F, K]
            flat = emb.reshape(emb.shape[0], -1)
            return self.apply_from_flat(flat, num_vals, train=train, seed32=seed32)
        emb = lookup_fields(self.emb, cat_ids, self.cfg, self.lookup_fn)  # [B, F, K]
        return self.apply_looked(emb, num_vals, train=train, seed32=seed32)

    def apply_from_flat(self, flat: torch.Tensor, num_vals: torch.Tensor | None, *,
                        train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """Tower math on the [B, F*K] activation (rectpu's ``_apply_from_flat``)."""
        cfg = self.cfg
        n_vec = cfg.num_fields
        top_parts = []
        if cfg.num_numeric:
            d0 = self._dense_vector(num_vals)
            top_parts.append(d0)
            flat = torch.cat([flat, d0.to(flat.dtype)], dim=1)
            n_vec += 1
        top_parts.append(interact_flat(flat, n_vec, cfg.embedding_size,
                                       itself=self.arch_interaction_itself,
                                       impl=self.interaction_impl))
        top_in = torch.cat(top_parts, dim=1) if len(top_parts) > 1 else top_parts[0]
        return self._top_logit(top_in, train, seed32)

    def apply_looked(self, emb: torch.Tensor, num_vals: torch.Tensor | None, *,
                     train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """Tower math from gathered [B, F, K] rows (rectpu's ``apply_looked``)."""
        vectors = emb
        top_parts = []
        if self.cfg.num_numeric:
            d0 = self._dense_vector(num_vals)
            top_parts.append(d0)
            vectors = torch.cat([emb, d0[:, None, :].to(emb.dtype)], dim=1)
        top_parts.append(interact(vectors, itself=self.arch_interaction_itself))
        return self._top_logit(torch.cat(top_parts, dim=1), train, seed32)

    def default_optimizer(self):
        """Adam(1e-3), the zoo's deep-model convention."""
        from rectpu_torch.train.optimizers import adam

        return adam(learning_rate=0.001)
