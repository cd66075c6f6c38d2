"""Wide & Deep CTR model: the port of ``rectpu/models/wide_deep.py``.

``tf.estimator.DNNLinearCombinedClassifier`` (reference
trainers/linear_deep.py:32-39): a linear tower over the sparse columns plus
the DNN tower over embedding columns, logits summed, each tower with its
canned optimizer (FTRL(min(0.2, 1/sqrt(#columns))) on ``linear``,
Adagrad(0.05) elsewhere). Three forms, as in rectpu:

  - unfused (``fuse_linear_lookup=False``): the linear tower's own gather of
    ``linear.w`` plus the DNN over ``emb``;
  - fused: one gather of ``[emb | linear.w]``, assembled per call
    (``pack_fused_table``), feeds both towers; the gradient flows through the
    concatenation to ``emb`` and ``linear.w``;
  - packed (``packed_linear`` and ``fuse_linear_lookup``): that [V, K+1(+pad)]
    table is the parameter ``table``, updated column by column by
    ``optimizers.packed_wide_deep``.

rectpu's flat layout (no numeric fields) reads the fused table through
``lookup_flat``, which takes no lane-padded table; the port computes the same
values from the [B, F, K+1] gather and raises for a padded table as rectpu
does.
"""

from __future__ import annotations

import math

import torch

from rectpu_torch.models.base import (
    RecModel,
    TowerConfig,
    init_linear_tower,
    linear_tower_logit,
    lookup_fields,
    pack_fused_table,
)
from rectpu_torch.models.dnn import deep_tower_logit, init_dnn


class WideDeepModel(RecModel):
    name = "linear_deep"
    EXPORT_KWARGS = ()

    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.cfg = cfg
        self.packed = cfg.packed_linear and cfg.fuse_linear_lookup

    def init(self, generator: torch.Generator) -> dict:
        params = init_dnn(generator, self.cfg)
        params["linear"] = init_linear_tower(self.cfg)
        if self.packed:
            emb = params.pop("emb")
            w = params["linear"].pop("w")
            params["table"] = pack_fused_table(emb, w, self.cfg.packed_col_pad)
        return params

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None, *,
                train: bool = False, seed32: int | None = None) -> torch.Tensor:
        cfg = self.cfg
        k = cfg.embedding_size
        if not cfg.fuse_linear_lookup:
            wide = linear_tower_logit(self.linear, cat_ids, num_vals, cfg.embedding_impl)
            looked = lookup_fields(self.emb, cat_ids, cfg, self.lookup_fn)
            return wide + deep_tower_logit(self, looked, num_vals, train, seed32)
        aug = self.table if self.packed else self.ep_table(self.emb, self.linear["w"])
        if cfg.flat_layout and cfg.num_numeric == 0 and aug.shape[1] > k + 1:
            raise NotImplementedError(
                f"the flat layout does not take a lane-padded packed table (width "
                f"{aug.shape[1]} > K+1={k + 1}), as rectpu's lookup_flat does not")
        looked = lookup_fields(aug, cat_ids, cfg, self.lookup_fn)  # [B, F, K+1(+pad)]
        wide = looked[..., k].float().sum(dim=-1) + self.linear["b"]
        if "w_num" in self.linear and num_vals is not None:
            wide = wide + num_vals.float() @ self.linear["w_num"]
        return wide + deep_tower_logit(self, looked[..., :k], num_vals, train, seed32)

    def default_optimizer(self):
        """Joint training with per-tower optimizers, as the canned estimator."""
        from rectpu_torch.train.optimizers import adagrad, ftrl, packed_wide_deep, per_subtree

        lr_linear = min(0.2, 1.0 / math.sqrt(self.cfg.num_fields + self.cfg.num_numeric))
        if self.packed:
            return packed_wide_deep(self.cfg.embedding_size, lr_linear)
        return per_subtree({"linear": ftrl(learning_rate=lr_linear)},
                           default=adagrad(learning_rate=0.05))
