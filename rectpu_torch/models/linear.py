"""Linear (wide) CTR model: the port of ``rectpu/models/linear.py``.

``tf.estimator.LinearClassifier`` over the 26 sparse columns (reference
trainers/linear.py:30-34): one weight per feature bucket plus a bias (and
one weight per numeric field), zero-initialised, trained with FTRL by
default (the canned estimator's default). Its parameter tree is rectpu's
``{"linear": {"w": [V_pad], "b": [], ["w_num": [N]]}}``.
"""

from __future__ import annotations

import math

import torch

from rectpu_torch.models.base import RecModel, TowerConfig, init_linear_tower, linear_tower_logit


class LinearModel(RecModel):
    name = "linear"
    EXPORT_KWARGS = ()

    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: torch.Generator) -> dict:
        del generator  # zero init
        return {"linear": init_linear_tower(self.cfg)}

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None, *,
                train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """cat_ids [B, F] int32 global row ids, num_vals [B, N] -> logits [B] fp32."""
        del train, seed32
        return linear_tower_logit(self.linear, cat_ids, num_vals, self.cfg.embedding_impl)

    def default_optimizer(self):
        """TF LinearClassifier's default: FTRL, lr = min(0.2, 1/sqrt(#columns))."""
        from rectpu_torch.train.optimizers import ftrl

        return ftrl(learning_rate=min(0.2, 1.0 / math.sqrt(self.cfg.num_fields
                                                           + self.cfg.num_numeric)))
