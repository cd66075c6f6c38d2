"""The binary head and its loss (``rectpu/train/metrics.py:120-136``).

Replaces the reference's head (reference trainers/model_utils.py:9-36). The
streaming AUC accumulators come with the training slice.
"""

from __future__ import annotations

import torch


def sigmoid_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example sigmoid cross-entropy, numerically stable:
    max(x,0) - x*z + log(1+exp(-|x|))."""
    x = logits.float()
    z = labels.float()
    return torch.clamp(x, min=0.0) - x * z + torch.log1p(torch.exp(-torch.abs(x)))


def binary_predictions(logits: torch.Tensor) -> dict:
    """Prediction dict of the binary head: logits, logistic, probabilities
    (== logistic) and class_id."""
    logistic = torch.sigmoid(logits)
    return {
        "logits": logits,
        "logistic": logistic,
        "probabilities": logistic,
        "class_id": (logistic > 0.5).to(torch.int32),
    }
