"""Binary head, loss and streaming metrics: the port of ``rectpu/train/metrics.py``.

Replaces the reference's head and TF metric ops (reference
trainers/model_utils.py:9-54): the sigmoid cross-entropy, the prediction
dict, and streaming accuracy, ROC-AUC, PR-AUC (TF's 200-threshold
confusion-bucket estimator, trapezoidal summation: tf.metrics.auc defaults)
and average loss, as a small dict of counters that ``update_state``
accumulates on the model's device; ``merge_states`` adds two states and
``psum_state`` sums one over a plan's batch ranks. ``exact_auc`` is the
rank-based ROC-AUC.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_THRESHOLDS = 200  # tf.metrics.auc default
_KEPSILON = 1e-7


def auc_thresholds(num_thresholds: int = NUM_THRESHOLDS) -> np.ndarray:
    """TF's threshold grid: [-eps, 1/(T-1), ..., (T-2)/(T-1), 1+eps]."""
    inner = [(i + 1) * 1.0 / (num_thresholds - 1) for i in range(num_thresholds - 2)]
    return np.array([-_KEPSILON] + inner + [1.0 + _KEPSILON], dtype=np.float32)


def init_state(num_thresholds: int = NUM_THRESHOLDS, device=None) -> dict:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"tp": z(num_thresholds), "fp": z(num_thresholds), "tn": z(num_thresholds),
            "fn": z(num_thresholds), "correct": z(), "loss_sum": z(), "count": z()}


def update_state(state: dict, probs: torch.Tensor, labels: torch.Tensor,
                 losses: torch.Tensor | None = None,
                 weights: torch.Tensor | None = None) -> dict:
    """Accumulate one batch (probs/labels/losses/weights: [B]); returns the
    new state."""
    num_thresholds = state["tp"].shape[0]
    thr = torch.from_numpy(auc_thresholds(num_thresholds)).to(probs.device)
    probs = probs.float()
    labels = labels.float()
    w = torch.ones_like(probs) if weights is None else weights.float()
    pred_pos = probs[None, :] > thr[:, None]  # [T, B]: positive iff prob > thr
    lab_pos = labels[None, :] > 0.5
    wb = w[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=probs.device)
    tp = torch.where(pred_pos & lab_pos, wb, zero).sum(dim=1)
    fp = torch.where(pred_pos & ~lab_pos, wb, zero).sum(dim=1)
    fn = torch.where(~pred_pos & lab_pos, wb, zero).sum(dim=1)
    tn = torch.where(~pred_pos & ~lab_pos, wb, zero).sum(dim=1)
    class_id = (probs > 0.5).float()
    correct = (w * (class_id == labels)).sum()
    loss_sum = zero if losses is None else (w * losses).sum()
    return {"tp": state["tp"] + tp, "fp": state["fp"] + fp, "tn": state["tn"] + tn,
            "fn": state["fn"] + fn, "correct": state["correct"] + correct,
            "loss_sum": state["loss_sum"] + loss_sum, "count": state["count"] + w.sum()}


def merge_states(a: dict, b: dict) -> dict:
    """The state of two disjoint sets of batches (rectpu's ``merge_states``)."""
    return {k: a[k] + b[k] for k in a}


def psum_state(state: dict, plan) -> dict:
    """A rank's metric state summed over its ParallelPlan's batch ranks, the
    ranks that hold the other rows of the eval set (rectpu's ``psum_state``
    over the batch axis)."""
    return plan.reduce_metric_state(state)


def _trapezoid(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x[:-1] - x[1:]) * (y[:-1] + y[1:]) / 2.0).sum()


def finalize(state: dict, epsilon: float = 1e-7) -> dict:
    """The metric dict (Python floats) from an accumulated state (TF formulas)."""
    s = {k: v.detach().cpu() for k, v in state.items()}
    tp, fp, tn, fn = s["tp"], s["fp"], s["tn"], s["fn"]
    tpr = tp / (tp + fn + epsilon)
    fpr = fp / (fp + tn + epsilon)
    precision = tp / (tp + fp + epsilon)
    count = torch.clamp(s["count"], min=1.0)
    out = {
        "accuracy": s["correct"] / count,
        "auc": _trapezoid(fpr, tpr),
        "auc_precision_recall": _trapezoid(tpr, precision),
        "average_loss": s["loss_sum"] / count,
        "count": s["count"],
    }
    return {k: float(v) for k, v in out.items()}


def exact_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based exact ROC-AUC (ties averaged)."""
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos = labels.sum()
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(probs, kind="mergesort")
    sorted_p = probs[order]
    ranks = np.empty(probs.size, dtype=np.float64)
    # average ranks over runs of ties
    starts = np.flatnonzero(np.r_[True, sorted_p[1:] != sorted_p[:-1]])
    ends = np.r_[starts[1:], sorted_p.size]
    ranks[order] = np.repeat((starts + ends - 1) / 2.0 + 1.0, ends - starts)
    rank_sum = ranks[labels].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


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
