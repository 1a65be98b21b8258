"""Streaming evaluation metrics, in numpy.

Port of ``avex_tpu/metrics/__init__.py``: each metric accumulates
``(logits, targets)`` batches on the host through ``update`` and reports
through ``get_primary_metric`` / ``compute``. One-hot and multi-hot targets
are accepted everywhere and collapsed to indices where appropriate. The JAX
package calls scikit-learn's scores; the port computes the same scores in
numpy (the machine with the card has no scikit-learn): accuracy, balanced
accuracy, binary and macro F1 (0 where undefined), average precision as the
step-wise sum ``Σ (Rₙ − Rₙ₋₁)·Pₙ`` over distinct thresholds, and ROC-AUC by
the trapezoid rule (0 when a class is missing, as the JAX package returns).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "Accuracy",
    "AveragePrecision",
    "BalancedAccuracy",
    "BinaryF1Score",
    "MeanAveragePrecision",
    "MulticlassBinaryF1Score",
    "ROCAUC",
    "get_metric_class",
]


def _labels_to_indices(y: np.ndarray) -> np.ndarray:
    """Collapse one-hot (N, C) targets to class indices (N,)."""
    y = np.asarray(y)
    if y.ndim == 2:
        return y.argmax(axis=1)
    return y.astype(np.int64)


def _predictions(logits: np.ndarray) -> np.ndarray:
    return logits.argmax(axis=1) if logits.ndim == 2 else (logits > 0).astype(int)


def _f1(y_true: np.ndarray, y_pred: np.ndarray, label) -> float:
    tp = np.sum((y_pred == label) & (y_true == label))
    fp = np.sum((y_pred == label) & (y_true != label))
    fn = np.sum((y_pred != label) & (y_true == label))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def _ranked_counts(y: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative true and false positives at each distinct score, highest first."""
    order = np.argsort(-scores, kind="mergesort")
    scores, y = scores[order], y[order]
    last = np.r_[np.where(np.diff(scores))[0], y.size - 1]
    tps = np.cumsum(y)[last].astype(np.float64)
    return tps, (1 + last) - tps


def _average_precision(y: np.ndarray, scores: np.ndarray) -> float:
    tps, fps = _ranked_counts(y, scores)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _roc_auc(y: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve of binary ``y``; NaN with one class present."""
    if np.unique(y).size != 2:
        return float("nan")
    tps, fps = _ranked_counts(y, scores)
    tpr = np.r_[0.0, tps / tps[-1]]
    fpr = np.r_[0.0, fps / fps[-1]]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


class _StreamingMetric:
    """Shared accumulation of predictions and targets across batches."""

    def __init__(self) -> None:
        self._logits: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def reset(self) -> None:
        """Clear accumulated predictions/targets."""
        self._logits.clear()
        self._targets.clear()

    def update(self, logits, y) -> None:
        """Accumulate one batch of (logits, targets)."""
        self._logits.append(np.asarray(logits))
        self._targets.append(np.asarray(y))

    def _stacked(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.concatenate(self._logits, axis=0), np.concatenate(self._targets, axis=0)

    def get_primary_metric(self) -> float:
        raise NotImplementedError

    def compute(self) -> float:
        """Alias of :meth:`get_primary_metric`."""
        return self.get_primary_metric()


class Accuracy(_StreamingMetric):
    """Top-1 accuracy."""

    def get_primary_metric(self) -> float:
        logits, y = self._stacked()
        return float(np.mean(_labels_to_indices(y) == _predictions(logits)))


class BalancedAccuracy(_StreamingMetric):
    """Mean per-class recall over the classes present in the targets."""

    def get_primary_metric(self) -> float:
        logits, y = self._stacked()
        y_true, y_pred = _labels_to_indices(y), _predictions(logits)
        return float(np.mean([np.mean(y_pred[y_true == c] == c) for c in np.unique(y_true)]))


class BinaryF1Score(_StreamingMetric):
    """F1 of the positive class for binary problems."""

    def get_primary_metric(self) -> float:
        logits, y = self._stacked()
        if logits.ndim == 2 and logits.shape[1] == 2:
            preds = logits.argmax(axis=1)
        elif logits.ndim == 2 and logits.shape[1] == 1:
            preds = (logits[:, 0] > 0).astype(int)
        else:
            preds = (logits > 0).astype(int)
        return _f1(_labels_to_indices(y), preds, 1)


class MulticlassBinaryF1Score(_StreamingMetric):
    """Macro-averaged F1 over the labels seen in targets or predictions."""

    def __init__(self, num_classes: Optional[int] = None) -> None:
        super().__init__()
        self.num_classes = num_classes

    def get_primary_metric(self) -> float:
        logits, y = self._stacked()
        y_true, y_pred = _labels_to_indices(y), logits.argmax(axis=1)
        labels = np.union1d(y_true, y_pred)
        return float(np.mean([_f1(y_true, y_pred, c) for c in labels]))


class AveragePrecision(_StreamingMetric):
    """Per-class average precision for multilabel problems."""

    def compute_per_class(self) -> np.ndarray:
        """Per-class average precision (NaN for classes with no positives)."""
        logits, y = self._stacked()
        if y.ndim == 1:
            y = np.eye(logits.shape[1], dtype=np.int64)[y.astype(np.int64)]
        scores = 1.0 / (1.0 + np.exp(-logits))
        aps = np.full(y.shape[1], np.nan)
        for c in range(y.shape[1]):
            if y[:, c].sum() > 0:
                aps[c] = _average_precision(y[:, c], scores[:, c])
        return aps

    def get_primary_metric(self) -> float:
        """Mean AP over classes with positive examples."""
        aps = self.compute_per_class()
        present = aps[~np.isnan(aps)]
        return float(present.mean()) if present.size else 0.0


class MeanAveragePrecision(AveragePrecision):
    """mAP over classes with positives."""


class ROCAUC(_StreamingMetric):
    """Macro one-vs-rest ROC-AUC; 0 when it is undefined."""

    def get_primary_metric(self) -> float:
        logits, y = self._stacked()
        if logits.ndim == 2 and logits.shape[1] > 2:
            yy = y if y.ndim == 2 else np.eye(logits.shape[1])[_labels_to_indices(y)]
            e = np.exp(logits - logits.max(axis=1, keepdims=True))  # softmax probabilities
            probs = e / e.sum(axis=1, keepdims=True)
            value = float(np.mean([_roc_auc(yy[:, c], probs[:, c]) for c in range(yy.shape[1])]))
        else:
            scores = logits[:, 1] if logits.ndim == 2 else logits
            value = _roc_auc(_labels_to_indices(y), scores)
        # NaN (a class missing) must not poison best-checkpoint compares
        return value if np.isfinite(value) else 0.0


def get_metric_class(metric_name: str, num_classes: Optional[int] = None):
    """name → metric instance."""
    metric_map = {
        "accuracy": Accuracy,
        "balanced_accuracy": BalancedAccuracy,
        "binary_f1": BinaryF1Score,
        "multiclass_f1": lambda: MulticlassBinaryF1Score(num_classes),
        "map": MeanAveragePrecision,
        "mAP": MeanAveragePrecision,
        "average_precision": AveragePrecision,
        "roc_auc": ROCAUC,
    }
    if metric_name not in metric_map:
        raise ValueError(f"Unknown metric: {metric_name}")
    return metric_map[metric_name]()
