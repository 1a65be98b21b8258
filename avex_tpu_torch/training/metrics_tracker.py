"""Per-epoch metric accumulation.

Port of ``avex_tpu/training/metrics_tracker.py``: accumulates the loss and
the mode's statistics over steps, then reports an epoch summary. Step
metrics may be tensors on the card; each is brought to the host once, when
the step is recorded.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from avex_tpu_torch.metrics import get_metric_class

__all__ = ["MetricsTracker"]

logger = logging.getLogger(__name__)


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


class MetricsTracker:
    """Accumulate step metrics for one of the supervised / clip / ssl modes."""

    def __init__(
        self,
        mode: str = "supervised",
        metric_names: Optional[List[str]] = None,
        num_classes: Optional[int] = None,
    ) -> None:
        self.mode = mode
        self.metric_names = metric_names or ["accuracy"]
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        """Clear all accumulated state for a new epoch."""
        self.loss_sum = 0.0
        self.sample_count = 0
        self.correct = 0
        self.a2t_correct = 0
        self.t2a_correct = 0
        self.ssl_losses: Dict[str, float] = {}
        self._calculators = {name: get_metric_class(name, self.num_classes) for name in self.metric_names}

    def update(self, loss, step_metrics: Dict, labels=None) -> None:
        """Accumulate one step's loss and the mode's statistics.

        Non-finite losses and model outputs log a warning, with the finite
        outputs' range, so that a blow-up can be read from the log.
        """
        count = int(_host(step_metrics.get("count", 0)))
        loss_value = float(_host(loss))
        if not np.isfinite(loss_value):
            logger.warning("Non-finite loss detected: %s", loss_value)
        self.loss_sum += loss_value * max(count, 1)
        self.sample_count += count
        nonfinite = step_metrics.get("nonfinite_logits")
        if nonfinite is not None and int(_host(nonfinite)) > 0:
            msg = f"{int(_host(nonfinite))} non-finite values in model outputs!"
            if "logits" in step_metrics:
                logits = _host(step_metrics["logits"])
                finite = logits[np.isfinite(logits)]
                if finite.size:
                    msg += f" finite stats: min={finite.min():.6f} max={finite.max():.6f} mean={finite.mean():.6f}"
            logger.warning(msg)
        if self.mode == "supervised":
            self.correct += int(_host(step_metrics.get("correct", 0)))
            if labels is not None and "logits" in step_metrics:
                logits = _host(step_metrics["logits"])
                for calc in self._calculators.values():
                    calc.update(logits, _host(labels))
        elif self.mode == "clip":
            self.a2t_correct += int(_host(step_metrics.get("a2t_correct", 0)))
            self.t2a_correct += int(_host(step_metrics.get("t2a_correct", 0)))
        else:  # ssl
            for key, value in step_metrics.items():
                if key.startswith("loss_"):
                    self.ssl_losses[key] = self.ssl_losses.get(key, 0.0) + float(_host(value))

    @property
    def avg_loss(self) -> float:
        """Mean loss over the epoch so far."""
        return self.loss_sum / max(self.sample_count, 1)

    def epoch_metrics(self) -> Dict[str, float]:
        """Epoch summary: loss plus the mode's metric values."""
        out = {"loss": self.avg_loss, "samples": float(self.sample_count)}
        if self.mode == "supervised":
            out["accuracy_running"] = self.correct / max(self.sample_count, 1)
            for name, calc in self._calculators.items():
                try:
                    out[name] = calc.get_primary_metric()
                except Exception:
                    out[name] = 0.0
        elif self.mode == "clip":
            out["a2t_accuracy"] = self.a2t_correct / max(self.sample_count, 1)
            out["t2a_accuracy"] = self.t2a_correct / max(self.sample_count, 1)
        else:
            for key, value in self.ssl_losses.items():
                out[key] = value / max(self.sample_count, 1)
        return out

    def primary_metric(self) -> float:
        """The first configured metric, which selects the best checkpoint."""
        metrics = self.epoch_metrics()
        if self.mode == "supervised" and self.metric_names:
            return metrics.get(self.metric_names[0], 0.0)
        if self.mode == "clip":
            return 0.5 * (metrics["a2t_accuracy"] + metrics["t2a_accuracy"])
        return -metrics["loss"]
