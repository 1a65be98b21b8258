"""Training strategies: how a batch becomes (loss, metrics).

Port of ``avex_tpu/training/strategies.py``. A strategy runs the model's
:meth:`~avex_tpu_torch.models.base.ModelBase.train_forward` on a batch and
applies its criterion; selection by ``label_type`` follows the JAX factory:

- ``supervised`` → :class:`SupervisedStrategy` (CE/BCE/focal on logits)
- ``text``       → :class:`CLIPStrategy` (needs ``models/clip.py``: not ported)
- ``self_supervised`` → :class:`EATSSLStrategy` (needs ``models/eat_ssl.py``: not ported)

The model's parameters live in its module, so a strategy takes the forward
callable, the batch (tensors on the model's device) and the random generator.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from avex_tpu_torch.training.losses import build_criterion

__all__ = ["CLIPStrategy", "EATSSLStrategy", "SupervisedStrategy", "make_strategy"]

Batch = Dict[str, Any]


class SupervisedStrategy:
    """Logits vs (one-hot or index) labels under the configured criterion."""

    def __init__(self, loss_function: str = "cross_entropy", multilabel: bool = False):
        self.criterion = build_criterion(loss_function)
        self.multilabel = multilabel

    def forward_loss(
        self,
        apply_fn: Callable,
        batch: Batch,
        generator: Optional[torch.Generator],
        train: bool,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Model forward + criterion; returns (loss, step metrics).

        In training with a generator, dropout and LayerDrop draw from it
        (``disable_layerdrop=False``), as the JAX strategy passes its
        ``dropout`` and ``layerdrop`` keys.
        """
        kwargs: Dict[str, Any] = {"deterministic": not train}
        if train and generator is not None:
            kwargs["generator"] = generator
            kwargs["disable_layerdrop"] = False
        out = apply_fn(batch["raw_wav"], batch.get("padding_mask"), **kwargs)
        logits = out[0] if isinstance(out, tuple) else out
        labels = batch["label"]
        loss = self.criterion(logits, labels)
        label_idx = labels.argmax(-1) if labels.ndim == 2 else labels
        metrics = {
            "logits": logits,
            "correct": (logits.argmax(dim=-1) == label_idx).sum(),
            "count": logits.shape[0],
            # NaN/Inf guard: counted on the device, reported by MetricsTracker
            "nonfinite_logits": (~torch.isfinite(logits)).sum(),
        }
        return loss, metrics


class CLIPStrategy:
    """Audio-text contrastive training: needs the CLIP model, not ported."""

    def __init__(self) -> None:
        raise NotImplementedError(
            "CLIPStrategy needs models/clip.py, which is not ported yet (ROADMAP queue 1, item 10)"
        )


class EATSSLStrategy:
    """Self-supervised EAT pretraining: needs the EAT-SSL model, not ported."""

    def __init__(self) -> None:
        raise NotImplementedError(
            "EATSSLStrategy needs models/eat_ssl.py, which is not ported yet (ROADMAP queue 1, item 10)"
        )


def make_strategy(label_type: str, loss_function: str = "cross_entropy", multilabel: bool = False):
    """label_type → strategy."""
    if label_type == "supervised":
        return SupervisedStrategy(loss_function, multilabel)
    if label_type == "text":
        return CLIPStrategy()
    if label_type == "self_supervised":
        return EATSSLStrategy()
    raise ValueError(f"Unknown label_type: {label_type}")
