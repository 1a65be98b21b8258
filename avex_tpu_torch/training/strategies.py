"""Training strategies: how a batch becomes (loss, metrics).

Port of ``avex_tpu/training/strategies.py``. A strategy runs the model's
:meth:`~avex_tpu_torch.models.base.ModelBase.train_forward` on a batch and
applies its criterion; selection by ``label_type`` follows the JAX factory:

- ``supervised`` → :class:`SupervisedStrategy` (CE/BCE/focal on logits)
- ``text``       → :class:`CLIPStrategy` (symmetric contrastive)
- ``self_supervised`` → :class:`EATSSLStrategy` (model-reported losses)

The model's parameters live in its module, so a strategy takes the forward
callable, the batch (tensors on the model's device) and the random generator.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from avex_tpu_torch.parallel import batch_mesh
from avex_tpu_torch.training.losses import build_criterion, clip_loss

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
    """Audio-text contrastive training. The model's forward returns a dict
    with ``audio_features``, ``text_features`` and ``logit_scale``; the batch
    holds ``text_tokens`` (the ``Trainer`` tokenizes ``text_label``). The
    metrics are the batch's a2t and t2a top-1 counts; in a multi-rank step
    the batch is the global one (:func:`~avex_tpu_torch.training.losses.clip_loss`)."""

    def forward_loss(
        self,
        apply_fn: Callable,
        batch: Batch,
        generator: Optional[torch.Generator],
        train: bool,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Both towers' forward + the symmetric InfoNCE loss."""
        kwargs: Dict[str, Any] = {"deterministic": not train}
        if train and generator is not None:
            kwargs["generator"] = generator
        out = apply_fn(batch["raw_wav"], batch.get("text_tokens"), batch.get("padding_mask"), **kwargs)
        features = out[0] if isinstance(out, tuple) else out
        loss, aux = clip_loss(features["audio_features"], features["text_features"], features["logit_scale"])
        mesh = batch_mesh()
        metrics = {
            "a2t_correct": aux["a2t_correct"],
            "t2a_correct": aux["t2a_correct"],
            "count": features["audio_features"].shape[0] * (mesh.size if mesh is not None else 1),
        }
        return loss, metrics


class EATSSLStrategy:
    """Self-supervised (data2vec-style) training: the model reports its own
    loss components, ``{"losses": {...}, "sample_size": n}``; the loss is
    their sum over ``max(n, 1)``, the metrics ``loss_<name>`` and ``count``.
    The step's generator feeds the model's mask draw.

    In a multi-rank step ``n`` is summed over the ranks first, as JAX's is
    over the global batch, and a rank's loss is its share of that global
    loss times the rank count: the mean over ranks, which the gradient
    all-reduce takes, is the global loss."""

    def forward_loss(
        self,
        apply_fn: Callable,
        batch: Batch,
        generator: Optional[torch.Generator],
        train: bool,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Total of the model-reported SSL loss components."""
        if not train:
            # The module's deterministic path returns features, not losses:
            # the JAX strategy then indexes an array with "losses" and fails.
            raise ValueError(
                "self_supervised training has no validation loss: the model's deterministic "
                "path returns the student's features, not losses (the JAX package's eval step "
                "fails here too); train without a validation loader or with skip_validation"
            )
        out = apply_fn(batch["raw_wav"], batch.get("padding_mask"), deterministic=False, generator=generator)
        result = out[0] if isinstance(out, tuple) else out
        losses = result["losses"]
        sample_size = result.get("sample_size", 1)
        total = sum(v.sum() for v in losses.values())
        mesh = batch_mesh()
        if mesh is None:
            total = total / max(sample_size, 1)
        else:
            ranks_size = torch.tensor([float(sample_size)], device=total.device)
            torch.distributed.all_reduce(ranks_size, group=mesh.group)
            total = total * mesh.size / ranks_size.clamp_min(1.0)[0]
        metrics: Dict[str, Any] = {f"loss_{k}": v.sum() for k, v in losses.items()}
        metrics["count"] = sample_size
        return total, metrics


def make_strategy(label_type: str, loss_function: str = "cross_entropy", multilabel: bool = False):
    """label_type → strategy."""
    if label_type == "supervised":
        return SupervisedStrategy(loss_function, multilabel)
    if label_type == "text":
        return CLIPStrategy()
    if label_type == "self_supervised":
        return EATSSLStrategy()
    raise ValueError(f"Unknown label_type: {label_type}")
