"""Training losses: cross-entropy, BCE, focal, CLIP contrastive.

Port of ``avex_tpu/training/losses.py``. Every loss computes in fp32 from
logits of any type, as the JAX package does; integer targets are class
indices and are one-hot encoded here.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from avex_tpu_torch.parallel import batch_mesh, gather_rows

__all__ = [
    "MAX_LOGIT_SCALE",
    "bce_loss",
    "build_criterion",
    "clip_loss",
    "cross_entropy_loss",
    "focal_loss",
]

#: ln(100) clamp on the CLIP temperature, as in the reference
MAX_LOGIT_SCALE = math.log(100.0)


def _dense_targets(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Class indices → one-hot; one-hot or multi-hot targets as they are; fp32."""
    if targets.ndim == 1 and logits.ndim == 2:
        targets = F.one_hot(targets.long(), logits.shape[-1])
    return targets.float()


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy. ``targets`` may be indices or one-hot."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -(_dense_targets(logits, targets) * logprobs).sum(dim=-1).mean()


def _bce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The stable elementwise sigmoid cross-entropy ``max(x, 0) - x·y + log1p(exp(-|x|))``."""
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy over all label positions."""
    targets = _dense_targets(logits, targets)
    return _bce_terms(logits.float(), targets).mean()


def focal_loss(
    logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0, alpha: float = 0.25
) -> torch.Tensor:
    """Sigmoid focal loss."""
    targets = _dense_targets(logits, targets)
    logits = logits.float()
    p = torch.sigmoid(logits)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return (alpha_t * (1.0 - p_t) ** gamma * _bce_terms(logits, targets)).mean()


def clip_loss(
    audio_features: torch.Tensor, text_features: torch.Tensor, logit_scale: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE over the (global) batch.

    Features are L2-normalised here; ``logit_scale`` is the *log*
    temperature, clamped at ln(100). Returns ``(loss, aux)`` with the a2t and
    t2a top-1 counts. Inside a multi-rank
    :func:`~avex_tpu_torch.parallel.global_batch` both feature sets are
    first gathered over the ranks with their gradient (the reference's
    ``gather_features`` with ``local_loss=False``), so every rank computes
    the loss and the counts of the global batch, as JAX's similarity over a
    data-sharded batch does.
    """
    mesh = batch_mesh()
    if mesh is not None:
        audio_features, text_features = gather_rows(audio_features, mesh), gather_rows(text_features, mesh)
    audio = audio_features / audio_features.norm(dim=-1, keepdim=True)
    text = text_features / text_features.norm(dim=-1, keepdim=True)
    scale = torch.exp(logit_scale.clamp(max=MAX_LOGIT_SCALE))
    logits_a2t = scale * (audio @ text.T).float()
    logits_t2a = logits_a2t.T
    labels = torch.arange(logits_a2t.shape[0], device=logits_a2t.device)
    loss = 0.5 * (cross_entropy_loss(logits_a2t, labels) + cross_entropy_loss(logits_t2a, labels))
    aux = {
        "a2t_correct": (logits_a2t.argmax(dim=1) == labels).sum(),
        "t2a_correct": (logits_t2a.argmax(dim=1) == labels).sum(),
    }
    return loss, aux


def build_criterion(loss_function: str):
    """name → loss callable."""
    table = {"cross_entropy": cross_entropy_loss, "bce": bce_loss, "focal": focal_loss, "clip": clip_loss}
    if loss_function not in table:
        raise ValueError(f"Unknown loss function: {loss_function}")
    return table[loss_function]
