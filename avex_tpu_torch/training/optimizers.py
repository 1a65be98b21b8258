"""Optimizer and learning-rate schedule factories.

Port of ``avex_tpu/training/optimizers.py`` with optax's numbers, written out
for named PyTorch tensors:

- a schedule is a function of the update count *before* the update, so the
  first update of a warmup schedule uses lr 0;
- ``warmup_cosine_decay_schedule`` counts ``decay_steps`` including the
  warmup; the linear schedule is a warmup joined to a linear decay;
- the optimizer is optax's chain ``[clip_by_global_norm] → scale_by_adam →
  [add_decayed_weights] → scale_by_learning_rate``: Adam moments with the
  bias correction computed in fp32, decay ``wd · p`` added after the Adam
  step, then ``p += -lr · u``. Global-norm clipping is optax's
  ``(g / norm) · max_norm`` when ``norm >= max_norm`` (not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm);
- ``adamw`` decays the tensors :func:`_weight_decay_mask` selects;
  ``adamw8bit`` keeps the first moment in bf16 and, as the JAX package passes
  it no mask, decays every parameter (biases and norms included).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

__all__ = ["AdamW", "build_scheduler", "get_optimizer", "make_optimizer"]

Schedule = Callable[[int], float]

#: JAX leaf names that are never decayed
_NO_DECAY = ("bias", "scale", "embedding", "grep_a", "layer_weights", "logit_scale")


def _weight_decay_mask(module: nn.Module) -> Dict[str, bool]:
    """Parameter name → decayed: tensors of two or more dimensions, except
    those whose JAX leaf is named ``bias``, ``scale``, ``embedding``,
    ``grep_a``, ``layer_weights`` or ``logit_scale``. A norm layer's
    ``weight`` is JAX's ``scale`` and an ``nn.Embedding``'s is its
    ``embedding``; so BEATs' 4-D ``grep_a`` and its relative-position table
    stay undecayed, while the patch embedding and ``pos_conv`` are decayed."""
    mask: Dict[str, bool] = {}
    for owner_name, owner in module.named_modules():
        for leaf, param in owner.named_parameters(recurse=False):
            jax_leaf = leaf
            if isinstance(owner, nn.Embedding):
                jax_leaf = "embedding"
            elif isinstance(owner, (nn.LayerNorm, nn.GroupNorm)) and leaf == "weight":
                jax_leaf = "scale"
            name = f"{owner_name}.{leaf}" if owner_name else leaf
            mask[name] = jax_leaf not in _NO_DECAY and param.ndim >= 2
    return mask


def _linear_schedule(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        return (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end

    return schedule


def _cosine_decay_schedule(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}.")

    def schedule(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _join_schedules(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else second(count - boundary)


def build_scheduler(
    name: str = "none",
    base_lr: float = 1e-3,
    warmup_steps: int = 0,
    total_steps: int = 10_000,
    min_lr: float = 0.0,
) -> Schedule:
    """LR schedule: none / cosine / linear (+ warmup), as the JAX package builds it with optax."""
    if name in ("none", None):
        if warmup_steps > 0:
            return _linear_schedule(0.0, base_lr, warmup_steps)
        return lambda count: base_lr
    if name == "cosine":
        decay_steps = max(total_steps, warmup_steps + 1)
        alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr
        warm = _linear_schedule(0.0 if warmup_steps else base_lr, base_lr, warmup_steps)
        return _join_schedules(warm, _cosine_decay_schedule(base_lr, decay_steps - warmup_steps, alpha),
                               warmup_steps)
    if name in ("linear", "step"):
        warm = _linear_schedule(0.0, base_lr, max(warmup_steps, 1))
        decay = _linear_schedule(base_lr, min_lr, max(total_steps - warmup_steps, 1))
        return _join_schedules(warm, decay, max(warmup_steps, 1))
    raise ValueError(f"Unknown scheduler: {name}")


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` as optax computes it in fp32: the power correctly
    rounded to fp32 (XLA's), then the difference in fp32. Held as a Python
    float of that fp32 value, so dividing by it moves nothing to the device.
    At b2 = 0.999 one unit in the last place of the power is ~2e-5 of the
    correction, so the rounding has to match."""
    power = np.float32(np.float64(np.float32(decay)) ** count)
    return float(np.float32(1.0) - power)


class AdamW:
    """optax's ``adam`` / ``adamw`` chain over named tensors, updating in place.

    ``learning_rate`` is a float or a schedule of the update count.
    ``decay_mask`` maps a name to whether ``weight_decay`` applies to it
    (None: every tensor). ``mu_dtype`` stores the first moment in another
    type (bf16 for ``adamw8bit``). ``clip_norm`` clips the gradients by their
    global norm first. The state is a plain dict (``count``, ``mu``, ``nu``)
    that ``torch.save`` stores.
    """

    def __init__(
        self,
        learning_rate: Union[float, Schedule],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        decay_mask: Optional[Mapping[str, bool]] = None,
        mu_dtype: Optional[torch.dtype] = None,
        clip_norm: Optional[float] = None,
    ) -> None:
        self.schedule = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_mask = dict(decay_mask) if decay_mask is not None else None
        self.mu_dtype = mu_dtype
        self.clip_norm = clip_norm

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """Zero moments for ``params`` and an update count of 0."""
        return {
            "count": 0,
            "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        }

    def _decays(self, name: str) -> bool:
        return bool(self.weight_decay) and (self.decay_mask is None or self.decay_mask.get(name, False))

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state: Dict[str, Any], global_norm: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` (in place) from ``grads``; ``state`` is updated in place.

        ``global_norm`` is the clipping norm of the whole gradient where
        ``grads`` holds only this rank's blocks of it (the ZeRO-3 layout);
        by default it is the norm of ``grads``."""
        if self.clip_norm:
            # The norm stays on the device: no host sync in the step.
            norm = global_norm if global_norm is not None else torch.sqrt(
                sum(g.float().square().sum() for g in grads.values()))
            keep = norm < self.clip_norm
            grads = {n: torch.where(keep, g, (g / norm.to(g.dtype)) * self.clip_norm) for n, g in grads.items()}
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        correction1, correction2 = _bias_correction(self.b1, count), _bias_correction(self.b2, count)
        for name, g in grads.items():
            p = params[name]
            old_mu = state["mu"][name]
            # b1 takes the moment's type first, as JAX's weak-typed scalar does
            # (bf16 0.9 is 0.8984375 in adamw8bit)
            mu = (1.0 - self.b1) * g + float(torch.tensor(self.b1, dtype=old_mu.dtype)) * old_mu
            nu = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"][name]
            update = (mu / correction1) / (torch.sqrt(nu / correction2) + self.eps)
            if self._decays(name):
                update = update + self.weight_decay * p
            p.add_(-lr * update)
            state["mu"][name] = mu.to(old_mu.dtype)
            state["nu"][name] = nu
        state["count"] = count


def get_optimizer(
    name: str,
    learning_rate: Union[float, Schedule],
    weight_decay: float = 0.0,
    adam_betas: Optional[Tuple[float, float]] = None,
    gradient_clip_val: Optional[float] = None,
    params: Optional[nn.Module] = None,
) -> AdamW:
    """Build the optimizer chain: ``adam``, ``adamw`` (decay masked by
    :func:`_weight_decay_mask` of the module ``params``) or ``adamw8bit``
    (bf16 first moment, every parameter decayed), with global-norm clipping
    in front when ``gradient_clip_val`` is set."""
    b1, b2 = adam_betas or (0.9, 0.999)
    if name == "adam":
        return AdamW(learning_rate, b1, b2, clip_norm=gradient_clip_val)
    if name == "adamw":
        mask = _weight_decay_mask(params) if weight_decay and params is not None else None
        return AdamW(learning_rate, b1, b2, weight_decay=weight_decay, decay_mask=mask,
                     clip_norm=gradient_clip_val)
    if name == "adamw8bit":
        return AdamW(learning_rate, b1, b2, weight_decay=weight_decay, mu_dtype=torch.bfloat16,
                     clip_norm=gradient_clip_val)
    raise ValueError(f"Unknown optimizer: {name}")


def make_optimizer(
    training_params,
    scheduler_config=None,
    total_steps: int = 10_000,
    params: Optional[nn.Module] = None,
    lr_override: Optional[float] = None,
) -> Tuple[AdamW, Schedule]:
    """Wire TrainingParams + SchedulerConfig into (optimizer, schedule)."""
    base_lr = lr_override if lr_override is not None else training_params.lr
    sched_name, warmup, min_lr = "none", 0, 0.0
    if scheduler_config is not None:
        sched_name = scheduler_config.name
        warmup = scheduler_config.warmup_steps
        min_lr = scheduler_config.min_lr
    elif training_params.scheduler_type != "none":
        sched_name = training_params.scheduler_type
    schedule = build_scheduler(sched_name, base_lr, warmup, total_steps, min_lr)
    tx = get_optimizer(
        training_params.optimizer,
        schedule,
        weight_decay=training_params.weight_decay,
        adam_betas=training_params.adam_betas,
        gradient_clip_val=training_params.gradient_clip_val,
        params=params,
    )
    return tx, schedule
