"""TrainerFactory: one-call construction of a wired :class:`Trainer`.

Port of ``avex_tpu/training/trainer_factory.py``; the label_type → strategy
mapping lives in :func:`avex_tpu_torch.training.strategies.make_strategy`.
"""

from __future__ import annotations

from typing import Iterable, Optional

from avex_tpu_torch.configs import RunConfig
from avex_tpu_torch.training.train import Trainer

__all__ = ["TrainerFactory"]


class TrainerFactory:
    """Build fully-wired Trainers from RunConfigs."""

    @staticmethod
    def create_trainer(
        model,
        config: RunConfig,
        train_loader: Iterable,
        val_loader: Optional[Iterable] = None,
        mesh=None,
        exp_logger=None,
    ) -> Trainer:
        """A :class:`Trainer` for ``model``; with ``gradient_checkpointing``
        the model checkpoints its layers first, where it supports that."""
        if config.training_params.gradient_checkpointing:
            try:
                model.enable_gradient_checkpointing()
            except NotImplementedError:
                pass
        return Trainer(model, config, train_loader, val_loader, mesh=mesh, exp_logger=exp_logger)
