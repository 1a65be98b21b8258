"""Training runtime of the port: Trainer, strategies, losses, optimizers, checkpoints."""

from avex_tpu_torch.training.checkpoint import CheckpointManager
from avex_tpu_torch.training.losses import build_criterion, clip_loss
from avex_tpu_torch.training.metrics_tracker import MetricsTracker
from avex_tpu_torch.training.optimizers import build_scheduler, get_optimizer, make_optimizer
from avex_tpu_torch.training.strategies import make_strategy
from avex_tpu_torch.training.train import Trainer, TrainState
from avex_tpu_torch.training.trainer_factory import TrainerFactory

__all__ = [
    "CheckpointManager",
    "MetricsTracker",
    "TrainState",
    "Trainer",
    "TrainerFactory",
    "build_criterion",
    "build_scheduler",
    "clip_loss",
    "get_optimizer",
    "make_optimizer",
    "make_strategy",
]
