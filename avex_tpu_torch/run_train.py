"""Training entry point: RunConfig → data → model → Trainer.

Port of ``avex_tpu/run_train.py``: builds the loaders
(:func:`avex_tpu_torch.data.build_dataloaders`), the model with the train
split's class count and label map, the experiment logger (``metrics.jsonl``
in ``output_dir``) and the :class:`~avex_tpu_torch.training.Trainer`, and runs
the whole loop. The model and its batches go on ``config.device``: ``cuda``
unless the config names ``cpu``; without a card ``cuda`` raises.

The JAX entry point first turns on XLA's persistent compilation cache; the
port has nothing to cache there (eager PyTorch, and each CUDA kernel is built
once into ``build/`` at its first use), so that step is gone.

A multi-process run: with ``distributed=True`` the process joins the run's
process group (``parallel.init_multihost``: SLURM's environment names the
coordinator, the process count and the rank; NCCL on ``cuda``, gloo on
``cpu``), unless the caller has started one. Each process then takes its
card, its shard of the data and the ``Trainer``'s data-parallel step
(``RunConfig.mesh``); only rank 0 logs and writes.

    python -m avex_tpu_torch.run_train --config configs/run_configs/beats_supervised_example.yml device=cpu

reads a YAML file (PyYAML) and ``key=value`` patches; without PyYAML, build
the :class:`~avex_tpu_torch.configs.RunConfig` from a dict and call :func:`main`.
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, List, Optional

from avex_tpu_torch.configs import RunConfig
from avex_tpu_torch.data import build_dataloaders
from avex_tpu_torch.models.factory import build_model_from_spec
from avex_tpu_torch.parallel import init_multihost, is_main_process, rank_device, world_size
from avex_tpu_torch.training import Trainer
from avex_tpu_torch.utils.experiment_logger import ExperimentLogger

__all__ = ["main"]

logger = logging.getLogger(__name__)


def main(config: RunConfig) -> Dict[str, Any]:
    """Run one training job and return the Trainer's result summary."""
    if config.distributed and world_size() == 1:
        init_multihost(device=config.device)
    train_loader, val_loader, _test_loader, label_map, num_classes = build_dataloaders(config)
    logger.info("Datasets ready: %d classes", num_classes)

    model = build_model_from_spec(config.model_spec, device=str(rank_device(config.device)),
                                  num_classes=num_classes)
    model.label_mapping = label_map

    exp_logger = None
    if is_main_process():
        exp_logger = ExperimentLogger(backend=config.logging, run_name=config.run_name,
                                      logging_uri=config.logging_uri, project=config.wandb_project,
                                      output_dir=config.output_dir)
        exp_logger.log_params({
            "model": config.model_spec.name,
            "lr": config.training_params.lr,
            "batch_size": config.training_params.batch_size,
            "epochs": config.training_params.train_epochs,
            "loss": config.loss_function,
        })
    trainer = Trainer(model, config, train_loader, val_loader, exp_logger=exp_logger,
                      checkpoint_every_epochs=config.checkpoint_freq)
    result = trainer.train()
    if exp_logger is not None:
        exp_logger.finalize()
    return result


def cli(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """``--config <yaml>`` plus ``key=value`` patches → :func:`main`."""
    parser = argparse.ArgumentParser(description="Train a model from a run config.")
    parser.add_argument("--config", "-c", required=True, help="YAML run config")
    parser.add_argument("patches", nargs="*", help="key=value overrides, dotted keys for nested fields")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return main(RunConfig.from_sources(args.config, args.patches))


if __name__ == "__main__":
    cli()
