"""Experiment logging: MLflow, W&B or local JSONL only.

Port of ``avex_tpu/utils/experiment_logger.py``: one interface
(``log_params`` / ``log_metrics`` / ``finalize``) with the backend chosen by
name. ``mlflow`` and ``wandb`` are imported only when asked for; when the
package is missing the logger warns and keeps the local record alone, as the
JAX package does (a logging backend, not a device). With an ``output_dir``
every call is also appended to ``<output_dir>/metrics.jsonl``. In a
multi-process run only the main process (rank 0) logs: on the others the
logger starts no backend and records nothing.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

from avex_tpu_torch.parallel import is_main_process

__all__ = ["ExperimentLogger"]

logger = logging.getLogger(__name__)


class ExperimentLogger:
    """Backend-agnostic metrics and parameters logger."""

    def __init__(
        self,
        backend: str = "none",
        run_name: Optional[str] = None,
        logging_uri: Optional[str] = None,
        project: str = "audio-experiments",
        output_dir: Optional[str] = None,
    ) -> None:
        self.run_name = run_name or f"run_{int(time.time())}"
        self._mlflow = None
        self._wandb = None
        self._jsonl_path: Optional[Path] = None
        if not is_main_process():
            backend, output_dir = "none", None
        self.backend = backend
        if output_dir:
            self._jsonl_path = Path(output_dir) / "metrics.jsonl"
            self._jsonl_path.parent.mkdir(parents=True, exist_ok=True)
        if backend == "mlflow":
            try:
                import mlflow

                if logging_uri:
                    mlflow.set_tracking_uri(logging_uri)
                mlflow.start_run(run_name=self.run_name)
                self._mlflow = mlflow
            except ImportError:
                logger.warning("mlflow not installed; falling back to local jsonl logging")
                self.backend = "none"
        elif backend == "wandb":
            try:
                import wandb

                wandb.init(project=project, name=self.run_name)
                self._wandb = wandb
            except ImportError:
                logger.warning("wandb not installed; falling back to local jsonl logging")
                self.backend = "none"

    def _append(self, record: Dict[str, Any]) -> None:
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def log_params(self, params: Dict[str, Any]) -> None:
        """Record the run's hyper-parameters once."""
        if self._mlflow:
            self._mlflow.log_params({k: str(v)[:250] for k, v in params.items()})
        elif self._wandb:
            self._wandb.config.update(params, allow_val_change=True)
        self._append({"type": "params", "params": _jsonable(params)})

    def log_metrics(self, metrics: Dict[str, float], step: int = 0, split: str = "") -> None:
        """Record step or epoch metrics (numbers only) under ``split/``."""
        named = {f"{split}/{k}" if split else k: float(v) for k, v in metrics.items() if _is_num(v)}
        if self._mlflow:
            self._mlflow.log_metrics(named, step=step)
        elif self._wandb:
            self._wandb.log(named, step=step)
        self._append({"type": "metrics", "step": step, "metrics": named})

    def finalize(self) -> None:
        """Close the backend's run."""
        if self._mlflow:
            self._mlflow.end_run()
        if self._wandb:
            self._wandb.finish()


def _is_num(v: Any) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _jsonable(obj: Any) -> Any:
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        return str(obj)
