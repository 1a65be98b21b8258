"""During-training clustering evaluation.

Port of ``avex_tpu/training/clustering_evaluator.py``: every ``frequency``
epochs, extract
mean-pooled embeddings of the validation set, up to ``max_samples``, and
score KMeans at the true K (ARI / NMI / V-measure). It needs scikit-learn:
without it the constructor raises ``ImportError``, and the ``Trainer`` logs
that and runs without it.
"""

from __future__ import annotations

import importlib.util
import logging
from typing import Dict, Iterable, List

import numpy as np
import torch

from avex_tpu_torch.configs import ClusteringEvalConfig
from avex_tpu_torch.evaluation.clustering import eval_clustering

__all__ = ["ClusteringEvaluator"]

logger = logging.getLogger(__name__)


class ClusteringEvaluator:
    """Periodic clustering probe over the model's embeddings."""

    def __init__(self, model, config: ClusteringEvalConfig, loader: Iterable, num_classes: int,
                 seed: int = 42) -> None:
        if config.enabled and importlib.util.find_spec("sklearn") is None:
            raise ImportError("clustering evaluation needs scikit-learn (sklearn)")
        self.model = model
        self.config = config
        self.loader = loader
        self.num_classes = num_classes
        self.seed = seed
        self.model.register_hooks_for_layers([config.layers])

    def should_run(self, epoch: int) -> bool:
        """Whether the evaluation runs after ``epoch`` (-1: before training)."""
        if not self.config.enabled:
            return False
        if epoch < 0:
            return self.config.run_before_training
        return (epoch + 1) % self.config.frequency == 0

    def evaluate(self) -> Dict[str, float]:
        """Extract embeddings and score KMeans clustering."""
        embeddings: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        seen = 0
        limit = self.config.max_samples
        for batch in self.loader:
            emb = self.model.extract_embeddings(batch["raw_wav"], padding_mask=batch.get("padding_mask"),
                                                aggregation="mean")
            embeddings.append(emb.float().cpu().numpy() if isinstance(emb, torch.Tensor) else np.asarray(emb))
            label = batch["label"]
            labels.append(label.cpu().numpy() if isinstance(label, torch.Tensor) else np.asarray(label))
            seen += embeddings[-1].shape[0]
            if limit and seen >= limit:
                break
        embs = np.concatenate(embeddings)[: limit or None]
        labs = np.concatenate(labels)[: limit or None]
        metrics = eval_clustering(embs, labs, n_clusters=self.num_classes, seed=self.seed)
        logger.info("clustering eval: %s", metrics)
        return metrics
