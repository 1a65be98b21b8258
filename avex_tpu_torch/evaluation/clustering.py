"""Clustering evaluation: KMeans at the true K → ARI / NMI / V-measure.

Port of ``avex_tpu/evaluation/clustering.py``: host-side scikit-learn, as in
the JAX package, imported where it is called (the machine with the card has
none; nothing on its path clusters).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["eval_clustering", "eval_clustering_multi_k"]


def eval_clustering(embeddings: Any, labels: Any, n_clusters: Optional[int] = None,
                    seed: int = 42) -> Dict[str, float]:
    """KMeans at K = the number of classes (by default), scored against the labels."""
    try:
        from sklearn.cluster import KMeans
        from sklearn.metrics import adjusted_rand_score, normalized_mutual_info_score, v_measure_score
    except ImportError as err:
        raise ImportError("clustering evaluation needs scikit-learn (sklearn)") from err
    if isinstance(embeddings, torch.Tensor):
        embeddings = embeddings.float().cpu().numpy()
    labels = labels.cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
    if labels.ndim == 2:
        labels = labels.argmax(axis=1)
    k = n_clusters or len(np.unique(labels))
    embeddings = np.asarray(embeddings, dtype=np.float32).reshape(len(labels), -1)
    preds = KMeans(n_clusters=k, random_state=seed, n_init=10).fit_predict(embeddings)
    return {
        "ari": float(adjusted_rand_score(labels, preds)),
        "nmi": float(normalized_mutual_info_score(labels, preds)),
        "v_measure": float(v_measure_score(labels, preds)),
        "n_clusters": float(k),
    }


def eval_clustering_multi_k(embeddings: Any, labels: Any, k_values: Sequence[int],
                            seed: int = 42) -> Dict[int, Dict[str, float]]:
    """KMeans over several K values."""
    return {int(k): eval_clustering(embeddings, labels, n_clusters=int(k), seed=seed) for k in k_values}
