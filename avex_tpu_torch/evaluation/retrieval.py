"""Retrieval evaluation: cosine-similarity ROC-AUC and precision@1.

Port of ``avex_tpu/evaluation/retrieval.py``. The similarity matrix is one
fp32 product on ``device``, rows normalised with a 1e-12 floor: the card
unless the caller passes ``device="cpu"``, whatever the inputs (numpy arrays,
as the extraction loop and the cache return, or tensors) lie on. The
statistics run on the host. ROC-AUC needs no scikit-learn: it is the
Mann–Whitney statistic with average ranks (``scipy.stats.rankdata``), which
equals ``roc_auc_score`` with ties too. A set whose pairs are all positive or
all negative scores 0.0, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from scipy.stats import rankdata

from avex_tpu_torch.models.base import resolve_device
from avex_tpu_torch.ops._precision import full_fp32

__all__ = ["cosine_similarity", "eval_retrieval", "eval_retrieval_cross_set", "labels_to_indices", "roc_auc"]


def labels_to_indices(labels: Any) -> np.ndarray:
    """One-hot → index conversion."""
    labels = labels.cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
    if labels.ndim == 2:
        return labels.argmax(axis=1)
    return labels.astype(np.int64)


def _unit_rows(x: Any, device: torch.device) -> torch.Tensor:
    x = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device, torch.float32)
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def cosine_similarity(a: Any, b: Any, device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """``[Na, Nb]`` cosine similarities in fp32 on ``device`` (``cuda`` unless
    named; no TF32)."""
    device = resolve_device(device)
    a, b = _unit_rows(a, device), _unit_rows(b, device)
    with full_fp32():
        return a @ b.T


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve of binary ``labels`` against ``scores``: the
    Mann–Whitney U over the positives' average ranks."""
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    ranks = rankdata(scores)  # average ranks over ties
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _retrieval_metrics(sim: np.ndarray, query_labels: np.ndarray, db_labels: np.ndarray,
                       exclude_self: bool) -> Dict[str, float]:
    n_query = sim.shape[0]
    if exclude_self:
        np.fill_diagonal(sim, -np.inf)
    # precision@1: the nearest neighbour shares the query's label
    nearest = sim.argmax(axis=1)
    p_at_1 = float(np.mean(db_labels[nearest] == query_labels))
    # ROC-AUC: same-label pairs positive, the similarity as the score, self-pairs out
    positives = (query_labels[:, None] == db_labels[None, :]).astype(np.int64)
    mask = np.ones_like(sim, dtype=bool)
    if exclude_self:
        np.fill_diagonal(mask, False)
    flat_scores, flat_pos = sim[mask], positives[mask]
    auc = 0.0 if flat_pos.min() == flat_pos.max() else roc_auc(flat_pos, flat_scores)
    return {"roc_auc": auc, "precision_at_1": p_at_1, "num_queries": float(n_query)}


def eval_retrieval(embeddings: Any, labels: Any,
                   device: Optional[Union[str, torch.device]] = None) -> Dict[str, float]:
    """Same-set retrieval: each sample queries every other sample; the
    similarities are computed on ``device`` (``cuda`` unless named)."""
    labels = labels_to_indices(labels)
    sim = cosine_similarity(embeddings, embeddings, device).cpu().numpy()
    return _retrieval_metrics(sim, labels, labels, exclude_self=True)


def eval_retrieval_cross_set(query_embeddings: Any, query_labels: Any, db_embeddings: Any, db_labels: Any,
                             device: Optional[Union[str, torch.device]] = None) -> Dict[str, float]:
    """Cross-set retrieval, e.g. train queries against the test database, the
    similarities computed on ``device`` (``cuda`` unless named)."""
    sim = cosine_similarity(query_embeddings, db_embeddings, device).cpu().numpy()
    return _retrieval_metrics(sim, labels_to_indices(query_labels), labels_to_indices(db_labels),
                              exclude_self=False)
