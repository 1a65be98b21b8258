"""Evaluation harness: embedding cache, probe training, retrieval, clustering.

h5py and scikit-learn are imported by the functions that need them, never
here.
"""

from avex_tpu_torch.evaluation.clustering import eval_clustering, eval_clustering_multi_k
from avex_tpu_torch.evaluation.embedding_cache import (
    HDF5EmbeddingDataset,
    cache_path,
    compute_embeddings,
    embedding_cache_matches,
    estimated_cache_bytes,
    extract_embeddings,
    extract_embeddings_to_cache,
    load_cached_embeddings,
)
from avex_tpu_torch.evaluation.embedding_manager import EmbeddingDataSource, InMemoryEmbeddingDataset
from avex_tpu_torch.evaluation.finetune import FineTuneTrainer, train_and_eval_offline, train_and_eval_online
from avex_tpu_torch.evaluation.retrieval import eval_retrieval, eval_retrieval_cross_set

__all__ = [
    "EmbeddingDataSource",
    "FineTuneTrainer",
    "HDF5EmbeddingDataset",
    "InMemoryEmbeddingDataset",
    "cache_path",
    "compute_embeddings",
    "embedding_cache_matches",
    "estimated_cache_bytes",
    "eval_clustering",
    "eval_clustering_multi_k",
    "eval_retrieval",
    "eval_retrieval_cross_set",
    "extract_embeddings",
    "extract_embeddings_to_cache",
    "load_cached_embeddings",
    "train_and_eval_offline",
    "train_and_eval_online",
]
