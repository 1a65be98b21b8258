"""EmbeddingDataSource: compute-or-load access to embeddings.

Port of ``avex_tpu/evaluation/embedding_manager.py``: one object that gives
an embedding dataset for a split, extracting through the model when no
valid cache exists (or when asked to overwrite), and loading the cache
fully into memory or streaming it lazily from HDF5 depending on its size
against a memory limit. The cache needs h5py (imported where it is used).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from avex_tpu_torch.evaluation.embedding_cache import (
    HDF5EmbeddingDataset,
    _h5py,
    embedding_cache_matches,
    estimated_cache_bytes,
    extract_embeddings_to_cache,
    load_cached_embeddings,
)

__all__ = ["EmbeddingDataSource", "InMemoryEmbeddingDataset"]

logger = logging.getLogger(__name__)


class InMemoryEmbeddingDataset:
    """A map-style dataset over per-layer embedding arrays held in memory."""

    def __init__(self, embeddings: List[np.ndarray], labels: Optional[np.ndarray]) -> None:
        self.embeddings = embeddings
        self.labels = labels
        self.num_layers = len(embeddings)

    def __len__(self) -> int:
        return self.embeddings[0].shape[0]

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        item = {f"embeddings_{i}": e[idx] for i, e in enumerate(self.embeddings)}
        if self.labels is not None:
            item["label"] = self.labels[idx]
        return item


class EmbeddingDataSource:
    """Compute-or-load embeddings with a memory-bounded loading strategy."""

    def __init__(
        self,
        model,
        cache_path: Union[str, Path],
        layers: Sequence[Union[str, int]],
        aggregation: str = "none",
        memory_limit_bytes: int = 8 << 30,
        overwrite: bool = False,
        mesh=None,
    ) -> None:
        self.model = model
        self.cache_path = Path(cache_path)
        self.layers = list(layers)
        self.aggregation = aggregation
        self.memory_limit_bytes = memory_limit_bytes
        self.overwrite = overwrite
        self.mesh = mesh

    def get_dataset(self, loader) -> Any:
        """An embedding dataset for the split fed by ``loader``: the cache is
        reused when its stored aggregation and layers match, and loaded in
        memory when its size is within ``memory_limit_bytes``."""
        layer_names = self.model.register_hooks_for_layers(self.layers)
        if self.overwrite or not embedding_cache_matches(self.cache_path, self.aggregation, layer_names):
            extract_embeddings_to_cache(self.model, loader, self.cache_path, aggregation=self.aggregation,
                                        layers=self.layers, mesh=self.mesh)
        else:
            logger.info("Reusing embedding cache %s", self.cache_path)
        size = estimated_cache_bytes(self.cache_path)
        if size <= self.memory_limit_bytes:
            embeddings, labels, _meta = load_cached_embeddings(self.cache_path)
            logger.info("Loaded %s in memory (%.1f MB)", self.cache_path, size / 1e6)
            return InMemoryEmbeddingDataset(embeddings, labels)
        logger.info("Streaming %s lazily (%.1f MB > limit %.1f MB)", self.cache_path, size / 1e6,
                    self.memory_limit_bytes / 1e6)
        return HDF5EmbeddingDataset(self.cache_path)

    def embedding_dims(self) -> List[int]:
        """Per-layer feature widths from the cache's metadata."""
        with _h5py().File(self.cache_path, "r") as f:
            return [int(d) for d in f.attrs.get("embedding_dims", [])]
