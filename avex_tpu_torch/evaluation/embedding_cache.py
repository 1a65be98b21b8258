"""Embedding extraction and the HDF5 embedding cache.

Port of ``avex_tpu/evaluation/embedding_cache.py``, with the extraction loop
apart from the writer:

- :func:`extract_embeddings` runs batches through ``model.extract_embeddings``
  on the model's device and yields host arrays. On CUDA each batch's fp32
  copy to pinned host memory is queued behind its forward, and the loop
  hands batch n−1 out only once batch n is queued, so the host writes while
  the card computes;
- :func:`compute_embeddings` keeps every batch in memory;
- the HDF5 writer and readers import ``h5py`` where they are called, never
  at import. The file layout is the JAX package's, so each package reads the
  other's files: one dataset per layer ``embeddings_{i}`` (float32) and
  ``labels``, root attributes ``aggregation``, ``layer_names``,
  ``multi_layer``, ``num_samples`` and ``embedding_dims``, written to
  ``.h5.tmp`` and renamed; files are named
  ``{save_dir}/{dataset}_{model}/embedding_{split}_{layer_id}.h5``;
- under a mesh of several ranks (cell 5 of the JAX package's dry run)
  every rank reads the same batches and extracts its equal share of each
  batch's rows; the rows are gathered in the loader's order on the device
  and rank 0 writes the file. A batch whose rows do not divide among the
  ranks is computed whole on every rank, as JAX replicates it.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avex_tpu_torch.parallel import Mesh, all_gather_into, is_main_process, replicate

__all__ = [
    "HDF5EmbeddingDataset",
    "cache_path",
    "compute_embeddings",
    "embedding_cache_matches",
    "estimated_cache_bytes",
    "extract_embeddings",
    "extract_embeddings_to_cache",
    "layer_id_for",
    "load_cached_embeddings",
]

logger = logging.getLogger(__name__)


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError("the HDF5 embedding cache needs h5py; keep the embeddings in memory "
                          "(compute_embeddings) where h5py is missing") from err
    return h5py


def layer_id_for(layers: Sequence[Union[str, int]]) -> str:
    """Stable id naming a layer selection in cache filenames."""
    return "_".join(str(layer).replace(".", "-") for layer in layers) or "last_layer"


def cache_path(save_dir: str, dataset_name: str, model_name: str, split: str, layers) -> Path:
    """Cache file path following the reference naming scheme."""
    return Path(save_dir) / f"{dataset_name}_{model_name}" / f"embedding_{split}_{layer_id_for(layers)}.h5"


def embedding_cache_matches(path: Union[str, Path], aggregation: str, layer_names: Sequence[str]) -> bool:
    """True when an existing cache file was written for this aggregation and
    these layers."""
    path = Path(path)
    if not path.exists():
        return False
    h5py = _h5py()
    try:
        with h5py.File(path, "r") as f:
            if f.attrs.get("aggregation") != aggregation:
                return False
            stored = [str(n) for n in f.attrs.get("layer_names", [])]
            return stored == [str(n) for n in layer_names]
    except OSError:
        return False


def _to_host(value: Any, non_blocking: bool) -> Any:
    """A tensor's copy to host memory, queued when ``non_blocking``; other
    values as numpy arrays."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.to("cpu", non_blocking=non_blocking)
    return np.asarray(value)


def _rank_rows(value: Any, mesh: Mesh) -> Any:
    """This rank's equal share of a batch entry's rows."""
    if value is None:
        return None
    rows = value.shape[0] // mesh.size
    return value[mesh.rank * rows:(mesh.rank + 1) * rows]


def _gather_rows(emb: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``emb``, in rank order (no gradient)."""
    out = emb.new_empty((mesh.size * emb.shape[0],) + tuple(emb.shape[1:]))
    return all_gather_into(out, emb.contiguous(), mesh)


def extract_embeddings(
    model,
    loader: Iterable[Dict[str, Any]],
    aggregation: str = "none",
    layers: Optional[Sequence[Union[str, int]]] = None,
    mesh: Optional[Mesh] = None,
) -> Iterator[Tuple[List[np.ndarray], Optional[np.ndarray]]]:
    """Yield ``(per-layer float32 arrays, labels)`` for each batch of
    ``loader`` (``raw_wav``, optional ``padding_mask`` and ``label``).

    Batch n−1 is handed out once batch n's forward is queued; on CUDA the
    copies of its embeddings and labels to host memory were queued right
    behind its own forward, so the wait is for batch n−1 alone. Under a
    ``mesh`` of several ranks each rank extracts its share of a batch and
    every rank gets the whole batch's rows (see the module docstring).
    """
    if layers is not None:
        model.register_hooks_for_layers(list(layers))
    on_cuda = model.device.type == "cuda"
    split = mesh is not None and mesh.size > 1
    pending = None
    for batch in loader:
        wav, mask = batch["raw_wav"], batch.get("padding_mask")
        shared = split and wav.shape[0] % mesh.size == 0
        if shared:
            wav, mask = _rank_rows(wav, mesh), _rank_rows(mask, mesh)
        embs = model.extract_embeddings(wav, padding_mask=mask, aggregation=aggregation)
        embs = embs if isinstance(embs, list) else [embs]
        if shared:
            embs = [_gather_rows(e, mesh) for e in embs]
        host = [e.float().to("cpu", non_blocking=on_cuda) for e in embs]
        labels = _to_host(batch.get("label"), non_blocking=on_cuda)
        done = None
        if on_cuda:
            done = torch.cuda.Event()
            done.record()
        if pending is not None:
            yield _ready(pending)
        pending = (host, done, labels)
    if pending is not None:
        yield _ready(pending)


def _ready(pending) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    host, done, labels = pending
    if done is not None:
        done.synchronize()
    if isinstance(labels, torch.Tensor):
        labels = labels.numpy()
    return [h.numpy() for h in host], labels


def compute_embeddings(
    model,
    loader: Iterable[Dict[str, Any]],
    aggregation: str = "none",
    layers: Optional[Sequence[Union[str, int]]] = None,
) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """Every batch's embeddings in memory: (per-layer arrays, labels or None)."""
    parts, labels = [], []
    for embs, lab in extract_embeddings(model, loader, aggregation, layers):
        parts.append(embs)
        if lab is not None:
            labels.append(lab)
    per_layer = [np.concatenate([p[i] for p in parts]) for i in range(len(parts[0]))]
    return per_layer, np.concatenate(labels) if labels else None


def extract_embeddings_to_cache(
    model,
    loader: Iterable[Dict[str, Any]],
    path: Union[str, Path],
    aggregation: str = "none",
    layers: Optional[Sequence[Union[str, int]]] = None,
    mesh=None,
) -> Path:
    """Run the backbone over ``loader`` and stream its embeddings into HDF5
    (needs h5py); the host writes batch n−1 while the device computes batch n.

    ``mesh``: extract over its ranks, every rank from rank 0's weights:
    data-parallel over its data axis, and over a model axis as the model's
    layout runs it (the ring of ``embed``'s long windows); rank 0 writes the
    file and every rank returns once it is written."""
    path = Path(path)
    if layers is not None:
        model.register_hooks_for_layers(list(layers))
    layer_names = list(model._hook_layers)
    ranks = mesh is not None and mesh.distributed
    if ranks:
        replicate(model.module, mesh)
        if not is_main_process():
            for _ in extract_embeddings(model, loader, aggregation, mesh=mesh):
                pass
            _all_ranks_meet(mesh)  # rank 0 has written the file
            return path
    h5py = _h5py()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".h5.tmp")
    num_samples = 0
    with h5py.File(tmp, "w") as f:
        datasets: List[Any] = []
        labels_ds = None
        for embs, labels in extract_embeddings(model, loader, aggregation, mesh=mesh):
            if not datasets:
                for i, e in enumerate(embs):
                    datasets.append(f.create_dataset(
                        f"embeddings_{i}", shape=(0,) + e.shape[1:], maxshape=(None,) + e.shape[1:],
                        dtype="float32", chunks=(min(64, max(1, e.shape[0])),) + e.shape[1:],
                    ))
                if labels is not None:
                    labels_ds = f.create_dataset("labels", shape=(0,) + labels.shape[1:],
                                                 maxshape=(None,) + labels.shape[1:], dtype=labels.dtype)
            n = embs[0].shape[0]
            for ds, e in zip(datasets, embs):
                ds.resize(num_samples + n, axis=0)
                ds[num_samples:] = e
            if labels_ds is not None and labels is not None:
                labels_ds.resize(num_samples + n, axis=0)
                labels_ds[num_samples:] = labels
            num_samples += n
        f.attrs["aggregation"] = aggregation
        f.attrs["layer_names"] = [str(n) for n in layer_names]
        f.attrs["multi_layer"] = len(datasets) > 1
        f.attrs["num_samples"] = num_samples
        f.attrs["embedding_dims"] = [int(ds.shape[-1]) for ds in datasets]
    os.replace(tmp, path)
    logger.info("Cached %d samples x %d layer(s) to %s", num_samples, len(layer_names), path)
    if ranks:
        _all_ranks_meet(mesh)  # the other ranks wait for the file
    return path


def _all_ranks_meet(mesh: Mesh) -> None:
    """Every process of the run waits here for all the others (one small
    all-reduce over the default group, on the mesh's device)."""
    import torch.distributed as dist

    dist.all_reduce(torch.zeros(1, device=mesh.device))


def load_cached_embeddings(path: Union[str, Path]) -> Tuple[List[np.ndarray], Optional[np.ndarray], Dict]:
    """A cache file in memory: (per-layer arrays, labels, metadata)."""
    with _h5py().File(path, "r") as f:
        metadata = dict(f.attrs)
        embs = []
        while f"embeddings_{len(embs)}" in f:
            embs.append(np.asarray(f[f"embeddings_{len(embs)}"]))
        labels = np.asarray(f["labels"]) if "labels" in f else None
    return embs, labels, metadata


def estimated_cache_bytes(path: Union[str, Path]) -> int:
    """Uncompressed size of a cache file's datasets."""
    total = 0
    with _h5py().File(path, "r") as f:
        for key in f:
            ds = f[key]
            total += int(np.prod(ds.shape)) * ds.dtype.itemsize
    return total


class HDF5EmbeddingDataset:
    """Lazy map-style view over a cache file; pickles without its open handle."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = str(path)
        self._file = None
        with _h5py().File(self.path, "r") as f:
            self.num_samples = int(f.attrs["num_samples"])
            self.num_layers = sum(1 for k in f if k.startswith("embeddings_"))
            self.has_labels = "labels" in f
            self.metadata = dict(f.attrs)

    def _ensure_open(self):
        if self._file is None:
            self._file = _h5py().File(self.path, "r")
        return self._file

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        f = self._ensure_open()
        item = {f"embeddings_{i}": np.asarray(f[f"embeddings_{i}"][idx]) for i in range(self.num_layers)}
        if self.has_labels:
            item["label"] = np.asarray(f["labels"][idx])
        return item

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_file"] = None
        return state
